#!/usr/bin/env python3
"""One whole flagship training run on one NVIDIA GPU, held to the JAX
package's record of the same run (`runs/ab6_conf_phash111`).

    python3 scripts/converge_torch.py --seed 0     # from the repository root, ~10 min

Three steps:
  1. the bench scene (`bench.py`'s: sequence 9000, 51 frames of 66x1030,
     scene seed 0) is written with the port's generator into `--scene`
     unless it is there, and its scale is held to the config's;
  2. the training CLI runs in a fresh process on `configs/bench_conf_phash111.txt`,
     unedited, overriding only --workspace, --path, --dataloader and --seed:
     2,500 iterations (61 epochs of 41 steps), evaluations at epochs 27 and
     54, the 1,000-step U-Net refine, the final evaluation and the test. The
     child process calls `lidar4d_tpu_torch.cli.main_lidar4d.main` with the
     trainer's stages (flow cache, epochs, evaluations, refine, test) timed
     and their kernel launches counted;
  3. `args.txt`, `log_lidar4d.txt` and `metrics_lidar4d.jsonl` are copied
     into `--out` (default `runs/torch_conf_phash111_s<seed>`), with
     `converge.json` (wall time and launches by stage, the card, the band's
     verdict), and tables of every evaluation, the per-epoch loss and the
     refine BCE are printed beside the JAX record's.

Exits 1 when an evaluation misses the quality band (BAND), 2 when the run
itself fails or misses the JAX record's schedule. Arguments after `--` go to
the CLI as well (`-- --train_only`: the epochs and their evaluations alone).
`--float32-mlps` and `--plain-kernels` run the same schedule with the
field's MLPs in float32 or every kernel's plain PyTorch version in its
place: witnesses of whether the bfloat16 MLPs or the kernels move a seed's
quality.
`--report RECORD` prints a record directory's tables and checks again.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SCENE  # noqa: E402  bench.py:71-92's scene (fov_lidar at its default)

CONFIG = "configs/bench_conf_phash111.txt"
JAX_RECORD = ROOT / "runs" / "ab6_conf_phash111"
SCALE_RTOL = 1e-6
N_PARAMS = 8_971_809                       # runs/ab6_conf_phash111/log_lidar4d.txt:2
REFINE_STEPS = 1000
# the quality band, about three times the JAX runs' CD noise (+-0.006) from
# the JAX record: epoch -> [(name, bound, "max" or "min")]
BAND = {
    54: [("CD", 0.181, "max"), ("F", 0.873, "min")],
    61: [("CD", 0.189, "max"), ("F", 0.878, "min"), ("depth RMSE", 3.08, "max"),
         ("raydrop Acc", 0.975, "min")],
}
# eval table columns: (name, metrics key, index)
COLUMNS = (
    ("CD", "PointsMeter", 0), ("F", "PointsMeter", 1),
    ("depth RMSE", "depth", 0), ("depth MedAE", "depth", 1), ("depth LPIPS", "depth", 2),
    ("raydrop RMSE", "RaydropMeter", 0), ("raydrop Acc", "RaydropMeter", 1),
    ("raydrop F1", "RaydropMeter", 2),
    ("intensity RMSE", "intensity", 0), ("intensity PSNR", "intensity", 4),
    ("intensity LPIPS", "intensity", 2),
)
RECORD_FILES = ("args.txt", "log_lidar4d.txt", "metrics_lidar4d.jsonl")


# ----------------------------------------------------------------- the scene
def config_values(path=ROOT / CONFIG):
    from lidar4d_tpu_torch.cli.config import _parse_config_txt

    return _parse_config_txt(path)


def write_scene(root, scene=None, want_scale=None):
    """The bench scene under `root`, written unless its meta.json is there;
    returns (scale, offset, seconds spent writing). The scale must be
    `want_scale` (the config's) to SCALE_RTOL."""
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence

    scene = dict(SCENE if scene is None else scene)
    meta = Path(root) / "meta.json"
    t0 = time.perf_counter()
    if meta.exists():
        m = json.loads(meta.read_text())
    else:
        scale, offset = generate_synthetic_sequence(str(root), **scene)
        m = {"scale": scale, "offset": offset, "scene": scene}
        meta.write_text(json.dumps(m))
    seconds = time.perf_counter() - t0
    if want_scale is None:
        want_scale = float(config_values()["scale"])
    if abs(m["scale"] - want_scale) > SCALE_RTOL * abs(want_scale):
        raise ValueError(f"scene scale {m['scale']!r} != config scale {want_scale!r} "
                         f"(relative tolerance {SCALE_RTOL})")
    return m["scale"], m["offset"], seconds


# ------------------------------------------------------------------- records
def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def epoch_losses(records):
    return {r["epoch"]: r["loss"] for r in records if "rays_per_sec" in r}


def eval_rows(records):
    """epoch -> the evaluation record of that epoch."""
    return {r["epoch"]: r for r in records if "valid_loss" in r}


def read_log(path):
    """(parameter count or None, [(refine iteration, BCE)]) from a trainer log."""
    n_params, bce = None, []
    with open(path) as f:
        for line in f:
            if line.startswith("[INFO] #parameters:"):
                n_params = int(line.split(":")[1])
            elif line.startswith("refine iter "):
                head, value = line.split(": raydrop bce ")
                bce.append((int(head.split()[2]), float(value)))
    return n_params, bce


def metric(record, key, idx):
    return float(record[key][idx])


def eval_table(port, jax):
    """Rows (epoch, column, port value, JAX value or None) for every port
    evaluation."""
    rows = []
    for epoch in sorted(port):
        for name, key, idx in COLUMNS:
            want = metric(jax[epoch], key, idx) if epoch in jax else None
            rows.append((epoch, name, metric(port[epoch], key, idx), want))
    return rows


def band_failures(port):
    """The band's misses, as strings; an evaluation the band needs and the
    run lacks is a miss too."""
    fails = []
    cols = {name: (key, idx) for name, key, idx in COLUMNS}
    for epoch, checks in BAND.items():
        if epoch not in port:
            fails.append(f"no evaluation at epoch {epoch}")
            continue
        for name, bound, kind in checks:
            got = metric(port[epoch], *cols[name])
            if not (got <= bound if kind == "max" else got >= bound):
                fails.append(f"epoch {epoch} {name} {got:.6g} "
                             f"{'>' if kind == 'max' else '<'} {bound}")
    return fails


def trailing_mean(values, n=5):
    return [sum(values[max(0, i - n + 1):i + 1]) / len(values[max(0, i - n + 1):i + 1])
            for i in range(len(values))]


def format_tables(port_records, jax_records, port_bce, jax_bce):
    """The comparison as printable lines: evaluations, per-epoch loss (with
    5-epoch trailing means) and the refine BCE every 50 iterations."""
    port_eval, jax_eval = eval_rows(port_records), eval_rows(jax_records)
    lines = ["evaluations, port against the JAX record (runs/ab6_conf_phash111; LPIPS is the "
             "numpy-seeded surrogate of eval/lpips.py in both, UNCALIBRATED):",
             f"  {'epoch':>5} {'metric':<16} {'port':>12} {'JAX':>12} {'port - JAX':>12}"]
    for epoch, name, got, want in eval_table(port_eval, jax_eval):
        diff = "" if want is None else f"{got - want:+12.5f}"
        want_s = "-" if want is None else f"{want:12.5f}"
        lines.append(f"  {epoch:>5} {name:<16} {got:12.5f} {want_s:>12} {diff}")

    port_loss, jax_loss = epoch_losses(port_records), epoch_losses(jax_records)
    epochs = sorted(port_loss)
    pm = trailing_mean([port_loss[e] for e in epochs])
    jm = trailing_mean([jax_loss.get(e, float("nan")) for e in epochs])
    lines += ["train loss by epoch (the epoch's last step), port against JAX, and their "
              "5-epoch trailing means:",
              f"  {'epoch':>5} {'port':>10} {'JAX':>10} {'port mean':>10} {'JAX mean':>10}"]
    for e, a, b in zip(epochs, pm, jm):
        lines.append(f"  {e:>5} {port_loss[e]:10.4f} {jax_loss.get(e, float('nan')):10.4f} "
                     f"{a:10.4f} {b:10.4f}")

    jb = dict(jax_bce)
    lines += ["refine BCE every 50 iterations, port against JAX (log_lidar4d.txt:88-107):",
              f"  {'iter':>5} {'port':>10} {'JAX':>10}"]
    for it, v in port_bce:
        lines.append(f"  {it:>5} {v:10.6f} {jb.get(it, float('nan')):10.6f}")
    return lines


def check_record(record):
    """(checks of the schedule, the band's misses) of a run's record
    directory: the JAX record's parameter count, 61 epochs, evaluations at
    27, 54 and 61, 1,000 refine steps logged every 50."""
    records = read_jsonl(Path(record) / "metrics_lidar4d.jsonl")
    n_params, bce = read_log(Path(record) / "log_lidar4d.txt")
    checks = {
        "parameters": n_params == N_PARAMS,
        "epochs": sorted(epoch_losses(records)) == list(range(1, 62)),
        "evaluations": sorted(eval_rows(records)) == [27, 54, 61],
        "refine steps": [it for it, _ in bce] == list(range(0, REFINE_STEPS, 50)),
    }
    return checks, band_failures(eval_rows(records))


def report(record, jax_record=JAX_RECORD):
    """Print the tables of a record directory against the JAX record, its
    parameter count, checks and band; returns check_record(record)."""
    records = read_jsonl(Path(record) / "metrics_lidar4d.jsonl")
    n_params, bce = read_log(Path(record) / "log_lidar4d.txt")
    _, jax_bce = read_log(Path(jax_record) / "log_lidar4d.txt")
    for line in format_tables(records, read_jsonl(Path(jax_record) / "metrics_lidar4d.jsonl"),
                              bce, jax_bce):
        print(line)
    checks, fails = check_record(record)
    print(f"parameters: {n_params} (JAX record {N_PARAMS}); checks: {json.dumps(checks)}")
    print("band: " + ("met" if not fails else "MISSED: " + "; ".join(fails)), flush=True)
    return checks, fails


# --------------------------------------------------------- the child process
def run_child(out_json, cli_argv, float32_mlps=False, plain=False):
    """The training CLI in this process under chip_smoke's TrainerProbe
    (each stage timed, its kernel launches counted); writes them to
    `out_json`. `float32_mlps` runs the field's MLPs in float32, `plain`
    swaps every kernel wrapper for its plain PyTorch version on the card."""
    import torch

    import chip_smoke
    from lidar4d_tpu_torch.cli import main_lidar4d
    from lidar4d_tpu_torch.ops import _cuda

    probe = chip_smoke.TrainerProbe()
    with contextlib.ExitStack() as stack:
        stack.enter_context(probe.installed())
        if float32_mlps:
            stack.enter_context(chip_smoke.mlp_dtype(torch.float32))
        if plain:
            stack.enter_context(chip_smoke.plain_kernels())
        t0 = time.perf_counter()
        main_lidar4d.main(cli_argv)
        main_seconds = time.perf_counter() - t0
    Path(out_json).write_text(json.dumps({
        "main_seconds": main_seconds, "refine_unet": probe.refine_unet,
        "stages": [{"stage": n, "seconds": s, "launches": k} for n, s, k in probe.stages],
        "launches": dict(_cuda.LAUNCHES), "device": torch.cuda.get_device_name(0)}))


def name_evaluations(stages, epochs):
    """The probe's "evaluate" stages, in order, named after the epochs of the
    record's evaluations ("evaluate 27", ...)."""
    epochs = iter(sorted(epochs))
    return [dict(s, stage=f"evaluate {next(epochs)}") if s["stage"] == "evaluate" else s
            for s in stages]


def summarize_stages(stages):
    """{part: seconds}: flow cache, epochs (summed), each evaluation, refine
    (of it the U-Net steps), test."""
    parts = {}
    for s in stages:
        name = s["stage"]
        parts[name] = parts.get(name, 0.0) + s["seconds"]
    parts["epochs"] = parts.pop("epoch", 0.0)
    return parts


def sum_launches(stages, names):
    total = {}
    for s in stages:
        if s["stage"] in names:
            for k, v in s["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def card():
    """nvidia-smi's `name, power.limit` line, or the reason there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ----------------------------------------------------------------------- main
def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", default="data/bench_synth_torch",
                   help="the bench scene's directory (written if missing)")
    p.add_argument("--out", default=None,
                   help="record directory (default runs/torch_conf_phash111_s<seed>)")
    p.add_argument("--report", default=None, metavar="RECORD",
                   help="only print a record directory's tables against the JAX record")
    p.add_argument("--float32-mlps", action="store_true",
                   help="run the field's MLPs in float32 (the port's own are bfloat16)")
    p.add_argument("--plain-kernels", action="store_true",
                   help="run every kernel's plain PyTorch version in its place")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        run_child(args.child, extra, args.float32_mlps, args.plain_kernels)
        return 0
    if args.report:
        checks, fails = report(args.report)
        return 2 if not all(checks.values()) else 1 if fails else 0

    os.chdir(ROOT)
    out = Path(args.out or f"runs/torch_conf_phash111_s{args.seed}")
    card_line = card()
    print(f"card: {card_line}", flush=True)

    scale, _, t_scene = write_scene(args.scene)
    print(f"scene {SCENE} in {args.scene}: scale {scale!r} ({t_scene:.1f} s)", flush=True)

    from lidar4d_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()[0]
    t_build = time.perf_counter() - t0
    print(f"kernels {built} in {t_build:.1f} s", flush=True)

    ws = Path(tempfile.mkdtemp(prefix="converge_ws_"))
    stages_json = ws / "converge_stages.json"
    cli_argv = ["--config", CONFIG, "--dataloader", "synthetic", "--path", args.scene,
                "--workspace", str(ws), "--seed", str(args.seed), *extra]
    print("CLI: python -m lidar4d_tpu_torch.cli.main_lidar4d " + " ".join(cli_argv), flush=True)
    t0 = time.perf_counter()
    variant = [f for f, on in (("--float32-mlps", args.float32_mlps),
                               ("--plain-kernels", args.plain_kernels)) if on]
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *variant,
                           "--child", str(stages_json), "--", *cli_argv], cwd=ROOT)
    t_process = time.perf_counter() - t0
    if proc.returncode != 0:
        print(f"the training CLI failed: exit code {proc.returncode}", flush=True)
        return 2

    out.mkdir(parents=True, exist_ok=True)
    for name in RECORD_FILES:
        shutil.copy(ws / name, out / name)
    child = json.loads(stages_json.read_text())
    shutil.rmtree(ws, ignore_errors=True)

    checks, fails = report(out)
    stages = name_evaluations(child["stages"],
                              eval_rows(read_jsonl(out / "metrics_lidar4d.jsonl")))
    parts = summarize_stages(stages)
    if child["refine_unet"]:
        parts["refine: U-Net steps"] = child["refine_unet"]["seconds"]
    train_launches = sum_launches(stages, {"epoch"})
    print("wall time by part (s): " + json.dumps(
        {"scene": t_scene, "kernel build": t_build, "CLI process": t_process,
         "CLI main": child["main_seconds"], **parts}))
    print("kernel launches over the run: " + json.dumps(child["launches"]))
    print("kernel launches by stage: " + json.dumps(
        {"epochs": train_launches,
         **{s["stage"]: s["launches"] for s in stages if s["stage"] != "epoch"}}))
    summary = {
        "seed": args.seed, "config": CONFIG, "card": card_line, "device": child["device"],
        "float32_mlps": args.float32_mlps, "plain_kernels": args.plain_kernels,
        "refine_unet": child["refine_unet"], "checks": checks, "band_failures": fails,
        "seconds": {"scene": t_scene, "kernel build": t_build, "CLI process": t_process,
                    "CLI main": child["main_seconds"], **parts},
        "stages": stages, "launches": child["launches"],
        "launches_train_epochs": train_launches, "cli_argv": cli_argv,
    }
    (out / "converge.json").write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({k: summary[k] for k in ("seed", "card", "checks", "band_failures")}))
    if not all(checks.values()):
        return 2
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
