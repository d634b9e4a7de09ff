#!/usr/bin/env python3
"""Whole flagship training runs on one NVIDIA GPU, held to the JAX
package's committed records of the same runs (RECORDS: `runs/ab6_*`,
`runs/flagship10k_*`).

    python3 scripts/converge_torch.py --seed 0                 # conf_phash111, ~10 min
    python3 scripts/converge_torch.py --record flagship10k_phash --seeds 1,2,3 -- --train_only
    python3 scripts/converge_torch.py --report-pooled          # the reading, on the CPU

Three steps:
  1. the bench scene (`bench.py`'s: sequence 9000, 51 frames of 66x1030,
     scene seed 0) is written with the port's generator into `--scene`
     unless it is there, and its scale is held to the config's;
  2. the training CLI runs in a fresh process on the record's config,
     unedited, overriding only --workspace, --path, --dataloader and --seed
     (conf_phash111: 2,500 iterations, 61 epochs of 41 steps, evaluations at
     epochs 27 and 54, the 1,000-step U-Net refine, the final evaluation and
     the test). The child process calls
     `lidar4d_tpu_torch.cli.main_lidar4d.main` with the trainer's stages
     (flow cache, epochs, evaluations, refine, test) timed and their kernel
     launches counted. Every POLL_S seconds the workspace's record files are
     copied into the record directory, so that a run cut short keeps its
     evaluations; under `--examine` a copy of the checkpoint the trainer
     writes after the record's first evaluation is kept too
     (`kept/lidar4d_epEEEE_best` in the workspace);
  3. `args.txt`, `log_lidar4d.txt` and `metrics_lidar4d.jsonl` are copied
     into the record directory (`<--runs-dir>/torch_<record>_s<seed>`, with
     a `tpu_` infix under `--tpu-numerics`), with `converge.json` (wall time
     and launches by stage, the card, the checks, the band's verdict where
     the record has a band), and tables of every evaluation, the per-epoch
     loss and the refine BCE are printed beside the JAX record's.

Exits 1 when an evaluation misses the quality band (BAND, conf_phash111
only), 2 when the run itself fails or misses the JAX record's schedule.
`--examine` then runs scripts/diag_floaters_torch.py on the kept checkpoint
(`diag_summary_epE.json` in the record directory) and the simulation CLI on
the run's workspace.
Arguments after `--` go to the CLI as well (`-- --train_only`: the epochs
and their evaluations alone). `--seeds 1,2,3` runs one process a seed at
once on the card, each with its own scene directory and its output in its
record's `log_converge.txt`. `--float32-mlps`, `--plain-kernels` and
`--tpu-numerics` run the same schedule with the field's MLPs in float32,
every kernel's plain PyTorch version, or every training-path kernel's
bfloat16 twin (the TPU kernels' numerics, chip_smoke.tpu_numerics) in its
place: witnesses, never the main path.
`--finite-probe` checks every train step before its update and, at the
first non-finite one, dumps and replays it into the workspace and stops
(`finite_probe`).
`--report RECORD_DIR` prints a record directory's tables and checks again;
`--report-pooled` reads every `runs/torch_*` record and prints the pooled
reading against the JAX records (`pooled_reading`).
"""

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as pytree_leaves  # noqa: E402

from chip_smoke import SCENE  # noqa: E402  bench.py:71-92's scene (fov_lidar at its default)

SCALE_RTOL = 1e-6
REFINE_STEPS = 1000
POLL_S = 20.0
# the quality band of conf_phash111, about three times the JAX runs' CD noise
# (+-0.006) from the JAX record: epoch -> [(name, bound, "max" or "min")]
BAND = {
    54: [("CD", 0.181, "max"), ("F", 0.873, "min")],
    61: [("CD", 0.189, "max"), ("F", 0.878, "min"), ("depth RMSE", 3.08, "max"),
         ("raydrop Acc", 0.975, "min")],
}


class Record(NamedTuple):
    """A JAX record and its run: the config, the record's directory under
    runs/, its parameter count (its log_lidar4d.txt:2), the evaluation epochs
    before the refine, the train epochs, the epoch the evaluation after the
    refine carries, and the quality band (conf_phash111's alone)."""
    config: str
    jax: str
    n_params: int
    evals: tuple
    epochs: int
    final: int
    band: Optional[dict] = None

    @property
    def endpoint(self):
        """The primary endpoint: the last evaluation before any refine."""
        return self.evals[-1]


RECORDS = {
    "flagship_phash211": Record("configs/bench_ab_flagship_ep14_phash211.txt",
                                "ab6_flagship_phash211", 8_627_745, (14,), 14, 14),
    "conf_phash111": Record("configs/bench_conf_phash111.txt", "ab6_conf_phash111",
                            8_971_809, (27, 54), 61, 61, BAND),
    "conf_phash112": Record("configs/bench_conf_phash112.txt", "ab6_conf_phash112",
                            9_020_961, (27, 54), 61, 61),
    "flagship10k_phash": Record("configs/bench_flagship_10k_phash.txt", "flagship10k_phash",
                                8_971_809, (54, 108, 162, 216), 244, 244),
    "flagship10k_urf": Record("configs/bench_flagship_10k_urf.txt", "flagship10k_urf",
                              10_495_521, (54, 108, 162, 216), 244, 244),
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
STEPS_PER_EPOCH = 41                     # the bench scene's train frames
KERNELS = ("hash_grid_fwd", "hash_grid_bwd", "plane_bilinear_fwd", "plane_bilinear_bwd",
           "plane_linear_fwd", "plane_linear_bwd", "plane_bilinear_vjp")


def jax_dir(rec):
    return ROOT / "runs" / rec.jax


# ----------------------------------------------------------------- the scene
def config_values(path):
    from lidar4d_tpu_torch.cli.config import _parse_config_txt

    return _parse_config_txt(path)


def write_scene(root, want_scale, scene=None):
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
    """epoch -> the evaluation record of that epoch (the last, where two
    evaluations carry one epoch)."""
    return {r["epoch"]: r for r in records if "valid_loss" in r}


def eval_points(records):
    """[(label, evaluation record)] in the run's order; the label is the
    epoch, with an "r" added where an earlier evaluation carries the same
    epoch (flagship_phash211's evaluation after the refine, at epoch 14)."""
    out, seen = [], set()
    for r in records:
        if "valid_loss" in r:
            label = str(r["epoch"]) + ("r" if r["epoch"] in seen else "")
            seen.add(r["epoch"])
            out.append((label, r))
    return out


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
    """Rows (label, column, port value, JAX value or None) for every port
    evaluation; port and jax map labels (or epochs) to evaluation records."""
    rows = []
    for label in port:
        for name, key, idx in COLUMNS:
            want = metric(jax[label], key, idx) if label in jax else None
            rows.append((label, name, metric(port[label], key, idx), want))
    return rows


def band_failures(port, band):
    """The band's misses, as strings; an evaluation the band needs and the
    run lacks is a miss too."""
    fails = []
    cols = {name: (key, idx) for name, key, idx in COLUMNS}
    for epoch, checks in band.items():
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


def format_tables(port_records, jax_records, port_bce, jax_bce, rec):
    """The comparison as printable lines: evaluations, per-epoch loss (with
    5-epoch trailing means) and the refine BCE every 50 iterations."""
    port_eval, jax_eval = dict(eval_points(port_records)), dict(eval_points(jax_records))
    lines = [f"evaluations, port against the JAX record (runs/{rec.jax}; LPIPS is the "
             "numpy-seeded surrogate of eval/lpips.py in both, UNCALIBRATED):",
             f"  {'epoch':>5} {'metric':<16} {'port':>12} {'JAX':>12} {'port - JAX':>12}"]
    for label, name, got, want in eval_table(port_eval, jax_eval):
        diff = "" if want is None else f"{got - want:+12.5f}"
        want_s = "-" if want is None else f"{want:12.5f}"
        lines.append(f"  {label:>5} {name:<16} {got:12.5f} {want_s:>12} {diff}")

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
    lines += [f"refine BCE every 50 iterations, port against JAX (runs/{rec.jax}/"
              "log_lidar4d.txt):", f"  {'iter':>5} {'port':>10} {'JAX':>10}"]
    for it, v in port_bce:
        lines.append(f"  {it:>5} {v:10.6f} {jb.get(it, float('nan')):10.6f}")
    return lines


def check_record(record, rec, train_only=False):
    """(checks of the schedule, the band's misses) of a run's record
    directory: the JAX record's parameter count, every epoch, the
    evaluations in order (before the refine, and the one after it), 1,000
    refine steps logged every 50. `train_only`: the evaluations before the
    refine and no refine."""
    records = read_jsonl(Path(record) / "metrics_lidar4d.jsonl")
    n_params, bce = read_log(Path(record) / "log_lidar4d.txt")
    evals = list(rec.evals) + ([] if train_only else [rec.final])
    checks = {
        "parameters": n_params == rec.n_params,
        "epochs": sorted(epoch_losses(records)) == list(range(1, rec.epochs + 1)),
        "evaluations": [r["epoch"] for _, r in eval_points(records)] == evals,
        "refine steps": [it for it, _ in bce] == (
            [] if train_only else list(range(0, REFINE_STEPS, 50))),
    }
    band = {e: c for e, c in (rec.band or {}).items() if e in evals}
    return checks, band_failures(eval_rows(records), band)


def report(record, rec, train_only=False):
    """Print the tables of a record directory against the JAX record, its
    parameter count, checks and band; returns check_record(record, rec)."""
    jax_record = jax_dir(rec)
    records = read_jsonl(Path(record) / "metrics_lidar4d.jsonl")
    n_params, bce = read_log(Path(record) / "log_lidar4d.txt")
    _, jax_bce = read_log(Path(jax_record) / "log_lidar4d.txt")
    for line in format_tables(records, read_jsonl(Path(jax_record) / "metrics_lidar4d.jsonl"),
                              bce, jax_bce, rec):
        print(line)
    checks, fails = check_record(record, rec, train_only)
    print(f"parameters: {n_params} (JAX record {rec.n_params}); checks: {json.dumps(checks)}")
    if rec.band:
        print("band: " + ("met" if not fails else "MISSED: " + "; ".join(fails)), flush=True)
    return checks, fails


# ------------------------------------------------------------ pooled reading
def mean_sd(values):
    n = len(values)
    m = sum(values) / n
    sd = math.sqrt(sum((v - m) ** 2 for v in values) / (n - 1)) if n > 1 else float("nan")
    return m, sd


def record_z(port, jax, sign=1.0):
    """(d, s, z) of one record: d = mean(port) - jax, s the port values'
    standard deviation, z = sign * d / (s * sqrt(1 + 1/n))."""
    n = len(port)
    m, s = mean_sd(port)
    d = m - jax
    return d, s, sign * d / (s * math.sqrt(1.0 + 1.0 / n))


def pooled_z(zs):
    """Z = sum(z_r) / sqrt(number of records)."""
    return sum(zs) / math.sqrt(len(zs))


def detectable_bias(spreads):
    """The smallest bias b shared by every record that gives Z = 2:
    b = 2 sqrt(K) / sum_r 1 / (s_r sqrt(1 + 1/n_r)); spreads: [(s_r, n_r)]."""
    return 2.0 * math.sqrt(len(spreads)) / sum(1.0 / (s * math.sqrt(1.0 + 1.0 / n))
                                               for s, n in spreads)


def witness_delta(twins, exact):
    """(mean(twins) - mean(exact), its standard error)."""
    mt, st = mean_sd(twins)
    me, se = mean_sd(exact)
    return mt - me, math.sqrt(st ** 2 / len(twins) + se ** 2 / len(exact))


def run_variant(summary):
    """"exact", "tpu", "float32", "plain" of a converge.json."""
    if summary.get("tpu_numerics"):
        return "tpu"
    if summary.get("float32_mlps"):
        return "float32"
    if summary.get("plain_kernels"):
        return "plain"
    return "exact"


def collect_runs(runs_dir=ROOT / "runs"):
    """{(record, variant): {seed: (directory, [(label, evaluation)])}} of every
    port record with a converge.json under runs_dir, one run a seed: failed
    runs and reruns (`_again`) are left out, a run that a call's time limit
    cut keeps the evaluations it reached, and a `--train_only` run is taken
    before a whole run of its seed (as phash111's first six seeds counted
    seed 2)."""
    runs = {}
    for d in sorted(Path(runs_dir).glob("torch_*")):
        summary_path = d / "converge.json"
        if d.name.endswith("_again") or not summary_path.exists():
            continue
        summary = json.loads(summary_path.read_text())
        if summary.get("failed"):
            continue
        key = (summary["record"], run_variant(summary))
        train_only = "--train_only" in summary.get("cli_argv", [])
        seed = summary["seed"]
        have = runs.setdefault(key, {})
        if seed in have and not train_only:
            continue
        have[seed] = (d, eval_points(read_jsonl(d / "metrics_lidar4d.jsonl")))
    return runs


def endpoint_values(runs, rec, col):
    """{seed: value of column `col` at the record's endpoint} of the runs
    that reached it."""
    name, key, idx = next(c for c in COLUMNS if c[0] == col)
    out = {}
    for seed, (_, points) in sorted(runs.items()):
        pre = [r for label, r in points if not label.endswith("r")]
        hit = [r for r in pre if r["epoch"] == rec.endpoint]
        if hit:
            out[seed] = metric(hit[0], key, idx)
    return out


def jax_endpoint(rec, col):
    name, key, idx = next(c for c in COLUMNS if c[0] == col)
    points = eval_points(read_jsonl(jax_dir(rec) / "metrics_lidar4d.jsonl"))
    return metric(next(r for label, r in points if r["epoch"] == rec.endpoint), key, idx)


def pooled_reading(runs):
    """The reading fixed in PERF.md before the runs, as printable lines and a dict:
    per record d, s, z of the exact float32 port seeds' endpoint CD (and F,
    sign reversed), the pooled Z of each, the count of positive d, the
    smallest detectable CD bias, and the numerics witness (bfloat16 twins
    against exact float32) where both exist."""
    lines, out = [], {"records": {}}
    zs = {"CD": [], "F": []}
    spreads, positive = [], 0
    for name, rec in RECORDS.items():
        exact = runs.get((name, "exact"), {})
        cd = endpoint_values(exact, rec, "CD")
        f = endpoint_values(exact, rec, "F")
        if len(cd) < 2:
            lines.append(f"{name}: {len(cd)} exact port seed(s) at epoch {rec.endpoint}; "
                         "not in the pooled statistic")
            continue
        row = {"epoch": rec.endpoint, "seeds": sorted(cd), "n": len(cd)}
        for col, values, sign in (("CD", cd, 1.0), ("F", f, -1.0)):
            jax = jax_endpoint(rec, col)
            d, s, z = record_z(list(values.values()), jax, sign)
            row[col] = {"port": values, "port_mean": mean_sd(list(values.values()))[0],
                        "jax": jax, "d": d, "s": s, "z": z}
            zs[col].append(z)
        positive += row["CD"]["d"] > 0
        spreads.append((row["CD"]["s"], row["n"]))
        out["records"][name] = row
        lines.append(
            f"{name} epoch {rec.endpoint}, n = {row['n']} (seeds {row['seeds']}): CD port "
            f"{row['CD']['port_mean']:.4f} JAX {row['CD']['jax']:.4f} d {row['CD']['d']:+.4f} "
            f"s {row['CD']['s']:.4f} z {row['CD']['z']:+.3f}; F port {row['F']['port_mean']:.4f} "
            f"JAX {row['F']['jax']:.4f} d {row['F']['d']:+.4f} s {row['F']['s']:.4f} "
            f"z (sign reversed) {row['F']['z']:+.3f}")
    if zs["CD"]:
        out["Z_CD"], out["Z_F"] = pooled_z(zs["CD"]), pooled_z(zs["F"])
        out["n_records"], out["positive_d"] = len(zs["CD"]), positive
        out["detectable_bias_CD"] = detectable_bias(spreads)
        lines += [f"pooled over {len(zs['CD'])} records: Z(CD) = {out['Z_CD']:+.3f}, "
                  f"Z(F, sign reversed) = {out['Z_F']:+.3f}; d(CD) > 0 in {positive} of "
                  f"{len(zs['CD'])}",
                  f"smallest CD bias shared by every record that this design detects "
                  f"(Z = 2): {out['detectable_bias_CD']:.4f}"]
        z = out["Z_CD"]
        out["reading"] = ("the port's CD is biased high" if z >= 2 else
                          "the port does better than JAX" if z <= -2 else
                          "no bias told from the seed spread")
        lines.append(f"reading: {out['reading']}")
    out["witness"] = {}
    for name, rec in RECORDS.items():
        twins = endpoint_values(runs.get((name, "tpu"), {}), rec, "CD")
        exact = endpoint_values(runs.get((name, "exact"), {}), rec, "CD")
        if len(twins) < 2 or len(exact) < 2:
            continue
        delta, se = witness_delta(list(twins.values()), list(exact.values()))
        out["witness"][name] = {"epoch": rec.endpoint, "twins": twins, "exact": exact,
                                "delta": delta, "se": se, "moves": abs(delta) >= 2 * se}
        lines.append(f"witness {name} epoch {rec.endpoint}: bfloat16 twins n = {len(twins)} "
                     f"mean CD {mean_sd(list(twins.values()))[0]:.4f}, exact n = {len(exact)} "
                     f"{mean_sd(list(exact.values()))[0]:.4f}: delta {delta:+.4f}, SE {se:.4f}"
                     f" ({'|delta| >= 2 SE' if abs(delta) >= 2 * se else '|delta| < 2 SE'})")
    return lines, out


def trajectory_lines(runs):
    """Per record: each exact seed's CD change from epoch 27 to 54 against
    JAX's (2,500-iteration records), and every evaluation's CD / F / depth
    MedAE of each seed beside JAX's (10k records)."""
    lines = []
    for name, rec in RECORDS.items():
        exact = runs.get((name, "exact"), {})
        jax = dict(eval_points(read_jsonl(jax_dir(rec) / "metrics_lidar4d.jsonl")))
        if not exact:
            continue
        if (27, 54) == rec.evals:
            want = metric(jax["54"], "PointsMeter", 0) - metric(jax["27"], "PointsMeter", 0)
            got = {s: metric(dict(p)["54"], "PointsMeter", 0) - metric(dict(p)["27"],
                                                                        "PointsMeter", 0)
                   for s, (_, p) in sorted(exact.items())
                   if "27" in dict(p) and "54" in dict(p)}
            lines.append(f"{name} CD epoch 27 -> 54: JAX {want:+.4f}; port " + ", ".join(
                f"s{s} {v:+.4f}" for s, v in got.items()))
        if len(rec.evals) > 2:
            labels = [str(e) for e in rec.evals] + [str(rec.final)]
            for col, key, idx in (("CD", "PointsMeter", 0), ("F", "PointsMeter", 1),
                                  ("depth MedAE", "depth", 1)):
                lines.append(f"{name} {col} by evaluation ({' / '.join(labels)}):")
                lines.append("  JAX " + " / ".join(
                    f"{metric(jax[lb], key, idx):.4f}" if lb in jax else "-" for lb in labels))
                for s, (_, p) in sorted(exact.items()):
                    p = dict(p)
                    lines.append(f"  s{s} " + " / ".join(
                        f"{metric(p[lb], key, idx):.4f}" if lb in p else "-" for lb in labels))
    return lines


def step_launches(summary):
    """The distinct launch vectors a train step of a run's converge.json
    makes (KERNELS' order): each epoch's launches over its STEPS_PER_EPOCH
    steps (an epoch's steps share one sampler)."""
    return sorted({tuple(s["launches"].get(k, 0) / STEPS_PER_EPOCH for k in KERNELS)
                   for s in summary["stages"] if s["stage"] == "epoch"})


def launch_lines(runs):
    """Per record and variant: the distinct per-step launch vectors over
    its runs."""
    lines = [f"kernel launches a train step ({' / '.join(KERNELS)}):"]
    for (name, variant), seeds in sorted(runs.items()):
        vecs = set()
        for d, _ in seeds.values():
            vecs.update(step_launches(json.loads((d / "converge.json").read_text())))
        if not vecs:
            continue
        lines.append(f"  {name} {variant}: " + "; ".join(
            " / ".join(f"{v:g}" for v in vec) for vec in sorted(vecs)))
    return lines


def failed_lines(runs_dir=ROOT / "runs"):
    """The record directories of runs that did not end (their training CLI
    failed): the last line of their script output that says why."""
    lines = []
    for d in sorted(Path(runs_dir).glob("torch_*")):
        log = d / "log_converge.txt"
        summary = d / "converge.json"
        failed = (json.loads(summary.read_text()).get("failed") if summary.exists()
                  else log.exists() and "the training CLI failed" in log.read_text())
        if failed and log.exists():
            why = [ln for ln in log.read_text().splitlines()
                   if "[ERROR]" in ln or "Error" in ln or "NonFiniteStep" in ln]
            lines.append(f"failed: {d.name}: {(why or ['?'])[-1][:200]}")
    return lines


def report_pooled(runs_dir=ROOT / "runs"):
    runs = collect_runs(runs_dir)
    lines, out = pooled_reading(runs)
    for line in lines + trajectory_lines(runs) + launch_lines(runs) + failed_lines(runs_dir):
        print(line)
    print(json.dumps({k: out[k] for k in ("Z_CD", "Z_F", "positive_d", "detectable_bias_CD",
                                          "reading") if k in out}), flush=True)
    return out


# --------------------------------------------------------- finiteness probe
DUMP = "nonfinite_step.pt"          # in the workspace: what replays the step
DUMP_ADAM = "nonfinite_adam.pt"     # the Adam state before it (too large to bring back)
REPORT = "nonfinite_report.json"


class NonFiniteStep(RuntimeError):
    """A train step whose loss, loss terms or gradients are not all finite."""


def all_finite(metrics, grads):
    """Whether the loss, its terms and every gradient leaf are finite, in one
    reduction (one host sync)."""
    vals = [v.reshape(-1).float() for v in metrics.values()]
    vals += [g.reshape(-1).float() for g in grads if g is not None]
    return bool(torch.isfinite(torch.cat(vals)).all())


def nonfinite_names(metrics, grads, paths):
    """The metric keys, then the gradient leaves (dotted paths), holding a
    non-finite value."""
    return ([k for k in sorted(metrics) if not bool(torch.isfinite(metrics[k]).all())]
            + [p for p, g in zip(paths, grads)
               if g is not None and not bool(torch.isfinite(g).all())])


def step_key(step_fn):
    """What rebuilds a TrainStep besides the field, optimizer and loss config."""
    return {"H": step_fn.H, "W": step_fn.W, "fov_lidar": list(step_fn.fov_lidar),
            "num_rays": step_fn.num_rays, "num_steps": step_fn.num_steps,
            "patch_size": [step_fn.px, step_fn.py], "num_coarse": step_fn.num_coarse,
            "num_fine": step_fn.num_fine}


def frame_index(t, num_frames):
    """The sequence index of a frame at time t, as the flow loss takes it."""
    import numpy as np

    return int(np.floor(np.float32(t) * np.float32(num_frames - 1) + np.float32(0.5)))


def _on(x, device):
    return x.detach().to(device) if isinstance(x, torch.Tensor) else x


class FirstNonFinite(TorchDispatchMode):
    """Records the first operator whose output holds a non-finite value:
    its name, shape, count and the innermost frame of this repository on
    the Python stack (none in the backward pass). Allocations and copies
    are not checked (an allocation's memory is not yet written)."""

    SKIP = ("empty", "new_empty", "set_", "detach", "view", "_to_copy", "copy_", "clone")

    def __init__(self):
        super().__init__()
        self.first, self.ops = None, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if self.first is not None or func.__name__.split(".")[0].startswith(self.SKIP):
            return out
        for t in pytree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()):
                continue
            bad = ~torch.isfinite(t)
            if bool(bad.any()):
                here = [f for f in traceback.extract_stack()
                        if f.filename.startswith(str(ROOT))
                        and not f.filename.endswith("converge_torch.py")]
                self.first = {
                    "op": func.__name__, "index": self.ops, "shape": list(t.shape),
                    "nonfinite": int(bad.sum()), "nan": int(torch.isnan(t).sum()),
                    "where": (f"{Path(here[-1].filename).relative_to(ROOT)}:{here[-1].lineno} "
                              f"{here[-1].line}" if here else "backward pass (no Python frame)")}
                break
        return out


@contextlib.contextmanager
def step_anatomy(record):
    """Record, along a step's render: the density head's largest input
    (`trunc_exp`'s, overflowing float32 above ~88.7), sigma's infinite
    entries, zero sample spacings (z_vals duplicated by the merge) and
    non-finite compositing weights, summed over the step's renders."""
    from lidar4d_tpu_torch.models import lidar4d, renderer

    saved = lidar4d.trunc_exp, renderer._composite_weights
    record.update(head_input_max=-math.inf, sigma_inf=0, zero_deltas=0, weights_nonfinite=0,
                  zero_delta_inf_sigma=0)

    def trunc_exp(x):
        top, seen = float(x.detach().max()), record["head_input_max"]
        record["head_input_max"] = top if math.isnan(top) or top > seen else seen
        return saved[0](x)

    def composite(cfg, sigma, z_vals, sample_dist):
        w = saved[1](cfg, sigma, z_vals, sample_dist)
        zero = torch.cat([z_vals[:, 1:] == z_vals[:, :-1],
                          torch.zeros_like(z_vals[:, :1], dtype=torch.bool)], 1)
        inf = torch.isinf(sigma.detach())
        record["sigma_inf"] += int(inf.sum())
        record["zero_deltas"] += int(zero.sum())
        record["zero_delta_inf_sigma"] += int((zero & inf).sum())
        record["weights_nonfinite"] += int((~torch.isfinite(w.detach())).sum())
        return w

    lidar4d.trunc_exp, renderer._composite_weights = trunc_exp, composite
    try:
        yield record
    finally:
        lidar4d.trunc_exp, renderer._composite_weights = saved


def replay_step(step_fn, params, frame, cache, draws, step, grads_fn=None):
    """One step's loss and gradients again on the same state (nothing is
    updated), under `step_anatomy` and `FirstNonFinite`: a dict of the
    metrics, the non-finite metrics and leaves, the anatomy and the first
    non-finite operator."""
    from lidar4d_tpu_torch.interop import tree_paths
    from lidar4d_tpu_torch.train.train_step import TrainStep

    grads_fn = grads_fn or TrainStep.grads
    anatomy = {}
    mode = FirstNonFinite()
    with step_anatomy(anatomy), mode:
        grads, metrics = grads_fn(step_fn, params, frame, cache, draws, step)
    return {"metrics": {k: float(v) for k, v in sorted(metrics.items())},
            "nonfinite": nonfinite_names(metrics, grads, tree_paths(params)),
            "anatomy": anatomy, "first_nonfinite_op": mode.first, "ops": mode.ops}


def replay_everywhere(step_fn, params, frame, cache, draws, step, grads_fn=None):
    """`replay_step` on the step's device with the kernels, on that device
    with every kernel's plain version (where it is a card), and on the CPU
    (the plain versions) from the same state."""
    import chip_smoke
    from lidar4d_tpu_torch.interop import tree_map
    from lidar4d_tpu_torch.train.train_step import make_train_step

    out = {"device": replay_step(step_fn, params, frame, cache, draws, step, grads_fn)}
    if step_fn.field.device.type == "cuda":
        with chip_smoke.plain_kernels():
            out["device plain"] = replay_step(step_fn, params, frame, cache, draws, step,
                                              grads_fn)
    cpu = "cpu"
    field = type(step_fn.field)(step_fn.field.cfg, device=cpu)
    k = step_key(step_fn)
    cpu_step = make_train_step(field, step_fn.opt, step_fn.cfg, H=k["H"], W=k["W"],
                               fov_lidar=k["fov_lidar"], num_rays=k["num_rays"],
                               num_steps=k["num_steps"], patch_size=tuple(k["patch_size"]),
                               num_coarse=k["num_coarse"], num_fine=k["num_fine"])
    out["cpu"] = replay_step(
        cpu_step, tree_map(lambda p: _on(p, cpu), params),
        {n: _on(v, cpu) for n, v in frame.items()},
        None if cache is None else {n: _on(v, cpu) for n, v in cache.items()},
        {n: _on(v, cpu) for n, v in draws.items()}, step, grads_fn)
    return out


def cache_part(cache, idx):
    """The flow cache's frames that the flow loss at frame `idx` reads (it,
    and its neighbours at +-1 and +-2): {"frames", "valid", and each other
    array at those frames}; `cache_whole` gives a cache of the full shapes
    back, zero at the other frames."""
    if cache is None:
        return None
    n = cache["points"].shape[0]
    keep = sorted({min(max(idx + s, 0), n - 1) for s in (0, 1, -1, 2, -2)})
    return {"frames": keep, **{k: _on(v if k == "valid" else v[keep], "cpu")
                               for k, v in cache.items()}}


def cache_whole(part):
    """The flow cache of `cache_part`'s shapes, zero at the frames it left out."""
    keep, valid = part["frames"], part["valid"]
    out = {"valid": valid}
    for k, v in part.items():
        if k not in ("frames", "valid"):
            out[k] = torch.zeros((valid.shape[0], *v.shape[1:]), dtype=v.dtype)
            out[k][keep] = v
    return out


def dump_step(path, step_fn, state, frame, cache, draws, cli_argv, names):
    """What replays one step: the pre-step parameters (the U-Net's aside: the
    step never reads them), the frame, its sequence index, the flow cache's
    frames it reads (`cache_part`), the draws, the step count and the
    TrainStep's shape, into `path`; the Adam state beside it (DUMP_ADAM)."""
    from lidar4d_tpu_torch.interop import tree_map

    cpu = "cpu"
    idx = frame_index(frame["time"], step_fn.cfg.num_frames)
    params = {k: tree_map(lambda p: _on(p, cpu), v) for k, v in state.params.items()
              if k != "unet"}
    torch.save({"cli_argv": list(cli_argv), "step": state.step, "frame_idx": idx,
                "frame": {k: _on(v, cpu) for k, v in frame.items()},
                "cache": cache_part(cache, idx),
                "draws": {k: _on(v, cpu) for k, v in draws.items()},
                "key": step_key(step_fn), "params": params, "nonfinite": names}, path)
    opt = state.opt_state
    torch.save({"mu": [_on(m, cpu) for m in opt.mu], "nu": [_on(v, cpu) for v in opt.nu],
                "count": opt.count}, Path(path).parent / DUMP_ADAM)


@contextlib.contextmanager
def finite_probe(ws, cli_argv):
    """Check every train step before its update: at the first whose loss,
    loss terms or gradients are not all finite, dump it (`dump_step`, into
    the workspace), replay it on the card with the kernels, with the plain
    versions, and on the CPU (`replay_everywhere`, REPORT in the workspace),
    and raise NonFiniteStep, which ends the run."""
    from lidar4d_tpu_torch.interop import tree_paths
    from lidar4d_tpu_torch.train.train_step import TrainStep

    call, grads_fn = TrainStep.__call__, TrainStep.grads
    current = {}

    def probed_call(self, state, frame, flow_cache, draws=None):
        current["state"] = state        # its Adam state, for the dump
        return call(self, state, frame, flow_cache, draws)

    def probed_grads(self, params, frame, flow_cache, draws, step):
        grads, metrics = grads_fn(self, params, frame, flow_cache, draws, step)
        if all_finite(metrics, grads):
            return grads, metrics
        names = nonfinite_names(metrics, grads, tree_paths(params))
        idx = frame_index(frame["time"], self.cfg.num_frames)
        print(f"[PROBE] non-finite at step {step} (frame {idx}): {names}", flush=True)
        dump_step(Path(ws) / DUMP, self, current["state"], frame, flow_cache, draws, cli_argv,
                  names)
        report = {"step": step, "frame_idx": idx, "nonfinite": names,
                  "metrics": {k: float(v) for k, v in sorted(metrics.items())},
                  "replays": replay_everywhere(self, params, frame, flow_cache, draws, step,
                                               grads_fn)}
        (Path(ws) / REPORT).write_text(json.dumps(report, indent=1) + "\n")
        print("[PROBE] " + json.dumps(report), flush=True)
        raise NonFiniteStep(f"non-finite loss or gradients at step {step}: {names}")

    TrainStep.__call__, TrainStep.grads = probed_call, probed_grads
    try:
        yield
    finally:
        TrainStep.__call__, TrainStep.grads = call, grads_fn


# --------------------------------------------------------- the child process
def run_child(out_json, cli_argv, float32_mlps=False, plain=False, tpu=False, probe_ws=None):
    """The training CLI in this process under chip_smoke's TrainerProbe
    (each stage timed, its kernel launches counted); writes them to
    `out_json`. `float32_mlps` runs the field's MLPs in float32, `plain`
    swaps every kernel wrapper for its plain PyTorch version on the card,
    `tpu` every training-path wrapper for its bfloat16 twin; `probe_ws`
    checks every step under `finite_probe`, its dump in that workspace."""
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
        if tpu:
            stack.enter_context(chip_smoke.tpu_numerics())
        if probe_ws:
            stack.enter_context(finite_probe(probe_ws, cli_argv))
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
    epochs = iter(sorted(epochs) if isinstance(epochs, dict) else epochs)
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


def copy_out(ws, out, keep_at, kept):
    """Copy the workspace's record files into `out`; once the metrics hold
    the evaluation at epoch `keep_at` (None: keep nothing), copy the best
    checkpoint the trainer wrote after it (once) to `kept_path`. Returns
    whether that copy exists."""
    out.mkdir(parents=True, exist_ok=True)
    for name in RECORD_FILES:
        if (ws / name).exists():
            shutil.copy(ws / name, out / name)
    if keep_at is None or kept:
        return kept
    best = ws / "checkpoints" / "lidar4d_best"
    metrics = ws / "metrics_lidar4d.jsonl"
    if best.exists() and metrics.exists() and keep_at in eval_rows(read_jsonl(metrics)):
        kept_path(ws, keep_at).parent.mkdir(exist_ok=True)
        shutil.copy(best, kept_path(ws, keep_at))
        return True
    return False


def kept_path(ws, epoch):
    """Where `--examine` keeps the best checkpoint of an epoch: a name
    ending in `_best`, which the trainer restores as weights."""
    return Path(ws) / "kept" / f"lidar4d_ep{epoch:04d}_best"


def diagnose(rec, args, ws, out):
    """scripts/diag_floaters_torch.py in a fresh process on the checkpoint
    kept at the record's first evaluation; its summary JSON into
    <out>/diag_summary_ep<E>.json. Returns its summary and seconds."""
    epoch = rec.evals[0]
    target = out / f"diag_summary_ep{epoch}.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "diag_floaters_torch.py"), "--config",
         rec.config, "--workspace", str(ws), "--path", args.scene, "--dataloader", "synthetic",
         "--ckpt", str(kept_path(ws, epoch)), "--out", str(target)],
        cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
    if proc.returncode != 0:
        return {"failed": proc.returncode, "seconds": seconds}
    return {"summary": json.loads(target.read_text())["summary"], "seconds": seconds}


def simulate(rec, args, ws):
    """The simulation CLI in fresh processes on the run's workspace: the
    config's sensor (66x1030) with the U-Net refine (`--ckpt latest_model`),
    then `--kitti2nus` (32x1024, no refine) from the refine checkpoint. Each:
    wall seconds, the s/frame it prints, its kernel launches and the points
    of every frame's cloud."""
    import chip_smoke

    base = ["--config", rec.config, "--path", args.scene, "--seed", str(args.seed)]
    refine_ckpt = ws / "checkpoints" / f"lidar4d_ep{rec.epochs:04d}_refine"
    out = {}
    for name, argv, where in (
            ("66x1030 refine", ["--workspace", str(ws), "--ckpt", "latest_model"], ws),
            ("kitti2nus", ["--workspace", str(ws / "sim_kitti2nus"), "--ckpt",
                           str(refine_ckpt), "--kitti2nus"], ws / "sim_kitti2nus")):
        try:
            wall, s_frame, launches, loaded = chip_smoke.run_sim_cli(base + argv)
            points = [len(c) for c in chip_smoke.read_clouds(str(where))]
        except (AssertionError, OSError, subprocess.TimeoutExpired) as e:
            out[name] = {"failed": str(e)[-2000:]}
            print(f"simulate {name} failed: {e}", flush=True)
            continue
        out[name] = {"cli_wall_s": wall, "s_per_frame": s_frame, "launches": launches,
                     "checkpoint": loaded, "points_per_frame": points}
        print(f"simulate {name}: {s_frame} s/frame, {wall:.1f} s wall, points a frame "
              f"{min(points)}-{max(points)} (mean {sum(points) / len(points):.1f}), launches "
              f"{launches}, checkpoint {loaded}", flush=True)
    return out


def variant_flags(args):
    return [f for f, on in (("--float32-mlps", args.float32_mlps),
                            ("--plain-kernels", args.plain_kernels),
                            ("--tpu-numerics", args.tpu_numerics),
                            ("--finite-probe", args.finite_probe)) if on]


def run_seeds(args, seeds, extra):
    """One process of this script a seed, all at once, each with its own
    scene directory; their output in their record's log_converge.txt.
    Returns the largest exit code."""
    from lidar4d_tpu_torch.ops import _cuda

    _cuda.build()                       # once, before the processes start
    procs = []
    for seed in seeds:
        out = record_dir(args, seed)
        out.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--record", args.record,
               "--seed", str(seed), "--scene", f"{args.scene}_s{seed}",
               "--runs-dir", args.runs_dir, *variant_flags(args)]
        if args.workspace:
            cmd += ["--workspace", f"{args.workspace}_s{seed}"]
        cmd += ["--", *extra]
        log = open(out / "log_converge.txt", "w")
        procs.append((seed, subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                             stderr=subprocess.STDOUT), log))
    rcs = {}
    for seed, proc, log in procs:
        rcs[seed] = proc.wait()
        log.close()
    print("exit codes by seed: " + json.dumps(rcs), flush=True)
    return max(rcs.values())


def record_dir(args, seed):
    """<runs-dir>/torch_[tpu_]<record>_s<seed>."""
    return Path(args.runs_dir) / f"torch_{'tpu_' if args.tpu_numerics else ''}{args.record}_s{seed}"


# ----------------------------------------------------------------------- main
def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--record", default="conf_phash111", choices=sorted(RECORDS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default=None,
                   help="comma-separated seeds, one process each, all at once")
    p.add_argument("--scene", default="data/bench_synth_torch",
                   help="the bench scene's directory (written if missing)")
    p.add_argument("--runs-dir", default="runs",
                   help="where the record directory torch_[tpu_]<record>_s<seed> goes")
    p.add_argument("--workspace", default=None,
                   help="the CLI's workspace, kept after the run (default a temporary "
                        "directory, removed); under --seeds each seed's is <this>_s<seed>")
    p.add_argument("--examine", action="store_true",
                   help="after a whole run, the CD anatomy at the record's first evaluation "
                        "(scripts/diag_floaters_torch.py) and the simulation CLI (66x1030 "
                        "with the refine, and --kitti2nus)")
    p.add_argument("--report", default=None, metavar="RECORD_DIR",
                   help="only print a record directory's tables against the JAX record")
    p.add_argument("--report-pooled", action="store_true",
                   help="only print the pooled reading of every runs/torch_* record")
    p.add_argument("--float32-mlps", action="store_true",
                   help="run the field's MLPs in float32 (the port's own are bfloat16)")
    p.add_argument("--plain-kernels", action="store_true",
                   help="run every kernel's plain PyTorch version in its place")
    p.add_argument("--tpu-numerics", action="store_true",
                   help="run every training-path kernel's bfloat16 twin in its place")
    p.add_argument("--finite-probe", action="store_true",
                   help="check every train step's loss, loss terms and gradients; at the "
                        f"first non-finite one write {DUMP} and {DUMP_ADAM} (the step's "
                        f"state) and {REPORT} (its replays) into the workspace and stop")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    rec = RECORDS[args.record]
    if args.child:
        ws = extra[extra.index("--workspace") + 1] if args.finite_probe else None
        run_child(args.child, extra, args.float32_mlps, args.plain_kernels, args.tpu_numerics,
                  ws)
        return 0
    if args.report_pooled:
        report_pooled()
        return 0
    if args.report:
        summary = Path(args.report) / "converge.json"
        train_only = summary.exists() and "--train_only" in json.loads(
            summary.read_text()).get("cli_argv", [])
        checks, fails = report(args.report, rec, train_only)
        return 2 if not all(checks.values()) else 1 if fails else 0

    os.chdir(ROOT)
    if args.seeds:
        return run_seeds(args, [int(s) for s in args.seeds.split(",")], extra)
    out = record_dir(args, args.seed)
    train_only = "--train_only" in extra
    card_line = card()
    print(f"card: {card_line}", flush=True)

    scale, _, t_scene = write_scene(args.scene, float(config_values(ROOT / rec.config)["scale"]))
    print(f"scene {SCENE} in {args.scene}: scale {scale!r} ({t_scene:.1f} s)", flush=True)

    from lidar4d_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()[0]
    t_build = time.perf_counter() - t0
    print(f"kernels {built} in {t_build:.1f} s", flush=True)

    if args.workspace:
        ws = Path(args.workspace).resolve()
        ws.mkdir(parents=True, exist_ok=True)
    else:
        ws = Path(tempfile.mkdtemp(prefix="converge_ws_"))
    stages_json = ws / "converge_stages.json"
    cli_argv = ["--config", rec.config, "--dataloader", "synthetic", "--path", args.scene,
                "--workspace", str(ws), "--seed", str(args.seed), *extra]
    print("CLI: python -m lidar4d_tpu_torch.cli.main_lidar4d " + " ".join(cli_argv), flush=True)
    out.mkdir(parents=True, exist_ok=True)
    head = {"record": args.record, "seed": args.seed, "config": rec.config, "card": card_line,
            "float32_mlps": args.float32_mlps, "plain_kernels": args.plain_kernels,
            "tpu_numerics": args.tpu_numerics, "finite_probe": args.finite_probe,
            "cli_argv": cli_argv, "stages": []}
    # until the run ends: a record that a cut run leaves keeps what it is
    (out / "converge.json").write_text(json.dumps({**head, "finished": False}, indent=1) + "\n")
    keep_at = rec.evals[0] if args.examine else None
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *variant_flags(args),
                             "--child", str(stages_json), "--", *cli_argv], cwd=ROOT)
    kept = False
    while True:
        try:
            proc.wait(timeout=POLL_S)
            break
        except subprocess.TimeoutExpired:
            kept = copy_out(ws, out, keep_at, kept)
    t_process = time.perf_counter() - t0
    kept = copy_out(ws, out, keep_at, kept)
    if proc.returncode != 0:
        print(f"the training CLI failed: exit code {proc.returncode}", flush=True)
        probed = ws / REPORT
        (out / "converge.json").write_text(json.dumps({
            **head, "finished": False, "failed": proc.returncode,
            "seconds": {"CLI process": t_process},
            **({"nonfinite": json.loads(probed.read_text())} if probed.exists() else {})},
            indent=1) + "\n")
        return 2

    child = json.loads(stages_json.read_text())
    checks, fails = report(out, rec, train_only)
    records = read_jsonl(out / "metrics_lidar4d.jsonl")
    stages = name_evaluations(child["stages"],
                              [label for label, _ in eval_points(records)])
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
        **head, "finished": True, "device": child["device"],
        "refine_unet": child["refine_unet"], "checks": checks, "band_failures": fails,
        "seconds": {"scene": t_scene, "kernel build": t_build, "CLI process": t_process,
                    "CLI main": child["main_seconds"], **parts},
        "stages": stages, "launches": child["launches"],
        "launches_train_epochs": train_launches,
    }
    if args.examine:
        summary["kept_checkpoint"] = str(kept_path(ws, keep_at)) if kept else None
        if kept:
            summary["diag"] = diagnose(rec, args, ws, out)
        summary["simulate"] = simulate(rec, args, ws)
    if not args.workspace:
        shutil.rmtree(ws, ignore_errors=True)
    (out / "converge.json").write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({k: summary[k] for k in ("record", "seed", "card", "checks",
                                              "band_failures")}))
    if not all(checks.values()):
        return 2
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
