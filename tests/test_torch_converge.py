"""scripts/converge_torch.py on the CPU: its scene step at a tiny size, and
its comparison, checks and tables fed the JAX package's committed record
(runs/ab6_conf_phash111) and made-up port records; the port's committed
records of the whole run (runs/torch_conf_phash111_s*) through the same
checks."""

import ast
import copy
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("converge_torch",
                                               ROOT / "scripts" / "converge_torch.py")
ct = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ct)

TINY_SCENE = dict(sequence_id="9000", num_frames=6, H=8, W=32, seed=0)
PHASH111 = ct.RECORDS["conf_phash111"]
JAX_PHASH111 = ct.jax_dir(PHASH111)


def _jax_records():
    return ct.read_jsonl(JAX_PHASH111 / "metrics_lidar4d.jsonl")


def _write_record(path, records, log_lines):
    path.mkdir(parents=True, exist_ok=True)
    (path / "metrics_lidar4d.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    (path / "log_lidar4d.txt").write_text("".join(line + "\n" for line in log_lines))
    return path


def _numeric_rows(lines, width):
    """{first number: the rest} of the printed rows of `width` numbers."""
    rows = {}
    for line in lines:
        try:
            values = [float(v) for v in line.split()]
        except ValueError:
            continue
        if len(values) == width:
            rows[int(values[0])] = values[1:]
    return rows


def test_scene_is_the_benchs():
    """SCENE is bench.py's scene: its module constants and the keywords of
    its generate_synthetic_sequence call (read from the source, which
    imports JAX)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    consts = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant):
                consts[t.id] = n.value.value
            elif isinstance(t, ast.Tuple) and isinstance(n.value, ast.Tuple):
                consts.update((a.id, ast.literal_eval(b)) for a, b in zip(t.elts, n.value.elts))
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "generate_synthetic_sequence")
    kw = {k.arg: consts[k.value.id] if isinstance(k.value, ast.Name)
          else ast.literal_eval(k.value) for k in call.keywords}
    assert kw == ct.SCENE
    assert float(ct.config_values(ROOT / PHASH111.config)["scale"]) == 0.01006991432868821


def test_write_scene_tiny(tmp_path, monkeypatch):
    """Written once with its meta.json, read back the second time without
    writing, and refused when its scale is not the config's."""
    from lidar4d_tpu_torch.data import synthetic

    scale, offset = synthetic.generate_synthetic_sequence(str(tmp_path / "ref"), **TINY_SCENE)
    got = ct.write_scene(tmp_path / "scene", scale, TINY_SCENE)
    assert got[:2] == (scale, offset)
    assert (tmp_path / "scene" / "transforms_9000_train.json").exists()
    assert json.loads((tmp_path / "scene" / "meta.json").read_text())["scene"] == TINY_SCENE

    def refuse(*a, **k):
        raise AssertionError("the scene was written again")

    monkeypatch.setattr(synthetic, "generate_synthetic_sequence", refuse)
    assert ct.write_scene(tmp_path / "scene", scale, TINY_SCENE)[:2] == (scale, offset)
    with pytest.raises(ValueError, match="config scale"):
        ct.write_scene(tmp_path / "scene", scale * (1 + 1e-5), TINY_SCENE)


def test_jax_record_reads_and_meets_its_own_checks():
    """The JAX record through the script's readers: its parameter count,
    schedule, refine BCE (log_lidar4d.txt:88-107) and the band."""
    checks, fails = ct.check_record(JAX_PHASH111, PHASH111)
    assert all(checks.values()), checks
    assert fails == []
    n_params, bce = ct.read_log(JAX_PHASH111 / "log_lidar4d.txt")
    assert n_params == PHASH111.n_params
    assert bce[0] == (0, 0.782084) and bce[-1] == (950, 0.089363) and len(bce) == 20
    rows = ct.eval_rows(_jax_records())
    assert ct.metric(rows[54], "PointsMeter", 0) == pytest.approx(0.16255719, abs=1e-8)
    assert ct.metric(rows[61], "RaydropMeter", 1) == pytest.approx(0.98108267, abs=1e-8)


@pytest.mark.parametrize("epoch,key,idx,value,miss", [
    (None, None, None, None, []),
    (54, "PointsMeter", 0, 0.1811, ["epoch 54 CD 0.1811 > 0.181"]),
    (54, "PointsMeter", 1, 0.8729, ["epoch 54 F 0.8729 < 0.873"]),
    (61, "depth", 0, 3.081, ["epoch 61 depth RMSE 3.081 > 3.08"]),
    (61, "RaydropMeter", 1, 0.9749, ["epoch 61 raydrop Acc 0.9749 < 0.975"]),
    (61, None, None, None, ["no evaluation at epoch 61"]),
], ids=["met", "cd54", "f54", "rmse61", "acc61", "no61"])
def test_band_failures(epoch, key, idx, value, miss):
    """A made-up port record (the JAX record with one number moved just
    past its bound, or an evaluation dropped) against the band."""
    rows = copy.deepcopy(ct.eval_rows(_jax_records()))
    if key is not None:
        rows[epoch][key][idx] = value
    elif epoch is not None:
        del rows[epoch]
    assert ct.band_failures(rows, ct.BAND) == miss


def test_tables_and_checks_of_a_made_up_port_record(tmp_path, capsys):
    """A port record whose numbers are the JAX record's moved by known
    amounts: every evaluation row, the per-epoch losses with their trailing
    means, the refine BCE beside the JAX log's, and the checks, which fail
    on a short schedule."""
    jax = _jax_records()
    port = copy.deepcopy(jax)
    for r in port:
        if "valid_loss" in r:
            r["PointsMeter"][0] += 0.01
        else:
            r["loss"] *= 2
    log = ["[INFO] #parameters: 8971809"] + [
        f"refine iter {i}: raydrop bce {0.5 / (i + 1):.6f}" for i in range(0, 1000, 50)]
    rec = _write_record(tmp_path / "port", port, log)

    checks, fails = ct.report(rec, PHASH111)
    lines = capsys.readouterr().out.splitlines()
    assert all(checks.values()) and fails == []
    assert "band: met" in lines
    cd54 = next(line.split() for line in lines if line.split()[:2] == ["54", "CD"])
    assert [float(v) for v in cd54[2:]] == pytest.approx([0.17256, 0.16256, 0.01], abs=1e-5)
    assert len([line for line in lines if line.split()[1:2] in (["CD"], ["F"])]) == 6
    losses = _numeric_rows(lines, 5)
    assert sorted(losses) == list(range(1, 62))
    assert losses[5][0] == pytest.approx(2 * losses[5][1], abs=2e-4)
    assert losses[5][3] == pytest.approx(sum(losses[e][1] for e in range(1, 6)) / 5, abs=1e-3)
    bce = _numeric_rows(lines, 3)
    assert bce[0] == [0.5, 0.782084] and bce[950] == pytest.approx([0.5 / 951, 0.089363], abs=1e-6)

    short = [r for r in port if r["epoch"] <= 54]
    checks, fails = ct.check_record(_write_record(tmp_path / "short", short, log[:5]), PHASH111)
    assert checks == {"parameters": True, "epochs": False, "evaluations": False,
                      "refine steps": False}
    assert fails == ["no evaluation at epoch 61"]


def test_stage_sums():
    """Wall time by part and launches summed over the epochs."""
    stages = [{"stage": "flow cache", "seconds": 9.0, "launches": {"k": 0}},
              {"stage": "epoch", "seconds": 3.0, "launches": {"k": 12}},
              {"stage": "epoch", "seconds": 4.0, "launches": {"k": 12}},
              {"stage": "evaluate 2", "seconds": 6.0, "launches": {"k": 60}}]
    assert ct.summarize_stages(stages) == {"flow cache": 9.0, "evaluate 2": 6.0, "epochs": 7.0}
    assert ct.sum_launches(stages, {"epoch"}) == {"k": 24}


def test_probe_evaluations_named_by_epoch():
    """chip_smoke.TrainerProbe's "evaluate" stages take, in order, the
    epochs of the record's evaluations; the other stages stay as they are."""
    stages = [{"stage": s, "seconds": 1.0, "launches": {}}
              for s in ("flow cache", "epoch", "evaluate", "epoch", "evaluate", "refine",
                        "evaluate", "test")]
    named = ct.name_evaluations(stages, {61: {}, 27: {}, 54: {}})
    assert [s["stage"] for s in named] == ["flow cache", "epoch", "evaluate 27", "epoch",
                                           "evaluate 54", "refine", "evaluate 61", "test"]
    assert stages[2]["stage"] == "evaluate"


@pytest.mark.parametrize("name,seed", [("s0", 0), ("s1", 1), ("s1_again", 1), ("s2", 2)])
def test_committed_port_record(name, seed):
    """The port's records of whole runs on the card: the JAX record's
    parameter count and schedule, the unedited config, and the band's
    verdict as the run printed it on the card (converge.json)."""
    rec = ROOT / "runs" / f"torch_conf_phash111_{name}"
    checks, fails = ct.check_record(rec, PHASH111)
    assert all(checks.values()), checks
    args = dict(line.split(" = ", 1) for line in (rec / "args.txt").read_text().splitlines())
    assert (args["config"], args["seed"], args["dataloader"]) == (
        PHASH111.config, str(seed), "synthetic")
    summary = json.loads((rec / "converge.json").read_text())
    assert summary["card"].startswith("NVIDIA H100")
    assert summary["checks"] == checks and summary["band_failures"] == fails
    assert summary["launches"]["hash_grid_fwd"] > 0


@pytest.mark.parametrize("name,seed,switch", [
    ("f32_s1", 1, "float32_mlps"), ("f32_s4", 4, "float32_mlps"),
    ("plain_s1", 1, "plain_kernels"), ("plain_s4", 4, "plain_kernels")])
def test_committed_witness_record(name, seed, switch):
    """The `--train_only` witnesses of seeds 1 and 4 (float32 MLPs; every
    kernel's plain version): the unedited config at their seed, evaluations
    at epochs 27 and 54. The plain runs were cut by the call's time limit
    after epoch 54, so they keep their metrics and the script's output."""
    rec = ROOT / "runs" / f"torch_conf_phash111_train_only_{name}"
    records = ct.read_jsonl(rec / "metrics_lidar4d.jsonl")
    assert sorted(ct.eval_rows(records)) == [27, 54]
    assert sorted(ct.epoch_losses(records))[:54] == list(range(1, 55))
    if switch == "float32_mlps":
        checks, _ = ct.check_record(rec, PHASH111)
        assert checks == {"parameters": True, "epochs": True, "evaluations": False,
                          "refine steps": False}
        summary = json.loads((rec / "converge.json").read_text())
        assert (summary["seed"], summary["float32_mlps"], summary["plain_kernels"]) == (
            seed, True, False)
        assert summary["card"].startswith("NVIDIA H100")
    else:
        out = (rec / "log_converge.txt").read_text()
        assert out.startswith("card: NVIDIA H100")
        cli = next(line for line in out.splitlines() if line.startswith("CLI: "))
        assert f"--config {PHASH111.config} " in cli and cli.endswith(f"--seed {seed} --train_only")


@pytest.mark.parametrize("name", sorted(ct.RECORDS))
def test_records_table(name):
    """Each record's config parses with the port's CLI parser and builds, on
    the CPU, a field of the JAX log's parameter count (its
    log_lidar4d.txt:2); the JAX record holds the table's evaluations in
    order, before and after its refine, and its epochs."""
    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.interop import tree_leaves
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    rec = ct.RECORDS[name]
    opt = get_arg_parser().parse_args(["--config", str(ROOT / rec.config)])
    params = LiDAR4DField(build_model_config(opt), device="cpu").init(0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    jax_dir = ct.jax_dir(rec)
    assert ct.read_log(jax_dir / "log_lidar4d.txt")[0] == rec.n_params == n_params
    checks, fails = ct.check_record(jax_dir, rec)
    assert all(checks.values()), checks
    assert fails == []
    points = ct.eval_points(ct.read_jsonl(jax_dir / "metrics_lidar4d.jsonl"))
    assert [r["epoch"] for _, r in points] == [*rec.evals, rec.final]
    assert (rec.band is not None) == (name == "conf_phash111")


def _made_up_run(root, name, record, seed, cds, variant="exact", train_only=True):
    """A record directory holding only what the pooled reading reads: its
    evaluations (the JAX record's, CD and F moved to `cds`) and converge.json."""
    rec = ct.RECORDS[record]
    jax = [r for r in ct.read_jsonl(ct.jax_dir(rec) / "metrics_lidar4d.jsonl")
           if "valid_loss" in r][:len(rec.evals)]
    port = copy.deepcopy(jax)
    for r, (cd, f) in zip(port, cds):
        r["PointsMeter"][:2] = [cd, f]
    d = _write_record(root / name, port, [])
    (d / "converge.json").write_text(json.dumps({
        "record": record, "seed": seed, "config": rec.config,
        "tpu_numerics": variant == "tpu", "float32_mlps": False, "plain_kernels": False,
        "cli_argv": ["--seed", str(seed)] + (["--train_only"] if train_only else [])}))
    return d


def test_pooled_reading_of_made_up_records(tmp_path):
    """Fixed made-up port records with a known statistic: per record d, s
    and z = d / (s sqrt(1 + 1/n)), Z = sum z / sqrt(5) for CD and (sign
    reversed) F, the positive d, the detectable bias, the witness delta and
    its standard error; reruns are left out and a --train_only run is
    taken before a whole run of its seed."""
    offsets = {"flagship_phash211": (0.01, 0.03), "conf_phash111": (0.02, 0.01),
               "conf_phash112": (-0.01, 0.02), "flagship10k_phash": (0.0, 0.04),
               "flagship10k_urf": (0.03, 0.02)}
    spread = (-1.0, 0.0, 1.0, 0.5, -0.5)
    want_z = []
    for name, (bias, s) in offsets.items():
        rec = ct.RECORDS[name]
        jcd, jf = (ct.jax_endpoint(rec, c) for c in ("CD", "F"))
        for seed, k in enumerate(spread):
            cds = [(0.0, 0.0)] * (len(rec.evals) - 1) + [(jcd + bias + k * s,
                                                          jf - bias + k * s / 2)]
            _made_up_run(tmp_path, f"torch_{name}_s{seed}", name, seed, cds)
        values = [bias + k * s for k in spread]
        m = sum(values) / 5
        sd = (sum((v - m) ** 2 for v in values) / 4) ** 0.5
        want_z.append(m / (sd * (1 + 1 / 5) ** 0.5))
    rec = ct.RECORDS["flagship_phash211"]
    jcd, jf = ct.jax_endpoint(rec, "CD"), ct.jax_endpoint(rec, "F")
    # a rerun and a whole run of a seed that has a --train_only run: not counted
    _made_up_run(tmp_path, "torch_flagship_phash211_s0_again", "flagship_phash211", 0,
                 [(jcd + 5.0, jf)])
    _made_up_run(tmp_path, "torch_flagship_phash211_whole_s1", "flagship_phash211", 1,
                 [(jcd + 5.0, jf)], train_only=False)
    for seed, v in enumerate((0.02, 0.04, 0.03)):
        _made_up_run(tmp_path, f"torch_tpu_flagship_phash211_s{seed}", "flagship_phash211",
                     seed, [(jcd + v, jf)], variant="tpu")

    lines, out = ct.pooled_reading(ct.collect_runs(tmp_path))
    assert out["n_records"] == 5
    assert out["Z_CD"] == pytest.approx(sum(want_z) / 5 ** 0.5, rel=1e-9)
    assert out["Z_F"] == pytest.approx(
        sum(out["records"][n]["F"]["z"] for n in offsets) / 5 ** 0.5)
    assert out["records"]["conf_phash112"]["CD"]["d"] == pytest.approx(-0.01, abs=1e-12)
    assert out["records"]["flagship10k_phash"]["CD"]["z"] == pytest.approx(0.0, abs=1e-9)
    assert out["positive_d"] == 3
    assert out["records"]["flagship_phash211"]["n"] == 5
    spreads = [(out["records"][n]["CD"]["s"], 5) for n in offsets]
    assert out["detectable_bias_CD"] == pytest.approx(
        2 * 5 ** 0.5 / sum(1 / (s * 1.2 ** 0.5) for s, _ in spreads))
    w = out["witness"]["flagship_phash211"]
    exact = [0.01 + k * 0.03 for k in spread]
    me = sum(exact) / 5
    se2 = sum((v - me) ** 2 for v in exact) / 4 / 5 + 0.01 ** 2 / 3
    assert w["delta"] == pytest.approx(0.03 - me, abs=1e-9)
    assert w["se"] == pytest.approx(se2 ** 0.5, rel=1e-9)
    assert out["reading"] == ("the port's CD is biased high" if out["Z_CD"] >= 2 else
                              "no bias told from the seed spread")
    assert any(line.startswith("pooled over 5 records") for line in lines)


def test_tpu_numerics_flag_swaps_in_the_child(tmp_path, monkeypatch):
    """`--tpu-numerics` runs the child's CLI with the six wrappers of the
    eight training-path rows swapped for their bfloat16 twins (and
    `plane_bilinear_vjp` a kernel), restored after; without it the child
    runs the wrappers themselves."""
    import torch

    import chip_smoke
    from lidar4d_tpu_torch.cli import main_lidar4d

    names = (*chip_smoke.TPU_VERSIONS, "plane_bilinear_vjp")
    before = {n: getattr(chip_smoke.kernel_module(n), n) for n in names}
    seen = []

    def fake_main(argv):
        seen.append({n: getattr(chip_smoke.kernel_module(n), n) for n in names})

    monkeypatch.setattr(main_lidar4d, "main", fake_main)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    for flag in (["--tpu-numerics"], []):
        assert ct.main([*flag, "--child", str(tmp_path / "child.json"), "--", "x"]) == 0
    twins, plain = seen
    for n, twin in chip_smoke.TPU_VERSIONS.items():
        assert twins[n] is getattr(chip_smoke.kernel_module(n), twin)
    assert twins["plane_bilinear_vjp"] is before["plane_bilinear_vjp"]
    assert plain == before
    assert {n: getattr(chip_smoke.kernel_module(n), n) for n in names} == before


# per-step launches (converge_torch.KERNELS' order) of a uniform and a
# hierarchical step on each record's routes; conf_phash111's are its first
# records'
STEP_LAUNCHES = {
    "conf_phash111": [(8, 8, 3, 3, 4, 4, 0), (14, 14, 6, 6, 8, 8, 0)],
    "conf_phash112": [(8, 8, 3, 3, 4, 4, 0), (14, 14, 6, 6, 8, 8, 0)],
    "flagship10k_phash": [(8, 8, 3, 3, 4, 4, 0), (14, 14, 6, 6, 8, 8, 0)],
    "flagship10k_urf": [(7, 7, 4, 4, 4, 4, 0), (12, 12, 8, 8, 8, 8, 0)],
    "flagship_phash211": [(9, 9, 2, 2, 4, 4, 0), (16, 16, 4, 4, 8, 8, 0)],
}


def test_committed_records_launch_every_kernel_a_step():
    """Every finished record made on the card: each train epoch's launches
    are a whole number of uniform or hierarchical steps of its routes (the
    kernels on the main path, conf_phash111's routes at its first records'
    counts);
    under `--tpu-numerics` no kernel launches at all; the configs unedited
    at the record's seed."""
    seen = set()
    for d in sorted((ROOT / "runs").glob("torch_*")):
        path = d / "converge.json"
        if not path.exists():
            continue
        summary = json.loads(path.read_text())
        if not summary.get("finished", True) or summary.get("failed"):
            continue
        name, variant = summary["record"], ct.run_variant(summary)
        vecs = ct.step_launches(summary)
        want = ([(0,) * len(ct.KERNELS)] if variant == "tpu" else
                [tuple(float(v) for v in w) for w in STEP_LAUNCHES[name]])
        assert vecs and set(vecs) <= set(want), (d.name, vecs)
        assert summary["card"].startswith("NVIDIA H100")
        argv = summary["cli_argv"]
        assert argv[:2] == ["--config", ct.RECORDS[name].config]
        assert argv[argv.index("--seed") + 1] == str(summary["seed"])
        seen.add((name, variant))
    assert {(n, "exact") for n in ct.RECORDS} | {("flagship_phash211", "tpu")} <= seen


def test_committed_pooled_reading():
    """The pooled reading of the committed records, as PERF.md states it:
    five records (10k URF at six seeds), Z(CD) -0.222, Z(F,
    reversed) -0.949, three of five d positive, a detectable bias of 0.0278
    CD; the phash211 witness delta +0.0009 with a standard error of 0.0128,
    the phash111 witness -0.0045 with 0.0140."""
    _, out = ct.pooled_reading(ct.collect_runs(ROOT / "runs"))
    assert {n: r["n"] for n, r in out["records"].items()} == {
        "flagship_phash211": 8, "conf_phash111": 6, "conf_phash112": 4,
        "flagship10k_phash": 4, "flagship10k_urf": 6}
    assert out["Z_CD"] == pytest.approx(-0.2222, abs=5e-4)
    assert out["Z_F"] == pytest.approx(-0.9490, abs=5e-4)
    assert out["positive_d"] == 3
    assert out["detectable_bias_CD"] == pytest.approx(0.0278, abs=5e-4)
    assert out["reading"] == "no bias told from the seed spread"
    urf = out["records"]["flagship10k_urf"]
    assert urf["CD"]["z"] == pytest.approx(-1.3468, abs=5e-4)
    assert urf["F"]["z"] == pytest.approx(-1.7769, abs=5e-4)
    w = out["witness"]
    assert set(w) == {"flagship_phash211", "conf_phash111"}
    assert w["flagship_phash211"]["delta"] == pytest.approx(0.0009, abs=5e-5)
    assert w["flagship_phash211"]["se"] == pytest.approx(0.0128, abs=5e-5)
    assert not w["flagship_phash211"]["moves"]
    assert sorted(w["conf_phash111"]["twins"]) == [0, 1, 2, 3]
    assert w["conf_phash111"]["delta"] == pytest.approx(-0.0045, abs=5e-5)
    assert w["conf_phash111"]["se"] == pytest.approx(0.0140, abs=5e-5)
    assert not w["conf_phash111"]["moves"]
