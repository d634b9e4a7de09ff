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


def _jax_records():
    return ct.read_jsonl(ct.JAX_RECORD / "metrics_lidar4d.jsonl")


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
    assert float(ct.config_values()["scale"]) == 0.01006991432868821


def test_write_scene_tiny(tmp_path, monkeypatch):
    """Written once with its meta.json, read back the second time without
    writing, and refused when its scale is not the config's."""
    from lidar4d_tpu_torch.data import synthetic

    scale, offset = synthetic.generate_synthetic_sequence(str(tmp_path / "ref"), **TINY_SCENE)
    got = ct.write_scene(tmp_path / "scene", TINY_SCENE, want_scale=scale)
    assert got[:2] == (scale, offset)
    assert (tmp_path / "scene" / "transforms_9000_train.json").exists()
    assert json.loads((tmp_path / "scene" / "meta.json").read_text())["scene"] == TINY_SCENE

    def refuse(*a, **k):
        raise AssertionError("the scene was written again")

    monkeypatch.setattr(synthetic, "generate_synthetic_sequence", refuse)
    assert ct.write_scene(tmp_path / "scene", TINY_SCENE, want_scale=scale)[:2] == (scale, offset)
    with pytest.raises(ValueError, match="config scale"):
        ct.write_scene(tmp_path / "scene", TINY_SCENE, want_scale=scale * (1 + 1e-5))


def test_jax_record_reads_and_meets_its_own_checks():
    """The JAX record through the script's readers: its parameter count,
    schedule, refine BCE (log_lidar4d.txt:88-107) and the band."""
    checks, fails = ct.check_record(ct.JAX_RECORD)
    assert all(checks.values()), checks
    assert fails == []
    n_params, bce = ct.read_log(ct.JAX_RECORD / "log_lidar4d.txt")
    assert n_params == ct.N_PARAMS
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
    assert ct.band_failures(rows) == miss


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

    checks, fails = ct.report(rec)
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
    checks, fails = ct.check_record(_write_record(tmp_path / "short", short, log[:5]))
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
    checks, fails = ct.check_record(rec)
    assert all(checks.values()), checks
    args = dict(line.split(" = ", 1) for line in (rec / "args.txt").read_text().splitlines())
    assert (args["config"], args["seed"], args["dataloader"]) == (ct.CONFIG, str(seed),
                                                                  "synthetic")
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
        checks, _ = ct.check_record(rec)
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
        assert f"--config {ct.CONFIG} " in cli and cli.endswith(f"--seed {seed} --train_only")
