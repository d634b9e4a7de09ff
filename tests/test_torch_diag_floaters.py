"""scripts/diag_floaters_torch.py on the CPU: its bucket statistics equal
the JAX script's (`scripts/diag_floaters.py`, whose helpers are numpy only
and are imported by path), and the whole script on a seeded field of
configs/synthetic_smoke.txt writes the schema of the JAX package's
committed `runs/flagship10k_phash/diag_summary_ep54.json`."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from torch_threads import limit_under_xdist

limit_under_xdist()

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dft = _load("diag_floaters_torch")
dfj = _load("diag_floaters")


@pytest.mark.parametrize("n", [0, 1, 57, 4000])
def test_bucket_stats_are_the_jax_scripts(n):
    """The same distances and rows give the same bucket, every key equal
    (the empty bucket included), and the same pixel indices of a pano."""
    rng = np.random.default_rng(n)
    dists = rng.gamma(0.5, 0.2, n).astype(np.float32)
    rows = rng.integers(0, 66, n)
    assert dft.bucket_stats(dists, rows, 66, "b") == dfj.bucket_stats(dists, rows, 66, "b")
    pano = np.where(rng.random((8, 16)) < 0.5, rng.random((8, 16)), 0.0)
    for a, b in zip(dft.pano_pixel_indices(pano), dfj.pano_pixel_indices(pano)):
        np.testing.assert_array_equal(a, b)


def _keys(d):
    return sorted(d.keys())


def test_whole_script_writes_the_jax_schema(tmp_path, monkeypatch):
    """The script on the CPU, a seeded (untrained) field of the smoke config
    on its scene: every frame record, bucket and the summary carry the JAX
    record's keys, in the same bucket order, with finite numbers. An
    untrained field drops every ray, so its rendered ray-drop logits are
    lifted to keep every return (its depth stays the render's)."""
    from lidar4d_tpu_torch.cli.config import _parse_config_txt
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
    from lidar4d_tpu_torch.train.trainer import Trainer

    render = Trainer._render_frame

    def every_ray_returns(self, params, dataset, i):
        raydrop, intensity, depth = render(self, params, dataset, i)
        return np.full_like(raydrop, 4.0), intensity, depth

    monkeypatch.setattr(Trainer, "_render_frame", every_ray_returns)

    cfg = _parse_config_txt(ROOT / "configs" / "synthetic_smoke.txt")
    scene = tmp_path / "scene"
    generate_synthetic_sequence(str(scene), sequence_id=str(cfg["sequence_id"]),
                                num_frames=int(cfg["num_frames"]), H=int(cfg["synthetic_H"]),
                                W=int(cfg["synthetic_W"]), seed=int(cfg["synthetic_seed"]))
    out = tmp_path / "summary.json"
    summary = dft.main(["--config", str(ROOT / "configs" / "synthetic_smoke.txt"),
                        "--workspace", str(tmp_path / "ws"), "--path", str(scene),
                        "--device", "cpu", "--ckpt", "scratch", "--out", str(out)])
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "runs" / "flagship10k_phash" / "diag_summary_ep54.json")
                      .read_text())
    assert _keys(got) == _keys(want) == ["frames", "summary"]
    assert _keys(got["summary"]) == _keys(want["summary"]) and got["summary"] == summary
    assert got["summary"]["frames"] == len(got["frames"]) > 0
    for frame in got["frames"]:
        assert _keys(frame) == _keys(want["frames"][0])
        assert [b["label"] for b in frame["buckets"]] == [
            b["label"] for b in want["frames"][0]["buckets"]]
        for b, wb in zip(frame["buckets"], want["frames"][0]["buckets"]):
            assert _keys(b) == _keys(wb) or (b["n_points"] == 0 and _keys(b) == [
                "label", "mean", "n_points", "sum"])
        assert np.isfinite([frame["cd"], frame["cd_pred_side"], frame["cd_gt_side"]]).all()
        assert frame["cd"] == pytest.approx(frame["cd_pred_side"] + frame["cd_gt_side"])
    assert (tmp_path / "diag_maps" / "err_pred_0000.npy").exists()
