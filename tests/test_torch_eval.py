"""The port's eval meters (lidar4d_tpu_torch.eval) against the JAX package's
on the CPU, on identical seeded arrays.

Tolerances, and why:
  * SSIM, RMSE, MedAE, PSNR, ray-drop accuracy and F1 are the same float64
    numpy code in both packages: `EXACT` (1e-12 relative).
  * LPIPS: the port's convolutions run in float64, the JAX package's in
    float32, so they agree to float32 rounding: `LPIPS_RTOL` (1e-5
    relative; measured <= 3.1e-7).
  * Chamfer distance: both take the same nearest neighbours; the port
    recomputes each squared distance from the coordinate differences, the
    JAX package keeps |x|^2 + |y|^2 - 2 x.y, whose float32 cancellation at
    tens of metres is the whole gap: `CD_RTOL` (1e-5 relative; measured
    <= 4.6e-6). The F-score counts points under a threshold, so it may
    differ by the points whose two distances straddle it; the test counts
    those and allows exactly them.
"""

import numpy as np
import pytest
import torch

from lidar4d_tpu.eval import lpips_jax as jlpips
from lidar4d_tpu.eval import meters as jmeters
from lidar4d_tpu.eval import ssim as jssim
from lidar4d_tpu_torch.eval import lpips as tlpips
from lidar4d_tpu_torch.eval import meters as tmeters
from lidar4d_tpu_torch.eval import ssim as tssim
from torch_threads import limit_under_xdist

limit_under_xdist()

EXACT = 1e-12
LPIPS_RTOL = 1e-5
CD_RTOL = 1e-5
FOV = (2.0, 26.9)
SCALE = 0.01
H, W = 32, 160


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def _frames(seed, n=2, drop=0.2):
    """n (pred, gt) range-image pairs in the eval's units: depth * scale in
    [0.02, 0.6] (2-60 m) with dropped pixels, intensity in [0, 1], a
    ray-drop probability and its 0/1 ground truth."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt_depth = rng.uniform(2.0, 60.0, (H, W)) * SCALE
        gt_depth[rng.uniform(size=(H, W)) < drop] = 0.0
        pred_depth = np.clip(gt_depth + rng.normal(0, 0.3, (H, W)) * SCALE, 0, None)
        pred_depth[rng.uniform(size=(H, W)) < drop / 2] = 0.0
        gt_int = rng.uniform(size=(H, W))
        pred_int = np.clip(gt_int + rng.normal(0, 0.1, (H, W)), 0, 1)
        gt_rd = (gt_depth > 0).astype(np.float32)
        pred_rd = np.clip(gt_rd + rng.normal(0, 0.4, (H, W)), 0, 1)
        out.append({k: v.astype(np.float32) for k, v in dict(
            pred_depth=pred_depth, gt_depth=gt_depth, pred_int=pred_int, gt_int=gt_int,
            pred_rd=pred_rd, gt_rd=gt_rd).items()})
    return out


def test_ssim_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(2, 24, 80))
    for rng_ in (1.0, 0.3):
        assert _rel(tssim.structural_similarity(a, b, rng_),
                    jssim.structural_similarity(a, b, rng_)) <= EXACT
    with pytest.raises(ValueError):
        tssim.structural_similarity(a, b[:, :10], 1.0)


def test_lpips_default_weights_match_jax():
    t, j = tlpips._default_weights(), jlpips._default_weights()
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_lpips_matches_jax(ndim):
    """2-D maps (the reference's 3-channel broadcast), [3, H, W] and
    [B, 3, H, W] images."""
    rng = np.random.default_rng(ndim)
    shape = {2: (H, W), 3: (3, H, W), 4: (2, 3, H, W)}[ndim]
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, shape), 0, 1).astype(np.float32)
    got = tlpips.LPIPS()(a, b)
    want = jlpips.LPIPS()(a, b)
    assert got > 0
    assert _rel(got, want) <= LPIPS_RTOL
    assert tlpips.LPIPS()(a, a) == 0.0


def test_lpips_weights_override(tmp_path, monkeypatch):
    """LIDAR4D_LPIPS_WEIGHTS flips both packages to calibrated mode with
    the same weights."""
    w = {k: v * 1.5 for k, v in jlpips._default_weights(seed=3).items()}
    path = tmp_path / "w.npz"
    np.savez(path, **w)
    assert not tlpips.LPIPS().is_calibrated
    monkeypatch.setenv("LIDAR4D_LPIPS_WEIGHTS", str(path))
    t, j = tlpips.LPIPS(), jlpips.LPIPS()
    assert t.is_calibrated and j.is_calibrated
    rng = np.random.default_rng(5)
    a, b = rng.uniform(size=(2, H, W)).astype(np.float32)
    assert _rel(t(a, b), j(a, b)) <= LPIPS_RTOL


def _meters(pkg, device=None):
    kw = {} if device is None else {"device": device}
    return [pkg.RaydropMeter(ratio=0.5), pkg.IntensityMeter(scale=1.0, **kw),
            pkg.DepthMeter(scale=SCALE, **kw), pkg.PointsMeter(scale=SCALE, intrinsics=FOV, **kw)]


def _feed(meters, f, as_tensor=False):
    def arr(x):
        return torch.from_numpy(x[None]) if as_tensor else x[None]

    mask = (f["pred_rd"] > 0.5).astype(np.float32)
    meters[0].update(arr(f["pred_rd"]), arr(f["gt_rd"]))
    meters[1].update(arr(f["pred_int"] * mask), arr(f["gt_int"] * f["gt_rd"]))
    meters[2].update(arr(f["pred_depth"] * mask), arr(f["gt_depth"]))
    meters[3].update(arr(f["pred_depth"] * mask), arr(f["gt_depth"]))


def _fscore_band(f):
    """How many points of each cloud have exact squared distances within
    float32 cancellation noise of the F-score threshold (0.05)."""
    from scipy.spatial import cKDTree

    mask = (f["pred_rd"] > 0.5).astype(np.float32)
    p = tmeters.pano_to_lidar(f["pred_depth"] * mask / SCALE, FOV).astype(np.float64)
    g = tmeters.pano_to_lidar(f["gt_depth"] / SCALE, FOV).astype(np.float64)
    eps = np.finfo(np.float32).eps
    out = []
    for a, b in ((p, g), (g, p)):
        d = cKDTree(b).query(a)[0] ** 2
        # |a|^2 + |b|^2 - 2 a.b: about four roundings of terms of size |a|^2
        noise = 4 * eps * 2 * np.sum(a * a, axis=1)
        out.append(np.sum(np.abs(d - 0.05) < noise) / len(d))
    return out


@pytest.mark.parametrize("as_tensor", [False, True])
def test_meters_match_jax(as_tensor):
    """The four meters over two frames, in the trainer's order and masking:
    every measured value, the reports' LPIPS note and the calibration flag."""
    frames = _frames(0)
    t, j = _meters(tmeters, "cpu"), _meters(jmeters)
    for f in frames:
        _feed(t, f, as_tensor)
        _feed(j, f)
    for k, (tm, jm) in enumerate(zip(t, j)):
        assert tm.N == jm.N == 2
        got, want = tm.measure(), jm.measure()
        assert got.shape == want.shape
        if k in (1, 2):
            # RMSE, MedAE, SSIM, PSNR exact; LPIPS (column 2) to float32 rounding
            assert _rel(np.delete(got, 2), np.delete(want, 2)) <= EXACT
            assert _rel(got[2], want[2]) <= LPIPS_RTOL
            assert tm.lpips_calibrated == jm.lpips_calibrated is False
            assert tm._lpips_note() == jm._lpips_note()
        elif k == 0:
            assert _rel(got, want) <= EXACT
        else:
            assert _rel(got[0], want[0]) <= CD_RTOL
            band = sum(max(_fscore_band(f)) for f in frames) / len(frames)
            assert abs(got[1] - want[1]) <= 2 * band + EXACT
        assert tm.report().split("=")[0] == jm.report().split("=")[0]


def test_points_meter_unequal_and_empty_clouds():
    """Clouds of different sizes (more pixels dropped in the prediction) and
    an empty prediction, which scores [inf, 0] in both packages."""
    f = _frames(1, n=1, drop=0.5)[0]
    pred = f["pred_depth"].copy()
    pred[:, : W // 2] = 0.0
    t, j = tmeters.PointsMeter(SCALE, FOV), jmeters.PointsMeter(SCALE, FOV)
    for m in (t, j):
        m.update(pred[None], f["gt_depth"][None])
        m.update(np.zeros_like(pred)[None], f["gt_depth"][None])
    assert np.count_nonzero(pred) < 0.75 * np.count_nonzero(f["gt_depth"])
    assert t.V[1] == j.V[1] == [np.inf, 0.0]
    assert _rel(t.V[0][0], j.V[0][0]) <= CD_RTOL
    assert abs(t.V[0][1] - j.V[0][1]) <= 2 * max(_fscore_band(dict(
        f, pred_depth=pred, pred_rd=np.ones_like(pred)))) + EXACT
    t.clear()
    assert t.N == 0 and t.V == []


def test_fscore_and_squared_distances():
    rng = np.random.default_rng(2)
    d1, d2 = rng.uniform(0, 0.1, (2, 1, 50))
    for a, b in zip(tmeters.fscore(d1, d2, 0.05), jmeters.fscore(d1, d2, 0.05)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmeters.fscore(d1 + 1, d2 + 1, 0.05)[0], [0.0])
    x = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    np.testing.assert_allclose(tmeters.squared_distances(x, y).numpy(),
                               ((x.double() - y.double()) ** 2).sum(-1).numpy(), rtol=1e-6)
