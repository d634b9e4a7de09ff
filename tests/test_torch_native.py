"""The port's native host extension (`lidar4d_tpu_torch.native`) on the CPU:
against the port's numpy paths, and against the JAX package's native
library, which is the same source built by the same compiler with the same
flags, so the two must agree bit for bit.

The native kNN outlier mask works on float32 coordinates and sums each
point's neighbour distances in heap order, where the cKDTree path works in
float64 and sums them sorted; the kept sets could part only for a point
within rounding of the threshold. On every cloud here (the synthetic
scene's point_removal inputs, a Gaussian cloud with outliers, the same cloud
duplicated, an integer lattice with stray points, whose distances tie) they
are equal: 0 points differ, and the test holds that.
"""

import functools

import numpy as np
import pytest

from lidar4d_tpu import native as jnative
from lidar4d_tpu_torch import native
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
from lidar4d_tpu_torch.ops.pano import lidar_to_pano_with_intensities, pano_to_lidar
from lidar4d_tpu_torch.utils import pointcloud as tpc

FOV = (2.0, 26.9)


def _scan(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.radians(-24.9), np.radians(2.0), n)
    r = rng.uniform(2, 90, n)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = r * np.cos(el) * np.cos(az)
    pts[:, 1] = r * np.cos(el) * np.sin(az)
    pts[:, 2] = r * np.sin(el)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    return jnative


def test_native_pano_matches_numpy():
    pts = _scan()
    for H, W in ((22, 103), (66, 1030)):
        want = lidar_to_pano_with_intensities(pts, H, W, FOV)
        got = native.lidar_to_pano_native(pts, H, W, *FOV)
        for a, b in zip(got, want):
            assert a.shape == (H, W) and a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_native_matches_jax_native_bitwise(jax_native):
    pts = _scan(seed=2)
    for got, want in zip(native.lidar_to_pano_native(pts, 66, 1030, *FOV),
                         jax_native.lidar_to_pano_native(pts, 66, 1030, *FOV)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    cloud = rng.normal(size=(3000, 3)).astype(np.float32)
    cloud[:20] *= 10
    for k, ratio in ((16, 2.0), (64, 3.0)):
        np.testing.assert_array_equal(native.knn_outlier_mask_native(cloud, k, ratio),
                                      jax_native.knn_outlier_mask_native(cloud, k, ratio))


def _clouds():
    """(name, points, k, std_ratio) for the kept-set comparison."""
    rng = np.random.default_rng(1)
    gauss = rng.normal(size=(3000, 3))
    gauss[:20] *= 10                                  # clear outliers
    lattice = np.stack(np.meshgrid(*[np.arange(14.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lattice = np.concatenate([lattice, rng.uniform(-20, 34, size=(30, 3))])
    return [("gaussian", gauss, 16, 2.0), ("gaussian k64", gauss, 64, 3.0),
            ("duplicated", np.concatenate([gauss, gauss]), 16, 2.0),
            ("lattice", lattice, 16, 2.0), ("lattice k64", lattice, 64, 3.0)]


@pytest.fixture(scope="module")
def scene_inputs(tmp_path_factory):
    """point_removal's first outlier-removal input for each frame of a small
    synthetic scene, as the flow cache builds it."""
    root = str(tmp_path_factory.mktemp("scene"))
    scale, offset = generate_synthetic_sequence(root, sequence_id="9000", num_frames=4,
                                                H=32, W=256, seed=0)
    ds = KITTI360Dataset(split="refine", root_path=root, sequence_id="9000", scale=scale,
                         offset=offset)
    out = []
    for img in ds.images_lidar:
        cloud = pano_to_lidar(np.asarray(img[..., 2] * img[..., 0], np.float64) / scale,
                              ds.intrinsics_lidar)
        out.append(tpc.range_filter(cloud)[:, :3])
    return out


def _differ(a, b):
    return len({tuple(p) for p in a} ^ {tuple(p) for p in b})


@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in _clouds()])
def test_native_knn_keeps_ckdtree_set(case):
    _, pts, k, ratio = _clouds()[case]
    got = tpc.statistical_outlier_removal(pts, k, ratio, use_native=True)
    want = tpc.statistical_outlier_removal(pts, k, ratio)
    assert len(want) < len(pts)
    assert _differ(got, want) == 0
    np.testing.assert_array_equal(got, want)


def test_native_knn_keeps_ckdtree_set_on_scene(scene_inputs):
    for pts in scene_inputs:
        assert len(pts) > 6000
        got = tpc.statistical_outlier_removal(pts, use_native=True)
        want = tpc.statistical_outlier_removal(pts)
        assert len(want) < len(pts)
        assert _differ(got, want) == 0
        np.testing.assert_array_equal(got, want)


def test_failed_build_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="cannot run /nonexistent/g\\+\\+"):
        native.build(compiler="/nonexistent/g++")
    with pytest.raises(RuntimeError, match="false failed"):
        native.build(compiler="false")
    assert native.library_path("false") != native.library_path()
    assert not native.library_path("false").exists()

    # use_native=True gets the native kNN or the error, never cKDTree
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", functools.partial(native.build, compiler="false"))
    pts = np.random.default_rng(0).normal(size=(200, 3))
    with pytest.raises(RuntimeError, match="false failed"):
        tpc.statistical_outlier_removal(pts, 16, 2.0, use_native=True)
    assert len(tpc.statistical_outlier_removal(pts, 16, 2.0)) > 0    # default: no native call


def test_native_input_checks():
    with pytest.raises(ValueError):
        native.knn_outlier_mask_native(np.zeros((10,)), 4)
    with pytest.raises(ValueError):
        native.lidar_to_pano_native(np.zeros((10, 3), np.float32), 4, 8, *FOV)
    with pytest.raises(ValueError):
        native.lidar_to_pano_native(np.zeros((10, 4), np.float32), 0, 8, *FOV)
