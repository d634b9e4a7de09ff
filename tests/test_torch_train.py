"""The port's training slice (lidar4d_tpu_torch.train, data, ops.rays /
chamfer / pano, utils.pointcloud) against the JAX package on the CPU.

The slice test runs one `make_train_step` step of each package on a tiny
field and a tiny synthetic scene from the same parameters (carried over by
`interop`), the same flow cache and the JAX step's own random draws
(`jax.random.split` of its key, fed to the port as `draws`), and compares
the loss, every metric, every gradient leaf and the post-step parameters;
with hierarchical sampling at patch 1, and (float32) at the trainer's other
step variants: 2 x 8 patches with the gradient loss, the uniform sampler.

Tolerances, and why:
  * bfloat16 MLPs (both packages' default): the two frameworks round the
    bf16 matmuls at different places, and the JAX dynamic planes run a bf16
    one-hot matmul where the port lerps in float32, so losses agree to
    `BF16_TOL` (the field tests' 3e-2 of scale; measured <= 9e-5) and
    gradients to `BF16_GRAD_TOL` of each leaf's largest magnitude (measured
    <= 3.7e-2). The flow net's leaves get `BF16_FLOW_GRAD_TOL` (measured
    <= 0.121): their only gradient path is the dynamic planes' coordinate
    derivative, which the reference takes through its bf16 tent matmul,
    and the bf16 flow MLP. Both are about 2x the measured gaps, which are
    the same on every run of this CPU test.
  * float32 MLPs and the JAX `plane_linear` swapped for an explicit float32
    lerp: the algorithms agree to float32 rounding: `F32_TOL` for the
    losses (measured <= 2.6e-7) and `F32_GRAD_TOL` for the gradients
    (measured <= 5.7e-6), except the attribute heads (intensity, ray-drop
    MLPs) at `F32_ATTR_GRAD_TOL` (measured <= 1.1e-3, with the uniform
    sampler): the renderer keeps a
    sample's attributes only where its weight exceeds 1e-4, and a weight
    that float32 rounding places on the other side of that threshold adds
    or removes the sample's whole contribution. About 10x the gaps.
  * The line-of-sight (URF) loss term: `F32_URF_TOL` (measured 6.0e-6 at
    step / iters = 0.45, 1.7e-7 at step 0; its gradients stay within the
    tolerances above). Both packages' `_urf_loss` agree to ~1e-7 on the
    same inputs (`test_gradient_and_urf_losses_match_jax`); the step's z samples do
    not: torch's `linspace` and sequential `cumsum` (sample_pdf) round
    differently from XLA's (a reciprocal multiply; on the CPU an
    associative scan, on the TPU a windowed sum), up to 4.2e-7 in z, and
    the loss's band Gaussian, sigma = eps / 3 = 2.4e-3 once eps has
    decayed, multiplies a z difference by ~d / sigma^2. With the port's
    z_vals swapped into the JAX loss the two agree again. About 10x the
    gap.
  * Post-step parameters: Adam's first step moves a leaf by lr * mult *
    g / (|g| + 1e-15), i.e. by lr * mult * sign(g), so a gradient entry
    whose size is within the gradient tolerance may flip sign. Post-step
    parameters are compared where the reference's |g| exceeds
    `SIGN_FLOOR` x the gradient tolerance x the leaf's largest |g|; every
    other entry must still have moved by at most lr * mult.
"""

import functools
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu.models.planes_field as jplanes_mod
import lidar4d_tpu.ops.hash_onehot as jho
import lidar4d_tpu_torch.models.flow_field as tflow_mod
import lidar4d_tpu_torch.models.hash_field as thash_mod
import lidar4d_tpu_torch.models.lidar4d as tlidar_mod
import lidar4d_tpu_torch.ops.hash_onehot as tho
from lidar4d_tpu import native as jnative
from lidar4d_tpu.data import kitti360 as jkitti
from lidar4d_tpu.data import synthetic as jsynth
from lidar4d_tpu.models import lidar4d as jl
from lidar4d_tpu.models import renderer as jr
from lidar4d_tpu.ops import chamfer as jch
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.ops import pano as jpano
from lidar4d_tpu.ops import rays as jrays
from lidar4d_tpu.ops.trunc_exp import trunc_exp as jtrunc_exp
from lidar4d_tpu.train import ema as jema
from lidar4d_tpu.train import flow_cache as jfc
from lidar4d_tpu.train import losses as jlosses
from lidar4d_tpu.train import optimizer as jopt
from lidar4d_tpu.train import train_step as jts
from lidar4d_tpu.utils import pointcloud as jpc
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.models import renderer as tr
from lidar4d_tpu_torch.ops import chamfer as tch
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.ops import pano as tpano
from lidar4d_tpu_torch.ops import rays as trays
from lidar4d_tpu_torch.ops.trunc_exp import trunc_exp as ttrunc_exp
from lidar4d_tpu_torch.train import ema as tema
from lidar4d_tpu_torch.train import flow_cache as tfc
from lidar4d_tpu_torch.train import losses as tlosses
from lidar4d_tpu_torch.train import optimizer as topt
from lidar4d_tpu_torch.train import train_step as tts
from lidar4d_tpu_torch.utils import pointcloud as tpc
from torch_threads import limit_under_xdist

limit_under_xdist()

H, W, FRAMES, SEQ = 16, 64, 6, "9000"
FOV = (2.0, 26.9)
RAYS, COARSE, FINE = 64, 8, 16
LR, ITERS = 1e-2, 100
TINY = dict(
    base_resolution=8, max_resolution=32, log2_hashmap_size=8, n_levels_hash=2,
    n_features_per_level_hash=8, hash_size_dynamic=(8, 7, 7), n_levels_plane=2,
    min_resolution=8, time_resolution=4, num_frames=FRAMES, flow_n_levels=2,
    flow_n_features=8, flow_log2_hashmap_size=8, flow_base_resolution=8,
    flow_max_resolution=16, plane_hash_scales=1, plane_hash_log2=7,
)
BF16_TOL = 3e-2
BF16_GRAD_TOL = 6e-2
BF16_FLOW_GRAD_TOL = 0.25
F32_TOL = 3e-6
F32_GRAD_TOL = 6e-5
F32_ATTR_GRAD_TOL = 1e-2
F32_URF_TOL = 6e-5
SIGN_FLOOR = 10


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3e} of scale {scale:.3e} > {tol}"
    return err


# ------------------------------------------------------------------ scene
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene written by both packages (the port's copy must
    write the same files), its datasets and a flow cache."""
    roots = [str(tmp_path_factory.mktemp(k)) for k in ("t", "j")]
    kw = dict(sequence_id=SEQ, num_frames=FRAMES, H=H, W=W, val_every=3)
    scale, offset = tsynth.generate_synthetic_sequence(roots[0], **kw)
    assert (scale, offset) == jsynth.generate_synthetic_sequence(roots[1], **kw)
    dk = dict(root_path=roots[0], sequence_id=SEQ, scale=scale, offset=offset)
    ds = tkitti.KITTI360Dataset(split="train", **dk)
    refine = tkitti.KITTI360Dataset(split="refine", **dk)
    random.seed(0)
    cache = tfc.build_flow_cache(refine, scale, FRAMES)
    return dict(roots=roots, scale=scale, offset=offset, ds=ds, refine=refine, cache=cache)


def test_synthetic_scene_and_dataset_match_jax(scene):
    import filecmp
    import os

    t_root, j_root = scene["roots"]
    names = sorted(os.listdir(os.path.join(t_root, "train")))
    assert names == sorted(os.listdir(os.path.join(j_root, "train")))
    for name in names:
        np.testing.assert_array_equal(np.load(os.path.join(t_root, "train", name)),
                                      np.load(os.path.join(j_root, "train", name)))
    for split in ("train", "val", "test"):
        f = f"transforms_{SEQ}_{split}.json"
        assert filecmp.cmp(os.path.join(t_root, f), os.path.join(j_root, f), shallow=False)
    for split in ("train", "refine", "val"):
        kw = dict(split=split, root_path=t_root, sequence_id=SEQ, scale=scene["scale"],
                  offset=scene["offset"])
        a, b = tkitti.KITTI360Dataset(**kw), jkitti.KITTI360Dataset(**kw)
        for k in ("poses_lidar", "images_lidar", "times", "frame_ids"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.num_frames_total() == b.num_frames_total()
        np.testing.assert_array_equal(a.epoch_order(np.random.default_rng(3)),
                                      b.epoch_order(np.random.default_rng(3)))


@pytest.mark.parametrize("max_points", [0, 128])
def test_flow_cache_matches_jax(scene, monkeypatch, max_points):
    """The same RANSAC seeds and the reference's cKDTree outlier path (the
    port's default): equal arrays."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    random.seed(0)
    got = tfc.build_flow_cache(scene["refine"], scene["scale"], FRAMES, max_points=max_points)
    random.seed(0)
    want = jfc.build_flow_cache(scene["refine"], scene["scale"], FRAMES, max_points=max_points)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flow_cache_frames_subset(scene):
    random.seed(0)
    full = tfc.build_flow_cache(scene["refine"], scene["scale"], FRAMES)
    random.seed(0)
    part = tfc.build_flow_cache(scene["refine"], scene["scale"], FRAMES, frames={0, 1})
    np.testing.assert_array_equal(part["valid"], [1, 1, 0, 0, 0, 0])
    n = int(part["mask"][0].sum())
    np.testing.assert_array_equal(part["points"][0, :n], full["points"][0, :n])
    assert part["mask"][2:].sum() == 0


def test_pointcloud_and_pano_match_jax():
    """The port's cKDTree query runs on every core (workers=-1): the same kept
    set, bit for bit, as the JAX package's one-worker query, on a small cloud
    and on one large enough to be split between the workers."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)) * [20.0, 20.0, 1.0]
    pts[:20] *= 30.0                                            # outliers
    big = np.random.default_rng(1).normal(size=(60_000, 3)) * [20.0, 20.0, 1.0]
    big[:20] *= 30.0
    for cloud, k, ratio in ((pts, 16, 2.0), (big, 16, 2.0), (big, 64, 3.0)):
        np.testing.assert_array_equal(
            tpc.statistical_outlier_removal(cloud, k, ratio),
            jpc.statistical_outlier_removal(cloud, k, ratio, use_native=False))
    np.testing.assert_array_equal(tpc.range_filter(pts), jpc.range_filter(pts))
    cloud = np.concatenate([pts, rng.uniform(size=(700, 1))], axis=1)
    for fn in ("lidar_to_pano_with_intensities",):
        for a, b in zip(getattr(tpano, fn)(cloud, 16, 64, FOV), getattr(jpano, fn)(cloud, 16, 64, FOV)):
            np.testing.assert_array_equal(a, b)
    pano = tpano.lidar_to_pano(pts, 16, 64, FOV)
    np.testing.assert_array_equal(pano, jpano.lidar_to_pano(pts, 16, 64, FOV))
    np.testing.assert_array_equal(tpano.pano_to_lidar(pano, FOV), jpano.pano_to_lidar(pano, FOV))


# ------------------------------------------------------------------- rays
@pytest.mark.parametrize("patch", [1, (2, 4)])
def test_get_lidar_rays_matches_jax(patch):
    rng = np.random.default_rng(1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    want = jrays.get_lidar_rays(jnp.asarray(pose), FOV, H, W, key=jax.random.PRNGKey(2), N=64,
                                patch_size=patch)
    got = trays.get_lidar_rays(torch.from_numpy(pose), FOV, H, W, N=64, patch_size=patch,
                               inds=np.asarray(want["inds"]))
    np.testing.assert_array_equal(got["inds"].numpy(), np.asarray(want["inds"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    full = trays.get_lidar_rays(torch.from_numpy(pose), FOV, H, W)
    jfull = jrays.get_lidar_rays(jnp.asarray(pose), FOV, H, W)
    np.testing.assert_allclose(full["rays_d"].numpy(), np.asarray(jfull["rays_d"]), atol=1e-6)
    # the port's own draws: in range, patches wrap in W
    g = torch.Generator()
    g.manual_seed(0)
    inds = trays.sample_ray_indices(H, W, 64, patch, g)
    px, py = (1, 1) if patch == 1 else patch
    assert inds.shape == (64 // (px * py) * (px * py),)
    assert 0 <= int(inds.min()) and int(inds.max()) < H * W


# ---------------------------------------------------------------- chamfer
@pytest.mark.parametrize("pad", [0, 37])
def test_chamfer_matches_jax(pad):
    """Distances, indices and gradients (the custom backward) of the exact
    float32 chamfer; the clouds span several of the port's 2048-point tiles
    and carry sentinel padding."""
    rng = np.random.default_rng(pad)
    x = rng.normal(size=(2, 2500, 3)).astype(np.float32)
    y = rng.normal(size=(2, 2100, 3)).astype(np.float32)
    if pad:
        x[:, -pad:] = tch._PAD_SENTINEL
        y[:, -pad:] = tch._PAD_SENTINEL
    w1 = rng.uniform(size=(2, 2500)).astype(np.float32)
    w2 = rng.uniform(size=(2, 2100)).astype(np.float32)
    if pad:
        w1[:, -pad:] = 0.0
        w2[:, -pad:] = 0.0
    jd1, jd2, ji1, ji2 = jch.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    d1, d2, i1, i2 = tch.chamfer_distance(tx, ty)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    valid = slice(None, x.shape[1] - pad)
    np.testing.assert_allclose(d1.detach().numpy()[:, valid], np.asarray(jd1)[:, valid],
                               rtol=1e-4, atol=1e-5)
    (torch.sum(d1 * torch.from_numpy(w1)) + torch.sum(d2 * torch.from_numpy(w2))).backward()
    jgx, jgy = jax.grad(lambda a, b: jnp.sum(jch.chamfer_distance(a, b)[0] * w1)
                        + jnp.sum(jch.chamfer_distance(a, b)[1] * w2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), rtol=1e-5, atol=1e-5)
    xm = torch.from_numpy((w1 > 0).astype(np.float32))
    ym = torch.from_numpy((w2 > 0).astype(np.float32))
    np.testing.assert_allclose(
        float(tch.chamfer_loss(tx.detach(), ty.detach(), xm, ym)),
        float(jch.chamfer_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xm.numpy()),
                               jnp.asarray(ym.numpy()))), rtol=1e-5)
    padded, count = tch.pad_cloud(torch.from_numpy(x[0, :10]), 16)
    jpadded, jcount = jch.pad_cloud(jnp.asarray(x[0, :10]), 16)
    assert count == jcount
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))


# ----------------------------------------------------------------- losses
def test_losses_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 33)).astype(np.float32)
    b = rng.uniform(size=(5, 33)).astype(np.float32)
    for name in ("l1", "mse", "bce", "huber", "cos"):
        got = tlosses.elementwise_loss(name, 0.3)(torch.from_numpy(a), torch.from_numpy(b))
        want = jlosses.elementwise_loss(name, 0.3)(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(tlosses.bce(torch.from_numpy(b), torch.from_numpy(b)).numpy(),
                               np.asarray(jlosses.bce(jnp.asarray(b), jnp.asarray(b))),
                               rtol=1e-6)
    img = rng.normal(size=(3, 1, 4, 6)).astype(np.float32)
    for tk, jk in zip(tlosses.sobel_kernels(), jlosses.sobel_kernels()):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_allclose(tlosses.conv2d_same(torch.from_numpy(img), tk).numpy(),
                                   np.asarray(jlosses.conv2d_same(jnp.asarray(img), jk)),
                                   rtol=1e-6, atol=1e-6)
    assert tlosses.LossConfig() == tlosses.LossConfig(**vars(jlosses.LossConfig()))
    with pytest.raises(ValueError):
        tlosses.elementwise_loss("l3")


def test_gradient_and_urf_losses_match_jax():
    rng = np.random.default_rng(5)
    cfg = dict(scale=0.5, iters=10)
    pd = rng.uniform(0.1, 1, (2 * 4 * 4,)).astype(np.float32)
    gt = (pd + rng.normal(size=pd.shape) * 0.002).astype(np.float32)
    rd = (rng.uniform(size=pd.shape) > 0.2).astype(np.float32)
    for extra in (dict(), dict(sobel_grad=True, tv_loss=True), dict(depth_grad_loss="cos",
                  grad_norm_smooth=True, spatial_smooth=True)):
        tc, jc = tlosses.LossConfig(**cfg, **extra), jlosses.LossConfig(**cfg, **extra)
        got = tts._gradient_loss(*map(torch.from_numpy, (pd, gt, rd)), tc, 4, 4)
        want = jts._gradient_loss(*map(jnp.asarray, (pd, gt, rd)), jc, 4, 4)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=str(extra))
    w = rng.uniform(size=(6, 10)).astype(np.float32)
    z = np.sort(rng.uniform(0, 1, (6, 10)), -1).astype(np.float32)
    g = rng.uniform(0, 1, (6,)).astype(np.float32)
    got = tts._urf_loss(torch.from_numpy(w), torch.from_numpy(z), torch.from_numpy(g), 3,
                        tlosses.LossConfig(**cfg))
    want = jts._urf_loss(jnp.asarray(w), jnp.asarray(z), jnp.asarray(g), 3,
                         jlosses.LossConfig(**cfg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_trunc_exp_gradient_matches_jax():
    z = np.linspace(-30, 30, 41).astype(np.float32)
    t = torch.from_numpy(z).requires_grad_()
    ttrunc_exp(t).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jtrunc_exp(a)))(jnp.asarray(z))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------- optimizer, ema
def _small_tree(rng):
    return {"hash": {"static": rng.normal(size=(7, 2)).astype(np.float32)},
            "sigma": [rng.normal(size=(3, 4)).astype(np.float32)],
            "unet": {"w": rng.normal(size=(2, 2)).astype(np.float32)}}


def test_grouped_adam_matches_optax_over_3_steps():
    rng = np.random.default_rng(6)
    params = _small_tree(rng)
    labels = {"hash": {"static": "base"}, "sigma": ["head"], "unet": {"w": "unet"}}
    jo = jopt.make_optimizer(LR, 5, labels)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jo.init(jp)
    tp = interop.tree_to_torch(params, "cpu")
    to = topt.make_optimizer(LR, 5, labels)
    ts = to.init(tp)
    assert len(ts.mu) == 2                                        # no state for the U-Net
    for k in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -k,
                             params)
        u, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, u)
        to.step(tp, [torch.from_numpy(g) for g in interop.tree_leaves(grads)], ts)
        for a, b in zip(interop.tree_leaves(interop.tree_to_numpy(tp)), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp["unet"]["w"].numpy(), params["unet"]["w"])
    assert ts.count == 3
    np.testing.assert_allclose(topt.lr_schedule(LR, 5, 3), float(jopt.lr_schedule(LR, 5)(3)),
                               rtol=1e-7)
    with pytest.raises(ValueError):
        topt.make_optimizer(LR, 5, {"a": "bas"})


def test_ema_matches_jax():
    rng = np.random.default_rng(7)
    params = _small_tree(rng)
    js, ts = jema.ema_init(jax.tree.map(jnp.asarray, params)), tema.ema_init(
        interop.tree_to_torch(params, "cpu"))
    for _ in range(3):
        params = jax.tree.map(lambda a: a + 1.0, params)
        js = jema.ema_update(js, jax.tree.map(jnp.asarray, params))
        ts = tema.ema_update(ts, interop.tree_to_torch(params, "cpu"))
    assert ts.num_updates == int(js.num_updates) == 3
    for a, b in zip(interop.tree_leaves(interop.tree_to_numpy(tema.ema_params(ts))),
                    jax.tree.leaves(jema.ema_params(js))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------- the slice
def _configs(scale):
    kw = dict(TINY, near_lidar=1.0 * scale, far_lidar=81.0 * scale)
    return (jl.LiDAR4DConfig(**kw, remat_density=False, density_chunk=0),
            tl.LiDAR4DConfig(**kw))


@pytest.fixture(scope="module")
def fields(scene):
    jcfg, tcfg = _configs(scene["scale"])
    jf, tf = jl.LiDAR4DField(jcfg), tl.LiDAR4DField(tcfg, device="cpu")
    jparams = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0)))
    # O(0.1-1) hash and flow tables and time planes, so that every encoder
    # moves the loss (the init's U(-1e-4, 1e-4) tables would hide them)
    rng = np.random.default_rng(1)
    for k in jparams["hash"]:
        jparams["hash"][k] = rng.uniform(-0.5, 0.5, jparams["hash"][k].shape).astype(np.float32)
    jparams["flow"]["grid"] = rng.uniform(-0.5, 0.5, jparams["flow"]["grid"].shape).astype(
        np.float32)
    for planes in jparams["planes"]:
        for ci in (2, 4, 5):
            planes[ci] = rng.uniform(0.5, 1.5, planes[ci].shape).astype(np.float32)
    return jf, tf, jparams


def test_param_group_labels_match_jax(fields):
    jf, tf, jparams = fields
    tparams = interop.params_from_jax(tf, jparams)
    got = tf.param_group_labels(tparams)
    want = jf.param_group_labels(jparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)


def _jax_draws(key, patch=1, num_steps=0, num_coarse=COARSE, num_fine=FINE, rays=RAYS):
    """The JAX step's random draws for `key` (train_step.py, renderer.py,
    rays.py): ray indices (uniform pixels, or with patch > 1 overlapped
    patches: rays.py:37-86), the z jitter (coarse, or with num_coarse = 0
    the uniform sampler's num_steps), sample_pdf's u jitter, t_rand."""
    draws = {k: np.array(v) for k, v in _jax_draw_arrays(
        key, patch if isinstance(patch, int) else tuple(patch), num_steps, num_coarse,
        num_fine, rays).items()}
    draws["t_rand"] = float(draws["t_rand"])
    for k in ("z_jitter", "u_jitter"):
        if k in draws:
            draws[k] = torch.from_numpy(draws[k])
    return draws


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_draw_arrays(key, patch, num_steps, num_coarse, num_fine, rays):
    """_jax_draws' arrays, in one compile (the same values as drawn op by op)."""
    k_rays, k_perturb, k_flow = jax.random.split(key, 3)
    px = patch if isinstance(patch, int) else patch[0]
    inds = jrays.get_lidar_rays(jnp.eye(4), FOV, H, W, key=k_rays, N=rays,
                                patch_size=patch if px > 1 else 1)["inds"]
    n = inds.shape[0]
    draws = {"inds": inds, "t_rand": jax.random.uniform(k_flow)}
    if num_coarse > 0:
        k1, k2, _ = jax.random.split(k_perturb, 3)
        draws["z_jitter"] = jax.random.uniform(k1, (n, num_coarse))
        draws["u_jitter"] = jax.random.uniform(k2, (n, num_fine))
    else:
        draws["z_jitter"] = jax.random.uniform(k_perturb, (n, num_steps))
    return draws


def _grad_spy(opt):
    """The reference optimizer, keeping the gradients it was given in its
    state, so the test can read the JAX step's gradients."""
    def init(params):
        return {"inner": opt.init(params), "grads": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        u, s = opt.update(grads, state["inner"], params)
        return u, {"inner": s, "grads": grads}

    return optax.GradientTransformation(init, update)


def _jax_step(jf, jparams, scale, cache, frame, key=7, patch=1, sampling=None, urf_step=None):
    """One JAX `make_train_step` step from `jparams` on `frame` with the
    step's own draws for `key`, at `patch` and `sampling` (the step's
    num_steps / num_coarse / num_fine; default hierarchical COARSE + FINE);
    with `urf_step` the line-of-sight loss on, at that step count (its eps
    decays with step / ITERS). Returns (metrics, gradient leaves, post-step
    parameter leaves), numpy."""
    jloss = jlosses.LossConfig(flow_loss=True, grad_loss=True, scale=scale, num_frames=FRAMES,
                               iters=ITERS, urf_loss=urf_step is not None)
    sampling = sampling or dict(num_coarse=COARSE, num_fine=FINE)
    kw = dict(H=H, W=W, fov_lidar=FOV, num_rays=RAYS, patch_size=patch, **sampling)
    spy = _grad_spy(jopt.make_optimizer(LR, ITERS, jf.param_group_labels(jparams)))
    jp = jax.tree.map(jnp.asarray, jparams)
    # one compile for the whole initial state, not one per leaf and op
    opt_state, ema = jax.jit(lambda p: (spy.init(p), jema.ema_init(p)))(jp)
    jstate = jts.TrainState(params=jp, opt_state=opt_state, ema=ema,
                            step=jnp.int32(urf_step or 0))
    jstep = jts.make_train_step(jf, spy, jloss, **kw)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, frame), jax.tree.map(jnp.asarray, cache),
                       jax.random.PRNGKey(key))
    return ({k: float(v) for k, v in jm.items()},
            [np.asarray(g) for g in jax.tree.leaves(jstate.opt_state["grads"])],
            [np.asarray(p) for p in jax.tree.leaves(jstate.params)])


def _run_both(scene, fields, frame_i=1, key=7, patch=1, sampling=None, jax_result=None,
              urf_step=None):
    """One step of each package from the same params, cache and draws (the
    JAX step's, see `_jax_step`). `jax_result`: the JAX step's result when
    it was computed elsewhere (`jax_steps`). Returns (JAX: metrics, grads,
    params; port: metrics, grads, params)."""
    jf, tf, jparams = fields
    cache = scene["cache"]
    frame = scene["ds"].frame(frame_i)
    if jax_result is None:
        jax_result = _jax_step(jf, jparams, scene["scale"], cache, frame, key, patch, sampling,
                               urf_step)
    sampling = sampling or dict(num_coarse=COARSE, num_fine=FINE)
    kw = dict(H=H, W=W, fov_lidar=FOV, num_rays=RAYS, patch_size=patch, **sampling)

    tstate, topt_ = tts.init_train_state(tf, lr=LR, iters=ITERS,
                                         params=interop.params_from_jax(tf, jparams))
    tloss = tlosses.LossConfig(**vars(jlosses.LossConfig(
        flow_loss=True, grad_loss=True, scale=scene["scale"], num_frames=FRAMES, iters=ITERS,
        urf_loss=urf_step is not None)))
    tstate.step = urf_step or 0
    tstep = tts.make_train_step(tf, topt_, tloss, **kw)
    tcache = tts.flow_cache_to_device(cache, "cpu")
    draws = _jax_draws(jax.random.PRNGKey(key), patch, sampling.get("num_steps", 0),
                       sampling.get("num_coarse", 0), sampling.get("num_fine", 0))
    tgrads, tm = tstep.grads(tstate.params, frame, tcache, draws, tstate.step)
    tstate, tm2 = tstep(tstate, frame, tcache, draws)
    for k in tm:
        assert float(tm2[k]) == float(tm[k]), k
    tg = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
          for g, p in zip(tgrads, interop.tree_leaves(tstate.params))]
    return (*jax_result, {k: float(v) for k, v in tm.items()}, tg,
            interop.tree_leaves(interop.tree_to_numpy(tstate.params)))


# The JAX side of the module's step comparisons (`_jax_step`): its trace and
# compile take ~20 s a step variant on one thread, so JAX_STEP_PROCESSES
# worker processes compute them from the module's first test on, while the
# other tests run; each variant under its own switches, as its test sets
# them: (float32 switches, ONEHOT_VARIANT "classic", patch, sampling, the
# step count of the line-of-sight loss or None without it). The URF cases
# take the 10k URF schedule's two patch modes, one at step / ITERS = 0.45
# (eps decayed as at step 4,469 of 10,000), one at step 0.
JAX_STEPS = {
    "bf16": (False, False, 1, None, None),
    "f32": (True, False, 1, None, None),
    "classic": (True, True, 1, None, None),
    "patch_2x8": (True, False, (2, 8), None, None),
    "uniform": (True, False, 1, dict(num_steps=COARSE + FINE), None),
    "uniform_patch_2x8": (True, False, (2, 8), dict(num_steps=COARSE + FINE), None),
    "urf_decayed": (True, False, 1, None, 45),
    "urf_patch_2x8": (True, False, (2, 8), None, 0),
}
JAX_STEP_PROCESSES = 3
JAX_STEP_TIMEOUT = 900         # s, a variant's wait for its result


def _jax_step_worker(scale, cache, frame, jparams, name):
    """In a worker process: the JAX step `name` under its switches."""
    import conftest  # noqa: F401  (the JAX CPU platform, as in the tests' process)

    f32, classic, patch, sampling, urf_step = JAX_STEPS[name]
    try:
        with pytest.MonkeyPatch.context() as m:
            if f32:
                _f32_everywhere(m)
            if classic:
                m.setattr(jho, "ONEHOT_VARIANT", "classic")
            return _jax_step(jl.LiDAR4DField(_configs(scale)[0]), jparams, scale, cache, frame,
                             patch=patch, sampling=sampling, urf_step=urf_step)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def jax_steps(scene, fields):
    """{variant: the future of its JAX step}, computed by a pool of
    JAX_STEP_PROCESSES spawned workers from the module's first test on; a
    test takes its variant's result with `.result(JAX_STEP_TIMEOUT)`."""
    args = (scene["scale"], scene["cache"], scene["ds"].frame(1), fields[2])
    pool = ProcessPoolExecutor(JAX_STEP_PROCESSES, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield {name: pool.submit(_jax_step_worker, *args, name) for name in JAX_STEPS}
    finally:
        pool.shutdown(cancel_futures=True)


def _check_step(result, jparams, labels, tol, grad_tols, urf=False):
    """grad_tols: gradient tolerance by top-level parameter group, with a
    default under None; `urf`: the case asked for the line-of-sight loss
    (its term at F32_URF_TOL, every other metric at `tol`)."""
    jm, jg, jp, tm, tg, tp = result
    assert sorted(tm) == sorted(jm)
    assert set(tm) - {"grad_loss"} == {"chamfer_loss", "flow_loss", "lidar_loss", "loss",
                                       *(["urf_loss"] if urf else [])}
    for k in jm:
        assert np.isfinite(tm[k])
        _close(tm[k], jm[k], F32_URF_TOL if k == "urf_loss" else tol, k)
    p0 = jax.tree.leaves(jparams)
    groups = [path[0].key for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    live = 0
    for i, (g_t, g_j, p_t, p_j, p_init, lb, group) in enumerate(
            zip(tg, jg, tp, jp, p0, labels, groups)):
        grad_tol = grad_tols.get(group, grad_tols[None])
        assert np.isfinite(g_t).all(), f"leaf {i}"
        if lb == "unet":
            assert not g_j.any() and not g_t.any()
            np.testing.assert_array_equal(p_t, p_init)
            continue
        scale = float(np.abs(g_j).max())
        if scale == 0.0:
            assert not g_t.any(), f"leaf {i}"
            continue
        live += 1
        _close(g_t, g_j, grad_tol, f"grad leaf {i} ({group})")
        # post-step params: lr * mult * sign(g) where |g| is clear of the tolerance
        step = LR * (0.1 if lb == "head" else 1.0)
        sure = np.abs(g_j) > SIGN_FLOOR * grad_tol * scale
        np.testing.assert_allclose(p_t[sure], p_j[sure], rtol=0, atol=1e-3 * step,
                                   err_msg=f"post-step leaf {i}")
        assert np.abs(p_t - p_init).max() <= step * (1 + 1e-3), f"leaf {i}"
    assert live >= 10


# the tests that need no JAX step first, while the jax_steps workers run
def test_train_step_draws_its_own_and_trains(scene, fields):
    """Without injected draws the step draws from its generators, stays
    finite over 3 steps, and the same seed repeats the same losses."""
    _, tf, jparams = fields
    losses = []
    for _ in range(2):
        state, opt = tts.init_train_state(tf, lr=LR, iters=ITERS,
                                          params=interop.params_from_jax(tf, jparams))
        loss_cfg = tlosses.LossConfig(scale=scene["scale"], num_frames=FRAMES, iters=ITERS)
        step = tts.make_train_step(tf, opt, loss_cfg, H=H, W=W, fov_lidar=FOV, num_rays=RAYS,
                                   num_coarse=COARSE, num_fine=FINE, seed=3)
        cache = tts.flow_cache_to_device(scene["cache"], "cpu")
        run = []
        for i in range(3):
            state, m = step(state, scene["ds"].frame(i), cache)
            run.append(float(m["loss"]))
        assert state.step == 3 and np.isfinite(run).all()
        losses.append(run)
    assert losses[0] == losses[1]


def test_render_rays_perturbed_matches_jax(fields):
    """The training render with the JAX renderer's own jitter draws."""
    jf, tf, jparams = fields
    rng = np.random.default_rng(9)
    o = rng.uniform(-0.05, 0.05, (RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(4)
    want = jax.jit(functools.partial(jr.render_rays, jf, num_coarse=COARSE, num_fine=FINE,
                                     perturb=True, with_aux=True))(
        jparams, jnp.asarray(o), jnp.asarray(d), jnp.float32(0.4), key=key)
    k1, k2, _ = jax.random.split(key, 3)
    draws = {"z_jitter": torch.from_numpy(np.array(jax.random.uniform(k1, (RAYS, COARSE)))),
             "u_jitter": torch.from_numpy(np.array(jax.random.uniform(k2, (RAYS, FINE))))}
    got = tr.render_rays(tf, interop.params_from_jax(tf, jparams), torch.from_numpy(o),
                         torch.from_numpy(d), 0.4, num_coarse=COARSE, num_fine=FINE,
                         perturb=True, with_aux=True, draws=draws)
    for k in ("depth_lidar", "image_lidar", "weights_sum_lidar", "weights", "z_vals"):
        _close(got[k].detach(), want[k], BF16_TOL, k)
    # u jitter alone: sample_pdf against the reference's with the same key
    z = np.sort(rng.uniform(0.01, 0.81, (RAYS, 12)), -1).astype(np.float32)
    w = rng.uniform(size=(RAYS, 12)).astype(np.float32) ** 4
    jz = jr.sample_pdf(jnp.asarray(z), jnp.asarray(w), 20, key=k2)
    tz = tr.sample_pdf(torch.from_numpy(z), torch.from_numpy(w), 20,
                       torch.from_numpy(np.array(jax.random.uniform(k2, (RAYS, 20)))))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=0)


def test_train_step_matches_jax_bf16(scene, fields, jax_steps):
    """Both packages' own bfloat16 MLPs and the reference's bf16 dynamic
    planes: bf16-level agreement."""
    jf, tf, jparams = fields
    result = _run_both(scene, fields, jax_result=jax_steps["bf16"].result(JAX_STEP_TIMEOUT))
    _check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                BF16_TOL, {None: BF16_GRAD_TOL, "flow": BF16_FLOW_GRAD_TOL})


def _f32_plane_linear(grid, x, coord_grad_lead=0):
    """Explicit float32 lerp with the reference plane_linear's contract
    (no coordinate gradient for the first coord_grad_lead tables)."""
    lead = min(coord_grad_lead, grid.shape[0])
    x = jnp.concatenate([jax.lax.stop_gradient(x[:lead]), x[lead:]], axis=0)
    p, c, w = grid.shape
    u = jnp.clip(x, 0.0, 1.0) * (w - 1)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    j1 = jnp.minimum(j0 + 1, w - 1)
    f = (u - j0.astype(jnp.float32))[..., None]
    g0 = jnp.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = jnp.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    return (1.0 - f) * g0 + f * g1


def _f32_everywhere(monkeypatch):
    """The reference's plane_linear swapped for a float32 lerp and both
    packages' MLPs in float32."""
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    monkeypatch.setattr(jlidar_mod, "apply_mlp", j32)
    monkeypatch.setattr(jflow_mod, "apply_mlp", j32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    monkeypatch.setattr(tlidar_mod, "apply_mlp", t32)
    monkeypatch.setattr(tflow_mod, "apply_mlp", t32)


def test_train_step_matches_jax_classic(scene, fields, jax_steps, monkeypatch):
    """The step under ONEHOT_VARIANT = "classic" in both packages, float32 as
    in test_train_step_matches_jax_f32 and at its tolerances: every hash
    encode runs `hash_encode_onehot` at the table's own F (the dynamic
    planes one call per variant, the flow grid encoding before interpT), and
    no encode folds interpT into a table."""
    jf, tf, jparams = fields
    _f32_everywhere(monkeypatch)
    monkeypatch.setattr(jho, "ONEHOT_VARIANT", "classic")
    monkeypatch.setattr(tho, "ONEHOT_VARIANT", "classic")
    onehot, folds = [], []
    fns = {name: getattr(mod, name) for mod, name in (
        (tho, "hash_encode_onehot"), (tho, "hash_encode_folded"),
        (thash_mod, "hash_encode_fact_multi_folded"))}
    monkeypatch.setattr(tho, "hash_encode_onehot", lambda *a: (
        onehot.append(a[0]), fns["hash_encode_onehot"](*a))[1])
    monkeypatch.setattr(tho, "hash_encode_folded", lambda *a: (
        folds.append(a[0]), fns["hash_encode_folded"](*a))[1])
    monkeypatch.setattr(thash_mod, "hash_encode_fact_multi_folded", lambda *a: (
        folds.append(a[0]), fns["hash_encode_fact_multi_folded"](*a))[1])
    try:
        result = _run_both(scene, fields, jax_result=jax_steps["classic"].result(JAX_STEP_TIMEOUT))
    finally:
        jax.clear_caches()
    _check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                F32_TOL, {None: F32_GRAD_TOL, "intensity": F32_ATTR_GRAD_TOL,
                          "raydrop": F32_ATTR_GRAD_TOL})
    # per loss: 2 density calls x (static + 3 planes x 3 variants + flow grid)
    # + the flow loss's 2 flow-net calls; the step's loss runs twice
    assert not folds and len(onehot) == 2 * (2 * (1 + 9 + 1) + 2)
    assert {spec.n_features for spec in onehot} == {8}


def test_train_step_matches_jax_f32(scene, fields, jax_steps, monkeypatch):
    """The reference's plane_linear swapped for a float32 lerp and both
    packages' MLPs in float32: float32-level agreement of the loss, every
    metric, every gradient leaf and the post-step parameters. The JAX step
    runs under the same switches in a `jax_steps` worker; this process's
    caches are cleared after."""
    jf, tf, jparams = fields
    _f32_everywhere(monkeypatch)
    try:
        result = _run_both(scene, fields, jax_result=jax_steps["f32"].result(JAX_STEP_TIMEOUT))
    finally:
        jax.clear_caches()
    _check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                F32_TOL, {None: F32_GRAD_TOL, "intensity": F32_ATTR_GRAD_TOL,
                          "raydrop": F32_ATTR_GRAD_TOL})


@pytest.mark.parametrize("mode", ["patch_2x8", "uniform", "uniform_patch_2x8"])
def test_train_step_other_modes_match_jax_f32(scene, fields, jax_steps, monkeypatch, mode):
    """The trainer's other step variants, float32 as in
    test_train_step_matches_jax_f32 and at its tolerances: overlapped 2 x 8
    patches with the patch gradient loss (hierarchical sampling, the
    trainer's even epochs), the uniform sampler of the hierarchical warm-up
    (num_steps = COARSE + FINE), and both at once."""
    jf, tf, jparams = fields
    _f32_everywhere(monkeypatch)
    patch = (2, 8) if "patch" in mode else 1
    sampling = dict(num_steps=COARSE + FINE) if "uniform" in mode else None
    try:
        result = _run_both(scene, fields, patch=patch, sampling=sampling,
                           jax_result=jax_steps[mode].result(JAX_STEP_TIMEOUT))
    finally:
        jax.clear_caches()
    assert ("grad_loss" in result[0]) == (patch != 1)
    _check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                F32_TOL, {None: F32_GRAD_TOL, "intensity": F32_ATTR_GRAD_TOL,
                          "raydrop": F32_ATTR_GRAD_TOL})


@pytest.mark.parametrize("mode", ["urf_decayed", "urf_patch_2x8"])
def test_train_step_urf_matches_jax_f32(scene, fields, jax_steps, monkeypatch, mode):
    """The line-of-sight (URF) loss on, hierarchical sampling, float32 as in
    test_train_step_matches_jax_f32 and at its tolerances: at patch 1 with
    eps decayed (step 45 of ITERS = 100: eps = 0.02 * 0.1 ** 0.45) and at
    2 x 8 patches at step 0, the 10k URF schedule's two step variants. The
    loss, every metric with urf_loss among them, every gradient leaf and
    the post-step parameters."""
    jf, tf, jparams = fields
    _f32_everywhere(monkeypatch)
    _, _, patch, _, urf_step = JAX_STEPS[mode]
    try:
        result = _run_both(scene, fields, patch=patch, urf_step=urf_step,
                           jax_result=jax_steps[mode].result(JAX_STEP_TIMEOUT))
    finally:
        jax.clear_caches()
    assert result[0]["urf_loss"] > 0.0
    assert ("grad_loss" in result[0]) == (patch != 1)
    _check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                F32_TOL, {None: F32_GRAD_TOL, "intensity": F32_ATTR_GRAD_TOL,
                          "raydrop": F32_ATTR_GRAD_TOL}, urf=True)
