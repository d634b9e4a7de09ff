"""The port's field, renderer, U-Net and simulator against the JAX package.

A tiny field of the flagship's shape class (8 features per level folded to
2 by num_basis=4, a hashed top static plane, flow warp on) is initialised by
the JAX package; its parameters go to the port through
`lidar4d_tpu_torch.interop`, and the same numpy inputs go to both.

Tolerances. On the CPU the JAX density rounds to bf16 twice where the port
does not round the same way: `apply_mlp` (both bf16, but the accumulation
order differs, so a value can land one bf16 step apart) and the dynamic
planes' `plane_linear_ref` (a bf16 one-hot matmul; the port lerps in exact
float32). Field- and render-level comparisons are therefore pinned at a
bf16-level tolerance (a few parts in 1e2 of each output's scale). One
comparison swaps the reference's `plane_linear` for a float32 lerp and both
packages' MLPs to float32, and holds the density to 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu.models.planes_field as jplanes_mod
import lidar4d_tpu_torch.models.flow_field as tflow_mod
import lidar4d_tpu_torch.models.lidar4d as tlidar_mod
from lidar4d_tpu.models import lidar4d as jl
from lidar4d_tpu.models import renderer as jr
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.sim import simulator as jsim
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.models import renderer as tr
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.sim import simulator as tsim
from torch_threads import limit_under_xdist

limit_under_xdist()

TINY = dict(
    base_resolution=8, max_resolution=32, log2_hashmap_size=8, n_levels_hash=2,
    n_features_per_level_hash=8, hash_size_dynamic=(8, 7, 7), n_levels_plane=2,
    min_resolution=8, time_resolution=4, num_frames=5, flow_n_levels=2,
    flow_n_features=8, flow_log2_hashmap_size=8, flow_base_resolution=8,
    flow_max_resolution=16, plane_hash_scales=1, plane_hash_log2=7,
)
BF16_TOL = 3e-2      # of each output's scale: bf16 rounding placed differently
TIGHT_TOL = 1e-4
GRAD_TOL = 1e-5     # ~10x the float32 gradient gaps measured in the milestone test


def _pair(flow_warp=True):
    jf = jl.LiDAR4DField(jl.LiDAR4DConfig(**TINY, flow_warp=flow_warp,
                                          remat_density=False, density_chunk=0))
    tf = tl.LiDAR4DField(tl.LiDAR4DConfig(**TINY, flow_warp=flow_warp), device="cpu")
    return jf, tf


@pytest.fixture(scope="module")
def fields():
    jf, tf = _pair()
    jparams = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0)))
    # non-trivial time planes and BN statistics, so every path carries signal
    rng = np.random.default_rng(1)
    for planes in jparams["planes"]:
        for ci in (2, 4, 5):
            planes[ci] = rng.uniform(0.5, 1.5, planes[ci].shape).astype(np.float32)
    return jf, tf, jparams, interop.params_from_jax(tf, jparams)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3e} of scale {scale:.3e} > {tol}"


def _xyz(seed, n=300):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def test_interop_carries_every_leaf(fields):
    jf, tf, jparams, tparams = fields
    back = interop.tree_to_numpy(tparams)
    flat_j, tree_j = jax.tree.flatten(jparams)
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    bad = dict(jparams, sigma=jparams["sigma"][:1])
    with pytest.raises(ValueError):
        interop.params_from_jax(tf, bad)


def test_port_init_has_reference_layout_and_distributions(fields):
    _, tf, jparams, _ = fields
    params = tf.init(seed=3)
    assert jax.tree.map(np.shape, interop.tree_to_numpy(params)) == jax.tree.map(np.shape, jparams)
    assert torch.all(params["planes"][0][2] == 1.0)                  # time planes: ones
    assert 0.1 <= params["planes"][0][0].min() and params["planes"][0][0].max() <= 0.5
    assert params["hash"]["static"].abs().max() <= 1e-4
    assert params["planes"][1][0].ndim == 2                           # hashed top plane


def test_hash_field_matches_jax(fields):
    jf, tf, jp, tp = fields
    jenc, tenc = jf.hash_encoder, tf.hash_encoder
    x01 = (_xyz(2) + 1) / 2
    jx = jnp.asarray(x01)
    _close(tenc.forward_static(tp["hash"], torch.from_numpy(x01)),
           jenc.forward_static(jp["hash"], jx), 1e-6)
    for t in (0.0, 0.43, 1.0):
        _close(tenc.forward_dynamic(tp["hash"], torch.from_numpy(x01), t),
               jenc.forward_dynamic(jp["hash"], jx, jnp.float32(t)), 1e-5)
    xs = np.stack([x01, x01 + 0.01, x01 - 0.02]).astype(np.float32)
    ts = [0.5, 0.6, 0.4]
    _close(tenc.forward_dynamic_multi(tp["hash"], torch.from_numpy(xs), ts),
           jenc.forward_dynamic_multi(jp["hash"], jnp.asarray(xs), jnp.asarray(ts),
                                      fused=False), 1e-5)


def test_planes_static_matches_jax(fields):
    jf, tf, jp, tp = fields
    pts = np.concatenate([(_xyz(3) + 1) / 2, np.full((300, 1), 0.3, np.float32)], -1)
    _close(tf.planes_encoder.forward_static(tp["planes"], torch.from_numpy(pts)),
           jf.planes_encoder.forward_static(jp["planes"], jnp.asarray(pts)), 1e-6)


def _f32_plane_linear(grid, x, coord_grad_lead=0):
    """Explicit float32 lerp with the reference plane_linear's contract."""
    p, c, w = grid.shape
    u = jnp.clip(x, 0.0, 1.0) * (w - 1)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    j1 = jnp.minimum(j0 + 1, w - 1)
    f = (u - j0.astype(jnp.float32))[..., None]
    g0 = jnp.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = jnp.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    return (1.0 - f) * g0 + f * g1


def _f32_plane_linear_lead(grid, x, coord_grad_lead=0):
    """`_f32_plane_linear` with the reference's coordinate-gradient contract:
    no gradient for the first coord_grad_lead tables."""
    lead = min(coord_grad_lead, grid.shape[0])
    x = jnp.concatenate([jax.lax.stop_gradient(x[:lead]), x[lead:]], axis=0)
    return _f32_plane_linear(grid, x)


def test_planes_dynamic_matches_jax(fields, monkeypatch):
    jf, tf, jp, tp = fields
    x01 = (_xyz(4) + 1) / 2
    xs = np.stack([x01, np.clip(x01 + 0.02, 0, 1), np.clip(x01 - 0.03, 0, 1)]).astype(np.float32)
    ts = [0.5, 0.75, 0.25]
    got = tf.planes_encoder.forward_dynamic_scalar_t_multi(tp["planes"], torch.from_numpy(xs), ts)
    # the reference's bf16 one-hot plane_linear: bf16-level agreement
    want = jf.planes_encoder.forward_dynamic_scalar_t_multi(jp["planes"], jnp.asarray(xs),
                                                            jnp.asarray(ts))
    _close(got, want, BF16_TOL)
    # with an f32 lerp in its place: float32 agreement
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
    want32 = jf.planes_encoder.forward_dynamic_scalar_t_multi(jp["planes"], jnp.asarray(xs),
                                                              jnp.asarray(ts))
    _close(got, want32, 1e-6)


def test_flow_matches_jax(fields):
    jf, tf, jp, tp = fields
    x = _xyz(5)
    got = tf.flow(tp, torch.from_numpy(x), 0.5)
    want = jf.flow(jp, jnp.asarray(x), jnp.float32(0.5))
    for k in ("forward", "backward"):
        _close(got[k], want[k], BF16_TOL)


@functools.lru_cache(maxsize=None)
def _jax_density(flow_warp):
    jf, _ = _pair(flow_warp)
    return jax.jit(lambda p, x, t: jf.density(p, x, t))


@pytest.mark.parametrize("flow_warp", [True, False])
@pytest.mark.parametrize("t", [0.0, 0.5, 1.0])       # first, middle and last frame
def test_density_matches_jax(fields, flow_warp, t):
    _, _, jp, tp = fields
    _, tf = _pair(flow_warp)
    x = _xyz(6)
    got = tf.density(tp, torch.from_numpy(x), t)
    want = _jax_density(flow_warp)(jp, jnp.asarray(x), jnp.float32(t))
    _close(got["geo_feat"], want["geo_feat"], BF16_TOL)
    _close(torch.log(got["sigma"]), jnp.log(want["sigma"]), BF16_TOL)


def test_density_tight_with_f32_planes_and_mlps(fields, monkeypatch):
    """The same density with the two bf16 roundings taken out of both
    packages: the reference's plane_linear becomes a float32 lerp and both
    packages' MLPs run in float32. Then the port agrees to 1e-4 at the
    first, middle and last frame. A fresh jitted function is traced under
    the patch, and the caches are cleared after it, so no trace is shared
    with the bf16 tests."""
    _, _, jp, tp = fields
    jf, tf = _pair(True)
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    monkeypatch.setattr(jlidar_mod, "apply_mlp", j32)
    monkeypatch.setattr(jflow_mod, "apply_mlp", j32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    monkeypatch.setattr(tlidar_mod, "apply_mlp", t32)
    monkeypatch.setattr(tflow_mod, "apply_mlp", t32)
    density32 = jax.jit(lambda p, x, t: jf.density(p, x, t))
    try:
        x = _xyz(7)
        for t in (0.0, 0.5, 1.0):
            got = tf.density(tp, torch.from_numpy(x), t)
            want = density32(jp, jnp.asarray(x), jnp.float32(t))
            _close(got["geo_feat"], want["geo_feat"], TIGHT_TOL)
            _close(got["sigma"], want["sigma"], TIGHT_TOL)
    finally:
        jax.clear_caches()


def test_attribute_matches_jax(fields):
    jf, tf, jp, tp = fields
    rng = np.random.default_rng(8)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    geo = rng.normal(size=(300, 15)).astype(np.float32)
    _close(tf.attribute(tp, torch.from_numpy(d), torch.from_numpy(geo)),
           jf.attribute(jp, jnp.asarray(d), jnp.asarray(geo)), BF16_TOL)


def test_sample_pdf_and_merge_sorted_match_jax():
    """sample_pdf agrees to float32 rounding (the two cumsums associate
    differently); merge_sorted, a pure permutation, agrees bitwise."""
    rng = np.random.default_rng(9)
    z = np.sort(rng.uniform(0.01, 0.81, (64, 32)), -1).astype(np.float32)
    w = (rng.uniform(size=(64, 32)) ** 4).astype(np.float32)
    zf = jr.sample_pdf(jnp.asarray(z), jnp.asarray(w), 48)
    tzf = tr.sample_pdf(torch.from_numpy(z), torch.from_numpy(w), 48)
    np.testing.assert_allclose(tzf.numpy(), np.asarray(zf), rtol=1e-5, atol=0)
    zb = np.sort(np.asarray(zf), -1)
    vals = rng.normal(size=(64, 80, 3)).astype(np.float32)
    jz, (jv,) = jr.merge_sorted(jnp.asarray(z), jnp.asarray(zb), [jnp.asarray(vals)])
    tz, (tv,) = tr.merge_sorted(torch.from_numpy(z), torch.from_numpy(zb), [torch.from_numpy(vals)])
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _rays(seed, n=96):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _jax_render(jf):
    return jax.jit(functools.partial(jr.render_rays, jf, num_coarse=16, num_fine=32,
                                     with_aux=False))


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_render_rays_hierarchical_matches_jax(fields, t):
    jf, tf, jp, tp = fields
    o, d = _rays(10)
    want = _jax_render(jf)(jp, jnp.asarray(o), jnp.asarray(d), jnp.float32(t))
    got = tr.render_rays(tf, tp, torch.from_numpy(o), torch.from_numpy(d), t,
                         num_coarse=16, num_fine=32)
    for k in ("depth_lidar", "image_lidar", "weights_sum_lidar"):
        _close(got[k], want[k], BF16_TOL)


def test_render_staged_chunks_match_unchunked(fields):
    _, tf, _, tp = fields
    o, d = _rays(11, n=70)
    whole = tr.render_rays(tf, tp, torch.from_numpy(o), torch.from_numpy(d), 0.25,
                           num_coarse=8, num_fine=8)
    staged = tr.render_staged(tf, tp, torch.from_numpy(o), torch.from_numpy(d), 0.25,
                              chunk=32, num_coarse=8, num_fine=8)
    for k in ("depth_lidar", "image_lidar"):
        np.testing.assert_allclose(staged[k].numpy(), whole[k].numpy(), rtol=1e-5, atol=1e-6)


def test_unet_eval_matches_jax(fields):
    jf, tf, jp, tp = fields
    rng = np.random.default_rng(12)
    state = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         jp["unet"]["state"])
    variables = {"params": jp["unet"]["params"], "state": state}
    x = rng.uniform(size=(1, 3, 20, 36)).astype(np.float32)        # odd pooled sizes
    want, _ = jax.jit(functools.partial(jf.unet.apply, train=False))(variables, jnp.asarray(x))
    got = tf.unet.apply(interop.tree_to_torch(variables, "cpu"), torch.from_numpy(x))
    _close(got, want, 1e-4)


def _sim_inputs(H=16, W=32):
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 0, 3] = [-0.02, 0.03]
    rays_o, rays_d = tsim.build_novel_rays(poses, H, W, (2.0, 26.9))
    jo, jd = jsim.build_novel_rays(poses, H, W, (2.0, 26.9))
    np.testing.assert_allclose(rays_d, jd, atol=1e-6)
    np.testing.assert_array_equal(rays_o, jo)
    return rays_o, rays_d


def test_simulator_render_matches_jax(fields, tmp_path, monkeypatch):
    """Simulator.render with the U-Net refine, no files written: the last
    frame's point cloud matches the reference's. The U-Net's output bias is
    raised so every pixel is kept and the mask is far from its threshold.
    The reference U-Net is jitted here only to save test time."""
    from types import SimpleNamespace

    from lidar4d_tpu.models.unet import UNet as JUNet

    monkeypatch.setattr(JUNet, "apply", jax.jit(JUNet.apply, static_argnums=(0,),
                                                static_argnames=("train",)))
    jf, tf, jp, _ = fields
    jp = jax.tree.map(lambda a: a, jp)
    jp["unet"]["params"]["outc"]["b"] = np.full_like(jp["unet"]["params"]["outc"]["b"], 3.0)
    tp = interop.params_from_jax(tf, jp)
    H, W = 16, 32
    opt = SimpleNamespace(num_steps=16, num_coarse=8, num_fine=16, scale=0.01,
                          fov_lidar=(2.0, 26.9))
    rays_o, rays_d = _sim_inputs(H, W)
    times = np.array([0.25, 0.75], np.float32)
    want = jsim.Simulator("l", opt, jf, jp, workspace=str(tmp_path / "j"), use_refine=True,
                          H_lidar=H, W_lidar=W).render(
        rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False,
        frame_batch=2)
    refined = []

    class FrameHook(tsim.Simulator):
        def _refine(self, raydrop, intensity, depth):
            out = super()._refine(raydrop, intensity, depth)
            refined.append((depth, out))
            return out

    sim = FrameHook("l", opt, tf, tp, workspace=str(tmp_path / "t"), use_refine=True,
                    H_lidar=H, W_lidar=W, device="cpu")
    got = sim.render(rays_o, rays_d, times, save_pc=False, save_img=False,
                     save_video=False, frame_batch=2)
    assert not (tmp_path / "t").exists()                           # nothing written
    assert got.shape == want.shape == (H * W, 4)
    _close(got, want, BF16_TOL)
    assert len(refined) == 2
    for depth, raydrop in refined:
        assert depth.shape == (H, W) and torch.isfinite(depth).all()
        assert (raydrop > 0.5).all()


def test_simulator_render_writes_point_clouds(fields, tmp_path):
    _, tf, _, tp = fields
    from types import SimpleNamespace

    opt = SimpleNamespace(num_steps=16, num_coarse=0, num_fine=0, scale=0.01,
                          fov_lidar=(2.0, 26.9))
    rays_o, rays_d = _sim_inputs()
    sim = tsim.Simulator("l", opt, tf, tp, workspace=str(tmp_path), use_refine=False,
                         H_lidar=16, W_lidar=32, device="cpu")
    pc = sim.render(rays_o, rays_d, [0.0, 0.5, 1.0][:2], save_pc=True, save_img=False,
                    save_video=False, frame_batch=1)
    files = sorted(p.name for p in (tmp_path / "points").iterdir())
    assert files == ["lidar4d_0000.npy", "lidar4d_0001.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "points" / files[-1]), pc)


@pytest.mark.parametrize("missing", ["cv2", "imageio"])
def test_simulator_render_is_best_effort_without_cv2_or_imageio(fields, tmp_path, monkeypatch,
                                                                 missing):
    """The default call (point clouds, images and a video asked for) on a
    machine without cv2 or without imageio, as the reference behaves: no
    image panel without cv2, a warning for a video that cannot be written,
    and the point clouds come back and are written either way."""
    import sys
    from types import SimpleNamespace

    _, tf, _, tp = fields
    monkeypatch.setitem(sys.modules, missing, None)
    opt = SimpleNamespace(num_steps=16, num_coarse=0, num_fine=0, scale=0.01,
                          fov_lidar=(2.0, 26.9))
    rays_o, rays_d = _sim_inputs()
    sim = tsim.Simulator("l", opt, tf, tp, workspace=str(tmp_path), use_refine=False,
                         H_lidar=16, W_lidar=32, device="cpu")
    if missing == "cv2":
        pc = sim.render(rays_o, rays_d, [0.0, 0.5], frame_batch=1)
        assert not (tmp_path / "images").exists()
    else:
        with pytest.warns(UserWarning, match="video write failed"):
            pc = sim.render(rays_o, rays_d, [0.0, 0.5], frame_batch=1)
        assert len(list((tmp_path / "images").iterdir())) == 2
    assert not (tmp_path / "video").exists() or not any((tmp_path / "video").iterdir())
    assert pc.ndim == 2 and pc.shape[1] == 4 and np.isfinite(pc).all()
    np.testing.assert_array_equal(np.load(tmp_path / "points" / "lidar4d_0001.npy"), pc)


def test_render_rays_default_keys_match_jax(fields):
    """render_rays defaults to with_aux=True as the reference does: the same
    keys, and weights / z_vals that agree."""
    jf, tf, jp, tp = fields
    o, d = _rays(13, n=24)
    want = jr.render_rays(jf, jp, jnp.asarray(o), jnp.asarray(d), jnp.float32(0.5), num_steps=8)
    got = tr.render_rays(tf, tp, torch.from_numpy(o), torch.from_numpy(d), 0.5, num_steps=8)
    assert sorted(got) == sorted(want)
    for k in ("weights", "z_vals"):
        _close(got[k], want[k], BF16_TOL)


def test_entry_points_default_to_cuda(monkeypatch, fields):
    """With no CUDA, the default device raises instead of falling back."""
    _, tf, _, tp = fields
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.LiDAR4DField(tl.LiDAR4DConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.render_frames_staged(tf, tp, np.zeros((1, 4, 3)), np.ones((1, 4, 3)), [0.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.Simulator("l", None, tf, tp)


def _signal(jparams):
    """A copy of a JAX tree whose hash and flow tables carry O(0.1-1) values
    (the init's U(-1e-4, 1e-4) would hide them from a gradient check)."""
    rng = np.random.default_rng(2)
    p = jax.tree.map(np.array, jparams)
    for k in p["hash"]:
        p["hash"][k] = rng.uniform(-0.5, 0.5, p["hash"][k].shape).astype(np.float32)
    p["flow"]["grid"] = rng.uniform(-0.5, 0.5, p["flow"]["grid"].shape).astype(np.float32)
    return p


def test_density_value_and_grad_match_jax(fields, monkeypatch):
    """Field milestone: value and gradient of sum(sigma) + sum(geo_feat)
    with respect to every parameter leaf, flow warp on, at the first,
    middle and last frame, with the bf16 roundings taken out of both
    packages (as in test_density_tight_with_f32_planes_and_mlps). Every
    leaf within GRAD_TOL of its largest gradient: the same float32
    algorithm, summed in another order (measured <= 1.2e-6)."""
    _, _, jp, _ = fields
    jf, tf = _pair(True)
    jp = _signal(jp)
    tp = interop.params_from_jax(tf, jp)
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear_lead)
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    monkeypatch.setattr(jlidar_mod, "apply_mlp", j32)
    monkeypatch.setattr(jflow_mod, "apply_mlp", j32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    monkeypatch.setattr(tlidar_mod, "apply_mlp", t32)
    monkeypatch.setattr(tflow_mod, "apply_mlp", t32)

    def jloss(p, x, t):
        d = jf.density(p, x, t)
        return jnp.sum(d["sigma"]) + jnp.sum(d["geo_feat"])

    jgrad = jax.jit(jax.value_and_grad(jloss))
    leaves = [p.requires_grad_() for p in jax.tree.leaves(tp)]
    try:
        x = _xyz(13)
        for t in (0.0, 0.5, 1.0):
            want, wg = jgrad(jp, jnp.asarray(x), jnp.float32(t))
            d = tf.density(tp, torch.from_numpy(x), t)
            got = torch.sum(d["sigma"]) + torch.sum(d["geo_feat"])
            tg = torch.autograd.grad(got, leaves, allow_unused=True)
            _close(got.detach(), want, TIGHT_TOL)
            live = 0
            for g, w in zip(tg, jax.tree.leaves(wg)):
                w = np.asarray(w)
                if g is None:
                    assert not w.any()
                    continue
                assert torch.isfinite(g).all()
                if np.abs(w).max() > 0:
                    live += 1
                    _close(g, w, GRAD_TOL)
            assert live >= 20
    finally:
        jax.clear_caches()
