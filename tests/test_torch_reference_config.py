"""The reference configuration's routes against the JAX package on the CPU.

`configs/kitti360_4950.txt` at the CLI defaults (`LiDAR4DConfig()`: 2^19-row
static hash tables, dynamic planes of 2^15 / 2^13 / 2^13 rows, a flow grid of
2^18 rows a level, dense 32^2..256^2 static planes, 768 uniform samples) sends
every hash encode of the port off the flagship's routes: the static hash, the
xy dynamic planes and the flow grid go through the classic encode at their
own F (the xy planes unfused, one launch a time variant, interpT after the
encode), the xz / yz dynamic planes fold interpT into F' = 1 tables. The
JAX package trains this configuration through its gather path with the
density chunked and rematerialised (`remat_density=True`, `density_chunk`).

`GATHER` is a tiny spec on the same routes: 2^15-row static, xy and flow
tables (above the factorized window, FACT_MAX_ROWS = 16,384 rows a level),
2^13-row xz / yz tables, dense planes. Its JAX field runs with
`density_chunk=JAX_CHUNK`, below every point count here, so each JAX density
is a `lax.map` over chunks, each under `jax.checkpoint`. The scene, the
step's draws and the float32 switches are tests/test_torch_train.py's, and
so are the tolerances: float32 MLPs and lerp (`TIGHT_TOL` / `GRAD_TOL` for
the density, the F32 step tolerances), or the packages' own bfloat16 MLPs
at `BF16_TOL` for the render.
"""

import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar4d_tpu_torch.models.hash_field as thash_mod
import lidar4d_tpu_torch.ops.hash_enc as hash_enc
import lidar4d_tpu_torch.ops.hash_onehot as tho
import test_torch_train as ttt
from lidar4d_tpu.cli import config as jconfig
from lidar4d_tpu.models import lidar4d as jl
from lidar4d_tpu.models import renderer as jr
from lidar4d_tpu.ops import hash_onehot as jho
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.cli import config as tconfig
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.models import renderer as tr
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.ops import plane_onehot as tpo
from lidar4d_tpu_torch.sim import simulator as tsim
from lidar4d_tpu_torch.train import trainer as ttrainer
from test_torch_train import scene  # noqa: F401  (the tiny synthetic scene, a module fixture)
from torch_threads import limit_under_xdist

limit_under_xdist()

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "kitti360_4950.txt"
GATHER = dict(
    base_resolution=256, max_resolution=512, log2_hashmap_size=15, n_levels_hash=2,
    n_features_per_level_hash=4, hash_size_dynamic=(15, 13, 13), n_levels_plane=2,
    min_resolution=8, time_resolution=4, flow_n_levels=2, flow_n_features=8,
    flow_log2_hashmap_size=15, flow_base_resolution=32, flow_max_resolution=64,
    plane_hash_scales=0,
)
JAX_CHUNK = 500
TIGHT_TOL = 1e-4     # tests/test_torch_models.py: the float32 density value
GRAD_TOL = 1e-5      # and each gradient leaf, of its largest magnitude
BF16_TOL = 3e-2      # the packages' own bfloat16 MLPs, of each output's scale
F32_STEP_TOLS = {None: ttt.F32_GRAD_TOL, "intensity": ttt.F32_ATTR_GRAD_TOL,
                 "raydrop": ttt.F32_ATTR_GRAD_TOL}


@pytest.fixture(scope="module")
def fields(scene):  # noqa: F811
    """The GATHER field of each package at the scene's near / far (JAX
    chunked and rematerialised), and JAX-initialised parameters whose hash
    and flow tables and time planes carry O(0.1-1) values, so that every
    encoder moves the outputs."""
    kw = dict(GATHER, num_frames=ttt.FRAMES, near_lidar=1.0 * scene["scale"],
              far_lidar=81.0 * scene["scale"])
    jf = jl.LiDAR4DField(jl.LiDAR4DConfig(**kw, remat_density=True, density_chunk=JAX_CHUNK))
    tf = tl.LiDAR4DField(tl.LiDAR4DConfig(**kw), device="cpu")
    jparams = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for k in jparams["hash"]:
        jparams["hash"][k] = rng.uniform(-0.5, 0.5, jparams["hash"][k].shape).astype(np.float32)
    jparams["flow"]["grid"] = rng.uniform(-0.5, 0.5, jparams["flow"]["grid"].shape).astype(
        np.float32)
    for planes in jparams["planes"]:
        for ci in (2, 4, 5):
            planes[ci] = rng.uniform(0.5, 1.5, planes[ci].shape).astype(np.float32)
    return jf, tf, jparams


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _rows(spec):
    return (spec.n_dims, spec.n_features, int(np.log2(spec.table_sizes[-1])))


# ------------------------------------------------------------------- (a)
def test_routes_of_the_reference_specs(fields, monkeypatch):
    """One port density call on the GATHER field with its parameters
    requiring a gradient, every hash encode spied: the static hash, the flow
    grid and each time variant of the xy planes through the classic encode
    at their own F (4, 8, 4; variant 0 too, whose coordinates once carried
    the flow net's graph and sent it to the plain gather), each variant of
    the xz / yz planes through the folded encode (F' = 1), nothing through
    the factorized or the fused dynamic route. The full LiDAR4DConfig()
    specs take the same branches (read off the dispatch predicates):
    above the factorized window, inside the kernels' rows, no shared-memory
    accumulator for the 2^19-row static levels, plane_bilinear_bwd's global
    path at 256^2."""
    _, tf, jparams = fields
    calls = {name: [] for name in ("hash_encode_onehot", "hash_encode_onehot_fact",
                                   "hash_encode_folded", "hash_encode_fact_multi_folded")}
    for mod, name in ((tho, "hash_encode_onehot"), (tho, "hash_encode_onehot_fact"),
                      (tho, "hash_encode_folded"), (thash_mod, "hash_encode_fact_multi_folded")):
        def spy(*a, _fn=getattr(mod, name), _name=name):
            calls[_name].append(a[0])
            return _fn(*a)
        monkeypatch.setattr(mod, name, spy)
    o, d = _rays(3, 8)
    z = np.linspace(tf.cfg.near_lidar, tf.cfg.far_lidar, 12, dtype=np.float32)
    tp = interop.params_from_jax(tf, jparams)
    for p in interop.tree_leaves(tp):
        p.requires_grad_()                  # as in a train step: the flow net's output too
    tr._query_density(tf, tp, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(np.tile(z, (8, 1))), 0.5, 1.0)
    assert sorted(map(_rows, calls["hash_encode_onehot"])) == [(2, 4, 15)] * 3 + [
        (3, 4, 15), (3, 8, 15)]
    assert sorted(map(_rows, calls["hash_encode_folded"])) == [(2, 4, 13)] * 6
    assert not calls["hash_encode_onehot_fact"] and not calls["hash_encode_fact_multi_folded"]

    for field in (tf, tl.LiDAR4DField(tl.LiDAR4DConfig(), device="cpu")):
        enc, flow = field.hash_encoder, field.flow_net
        static, xy, xz, yz = enc.static_spec, *(enc.dynamic_spec(p) for p in range(3))
        for spec in (static, xy, flow.grid_spec):
            assert not tho.onehot_eligible(spec, tho.FACT_MAX_ROWS)
            assert tho.onehot_eligible(spec, tho.KERNEL_MAX_ROWS)
        assert not tho.folded_eligible(xy, enc.num_basis)
        assert not tho.folded_eligible(flow.grid_spec, flow.num_basis)
        assert tho.folded_eligible(xz, enc.num_basis) and tho.folded_eligible(yz, enc.num_basis)
        assert not field.in_onehot_window
    full = field.cfg                    # the loop's last field: LiDAR4DConfig()
    assert static.table_sizes == (1 << 19,) * 8 and static.n_features == 4
    assert tho._smem_floats(static) == 0
    assert flow.grid_spec.table_sizes == (33 ** 3,) + (1 << 18,) * 7
    assert flow.grid_spec.n_features == 8
    assert (full.plane_hash_scales, full.n_levels_plane, full.min_resolution) == (0, 4, 32)
    assert tpo.plane_bilinear_bwd_slice(full.n_features_per_level_plane, 256, 256) == 0


def test_build_model_config_of_the_reference_config_matches_jax():
    """configs/kitti360_4950.txt through each package's parser and
    build_model_config: equal field by field, less the JAX memory policy
    (remat_density, density_chunk), which the port does not have; and the
    defaults of LiDAR4DConfig()."""
    argv = ["--config", str(CONFIG)]
    want = dataclasses.asdict(jconfig.build_model_config(jconfig.get_arg_parser().parse_args(argv)))
    assert (want.pop("remat_density"), want.pop("density_chunk")) == (True, 32768)
    got = dataclasses.asdict(tconfig.build_model_config(tconfig.get_arg_parser().parse_args(argv)))
    assert got == want
    defaults = dataclasses.asdict(tl.LiDAR4DConfig())
    assert {k: v for k, v in got.items() if k not in ("near_lidar", "far_lidar")} == {
        k: v for k, v in defaults.items() if k not in ("near_lidar", "far_lidar")}


# ------------------------------------------------------------------- (b)
def _float64_lagrange_weights(monkeypatch):
    """The Lagrange weights (float32 values, as both packages compute them)
    handed out as float64, so that the port's plain path runs in float64."""
    weights = hash_enc.lagrange_weights
    for mod in (hash_enc, tho, thash_mod):
        monkeypatch.setattr(mod, "lagrange_weights",
                            lambda *a: weights(*a).astype(np.float64))


def test_density_value_and_grad_match_chunked_remat_jax(fields, monkeypatch):
    """Value and gradient of sum(sigma) + sum(geo_feat) with respect to every
    parameter leaf at the first, middle and last frame, float32 MLPs and
    lerp in both packages, on 768 points through each package's
    `_query_density` (each point a ray of one sample; JAX in chunks of
    JAX_CHUNK, the last one padded, each rematerialised): points uniform in
    the box, as tests/test_torch_models.py's density tests take them, and
    the samples of 16 rays x 48 near the origin, at TIGHT_TOL / GRAD_TOL.
    Each float32 gradient is also held at GRAD_TOL against a float64
    oracle, the port's plain path with parameters, points and MLPs in
    float64: the port against the exact result, not only against JAX's
    rounding (measured: port and JAX each <= 7.4e-7 from float64 and <=
    8.2e-7 from each other on both layouts). One JAX trace for all."""
    jf, tf, jparams = fields
    tp = interop.params_from_jax(tf, jparams)
    tp64 = interop.tree_map(lambda p: p.double(), tp)
    ttt._f32_everywhere(monkeypatch)
    o, d = _rays(5, 16)
    z = np.linspace(tf.cfg.near_lidar, tf.cfg.far_lidar, 48, dtype=np.float32)
    layouts = {"uniform": np.random.default_rng(6).uniform(-1, 1, (768, 3)),
               "rays": (o[:, None] + d[:, None] * z[:, None]).reshape(-1, 3)}
    # each point a ray of one sample at z = 0: one shape, one JAX trace
    d, z = np.tile(np.float32([[1, 0, 0]]), (768, 1)), np.zeros((768, 1), np.float32)
    assert z.size > JAX_CHUNK and z.size % JAX_CHUNK

    def jloss(p, o, t):
        sigma, geo = jr._query_density(jf, p, o, jnp.asarray(d), jnp.asarray(z), t, jf.cfg.bound)
        return jnp.sum(sigma) + jnp.sum(geo)

    def port(params, o, t, dtype):
        leaves = [p.requires_grad_() for p in interop.tree_leaves(params)]
        sigma, geo = tr._query_density(tf, params, *(torch.from_numpy(a).to(dtype)
                                                     for a in (o, d, z)), t, tf.cfg.bound)
        got = torch.sum(sigma) + torch.sum(geo)
        return got.detach(), torch.autograd.grad(got, leaves, allow_unused=True)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    try:
        for layout, o in layouts.items():
            o = o.astype(np.float32)
            for t in (0.0, 0.5, 1.0):
                want, wg = jgrad(jparams, o, jnp.float32(t))
                got, tg = port(tp, o, t, torch.float32)
                with pytest.MonkeyPatch.context() as m:
                    _float64_lagrange_weights(m)
                    f64 = functools.partial(tmlp.apply_mlp, dtype=torch.float64)
                    m.setattr(ttt.tlidar_mod, "apply_mlp", f64)
                    m.setattr(ttt.tflow_mod, "apply_mlp", f64)
                    exact, xg = port(tp64, o, t, torch.float64)
                what = f"{layout}, t = {t}"
                ttt._close(got, want, TIGHT_TOL, f"{what}: value")
                ttt._close(got, exact, TIGHT_TOL, f"{what}: value against float64")
                live = 0
                for i, (g, w, x) in enumerate(zip(tg, jax.tree.leaves(wg), xg)):
                    w = np.asarray(w)
                    if g is None:
                        assert not w.any() and x is None, f"{what}: leaf {i}"
                        continue
                    assert torch.isfinite(g).all(), f"{what}: leaf {i}"
                    if np.abs(w).max() > 0:
                        live += 1
                        ttt._close(g, w, GRAD_TOL, f"{what}: grad leaf {i}")
                        ttt._close(g, x, GRAD_TOL, f"{what}: grad leaf {i} against float64")
                assert live >= 20
    finally:
        jax.clear_caches()


# ------------------------------------------------------------------- (c)
def test_train_step_matches_chunked_remat_jax_f32(scene, fields, monkeypatch):  # noqa: F811
    """One uniform train step (64 rays x 24 samples, 1,536 points a density
    call, the flow loss on) of each package from the same parameters with
    the JAX step's draws, float32: loss, metrics, every gradient leaf and
    the post-step parameters at tests/test_torch_train.py's F32 tolerances."""
    jf, _, jparams = fields
    ttt._f32_everywhere(monkeypatch)
    try:
        result = ttt._run_both(scene, fields, sampling=dict(num_steps=24))
    finally:
        jax.clear_caches()
    ttt._check_step(result, jparams, jax.tree.leaves(jf.param_group_labels(jparams)),
                    ttt.F32_TOL, F32_STEP_TOLS)


# ------------------------------------------------------------------- (d)
def test_render_staged_at_768_samples_matches_jax_host_loop(fields):
    """The full-frame render loop at the reference's 768 uniform samples on
    64 rays, in the port's chunk for this field, against the JAX package's
    host chunk loop (its route for a gather-path field) at its own density
    chunk (32,768 points, below the 49,152 here), both at their own
    bfloat16 MLPs."""
    jf, tf, jparams = fields
    jf = jl.LiDAR4DField(dataclasses.replace(jf.cfg, density_chunk=jr._DENSITY_CHUNK))
    o, d = _rays(7, 64)
    try:
        want = jr.render_staged_host(jf, jax.tree.map(jnp.asarray, jparams), jnp.asarray(o),
                                     jnp.asarray(d), jnp.float32(0.4), num_steps=768)
    finally:
        jax.clear_caches()
    got = tr.render_staged(tf, interop.params_from_jax(tf, jparams), torch.from_numpy(o),
                           torch.from_numpy(d), 0.4, num_steps=768, chunk=tr.frame_chunk(tf))
    for k in ("depth_lidar", "image_lidar"):
        ttt._close(got[k], want[k], BF16_TOL, k)


# ------------------------------------------------------------------- (e)
@pytest.mark.parametrize("spec,chunk", [(GATHER, tr.GATHER_CHUNK), (ttt.TINY, tr.ONEHOT_CHUNK)],
                         ids=["gather", "flagship_class"])
def test_trainer_and_simulator_pick_the_reference_chunk(monkeypatch, spec, chunk):
    """The trainer's evaluation frame and Simulator.render render a field
    outside the one-hot window in 4,096-ray chunks and one inside it in
    16,384, as the JAX trainer and Simulator decide (the same verdict from
    the JAX package's predicates). The chunk loop is spied: nothing is
    rendered."""
    field = tl.LiDAR4DField(tl.LiDAR4DConfig(**spec), device="cpu")
    jenc = jl.LiDAR4DField(jl.LiDAR4DConfig(**spec)).hash_encoder
    jonehot = all(jho.onehot_eligible(s, jho.FACT_MAX_ROWS)
                  for s in [jenc.static_spec] + [jenc.dynamic_spec(p) for p in range(3)])
    assert field.in_onehot_window == jonehot == (chunk == tr.ONEHOT_CHUNK)
    chunks = []

    def spy(field, params, rays_o, rays_d, t, chunk=None, **kw):
        chunks.append(chunk)
        n = rays_o.shape[0]
        return {"depth_lidar": torch.zeros(n), "image_lidar": torch.zeros(n, 2)}

    monkeypatch.setattr(ttrainer, "render_staged", spy)
    monkeypatch.setattr(tr, "render_staged", spy)
    opt = SimpleNamespace(num_steps=768, num_coarse=0, num_fine=0, scale=0.01,
                          fov_lidar=(2.0, 26.9))
    ds = SimpleNamespace(H_lidar=2, W_lidar=3, intrinsics_lidar=opt.fov_lidar,
                         frame=lambda i: {"pose": np.eye(4, dtype=np.float32), "time": 0.5})
    host = SimpleNamespace(field=field, device=torch.device("cpu"), opt=opt, mesh=None)
    ttrainer.Trainer._render_frame(host, None, ds, 0)
    rays_o, rays_d = tsim.build_novel_rays(np.eye(4, dtype=np.float32)[None], 2, 3, opt.fov_lidar)
    tsim.Simulator("l", opt, field, None, use_refine=False, H_lidar=2, W_lidar=3,
                   device="cpu").render(rays_o, rays_d, [0.5], save_pc=False, save_img=False,
                                        save_video=False)
    assert chunks == [chunk, chunk]

