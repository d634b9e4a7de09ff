"""The port's trainer against the JAX package's trainer on the CPU: the slice
as a whole, part 2 (part 1, evaluate on the tracked checkpoint, is
tests/test_torch_trainer_slice.py).

Two trainer epochs of both packages on a tiny field from the same initial
parameters (the JAX trainer's, carried across), the first with the uniform
sampler of the hierarchical warm-up, the second with hierarchical sampling
at 2 x 8 patches; the port's steps take the JAX trainer's draws (its key
chain, split as its step splits it). Both run with float32 MLPs and the JAX
`plane_linear` swapped for an explicit float32 lerp.

Tolerances, and why: each Adam step moves an entry by about lr x sign(g),
so an entry whose gradient lies within rounding of 0 could move the other
way and the runs part a little more each step; the parameters are
therefore held through their moves from the common init. Epoch losses (the
last step's): `EPOCH_LOSS_RTOL` (1e-5 relative; measured <= 1.1e-7); the
moves of the parameters and of the EMA over the 8 steps: cosine >=
`MOVE_COS` (1 - 1e-6; measured 1 - 1.2e-9), norm ratio within
`MOVE_NORM_RTOL` (1e-5; measured 3.8e-8).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu.models.planes_field as jplanes_mod
from lidar4d_tpu.cli import config as jconfig
from lidar4d_tpu.data import kitti360 as jkitti
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.ops import rays as jrays
from lidar4d_tpu.train import trainer as jtrainer_mod
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.cli import config as tconfig
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
from lidar4d_tpu_torch.models import flow_field as tflow_mod
from lidar4d_tpu_torch.models import lidar4d as tlidar_mod
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.train import trainer as ttrainer_mod
from torch_threads import limit_under_xdist

limit_under_xdist()

EPOCH_LOSS_RTOL = 1e-5
MOVE_COS = 1 - 1e-6
MOVE_NORM_RTOL = 1e-5


def _f32_plane_linear(grid, x, coord_grad_lead=0):
    """Explicit float32 lerp with the reference plane_linear's contract."""
    lead = min(coord_grad_lead, grid.shape[0])
    x = jnp.concatenate([jax.lax.stop_gradient(x[:lead]), x[lead:]], axis=0)
    w = grid.shape[2]
    u = jnp.clip(x, 0.0, 1.0) * (w - 1)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    j1 = jnp.minimum(j0 + 1, w - 1)
    f = (u - j0.astype(jnp.float32))[..., None]
    g0 = jnp.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = jnp.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    return (1.0 - f) * g0 + f * g1


@pytest.fixture
def f32(monkeypatch):
    """Both packages' MLPs in float32 and the JAX plane_linear a float32
    lerp; the JAX caches cleared after."""
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    monkeypatch.setattr(jlidar_mod, "apply_mlp", j32)
    monkeypatch.setattr(jflow_mod, "apply_mlp", j32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    monkeypatch.setattr(tlidar_mod, "apply_mlp", t32)
    monkeypatch.setattr(tflow_mod, "apply_mlp", t32)
    yield
    jax.clear_caches()


def _options(argv):
    """(JAX options, port options), near / far scaled as the CLIs scale them."""
    jopt = jconfig.get_arg_parser().parse_args(argv + ["--num_devices", "1"])
    topt = tconfig.get_arg_parser().parse_args(argv + ["--device", "cpu"])
    for opt in (jopt, topt):
        opt.near_lidar *= opt.scale
        opt.far_lidar *= opt.scale
    return jopt, topt


def _trainers(jopt, topt, jws, tws, j_meters=(), t_meters=(), **kw):
    jfield = jlidar_mod.LiDAR4DField(jconfig.build_model_config(jopt))
    # the JAX trainer's initial parameters in one compile (the same values
    # as drawn op by op)
    object.__setattr__(jfield, "init", jax.jit(jfield.init))   # a frozen dataclass
    tfield = tlidar_mod.LiDAR4DField(tconfig.build_model_config(topt), device="cpu")
    jt = jtrainer_mod.Trainer("lidar4d", jopt, jfield, jconfig.build_loss_config(jopt),
                              workspace=jws, lidar_metrics=list(j_meters),
                              eval_interval=jopt.eval_interval, seed=jopt.seed, **kw)
    tt = ttrainer_mod.Trainer("lidar4d", topt, tfield, tconfig.build_loss_config(topt),
                              workspace=tws, lidar_metrics=list(t_meters),
                              eval_interval=topt.eval_interval, seed=topt.seed,
                              use_checkpoint="scratch")
    return jt, tt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


H, W, FRAMES, SEQ, RAYS = 32, 64, 6, "9000", 64
TINY = ["--num_rays_lidar", str(RAYS), "--num_steps", "24", "--num_coarse", "8",
        "--num_fine", "16", "--base_resolution", "8", "--max_resolution", "32",
        "--log2_hashmap_size", "8", "--n_levels_hash", "2", "--n_features_per_level_hash", "8",
        "--hash_size_dynamic", "8", "7", "7", "--n_levels_plane", "2", "--min_resolution", "8",
        "--time_resolution", "4", "--flow_n_levels", "2", "--flow_n_features", "8",
        "--flow_log2_hashmap_size", "8", "--flow_base_resolution", "8",
        "--flow_max_resolution", "16", "--plane_hash_scales", "1", "--plane_hash_log2", "7"]


def _jax_draws(key, step_fn, fov):
    """The JAX trainer step's draws for `key` (train_step.py: split(key, 3)
    into rays, render jitter and t_rand; rays.py for the patch indices;
    renderer.py for the jitter), for the port's step `step_fn`."""
    k_rays, k_perturb, k_flow = jax.random.split(key, 3)
    patch = (step_fn.px, step_fn.py) if step_fn.px > 1 else 1
    inds = np.asarray(jrays.get_lidar_rays(jnp.eye(4), fov, H, W, key=k_rays, N=RAYS,
                                           patch_size=patch)["inds"])
    n = inds.shape[0]
    draws = {"inds": inds, "t_rand": float(jax.random.uniform(k_flow))}
    if step_fn.num_coarse > 0:
        k1, k2, _ = jax.random.split(k_perturb, 3)
        draws["z_jitter"] = torch.from_numpy(np.array(
            jax.random.uniform(k1, (n, step_fn.num_coarse))))
        draws["u_jitter"] = torch.from_numpy(np.array(
            jax.random.uniform(k2, (n, step_fn.num_fine))))
    else:
        draws["z_jitter"] = torch.from_numpy(np.array(
            jax.random.uniform(k_perturb, (n, step_fn.num_steps))))
    return draws


def _moves(after, before):
    return np.concatenate([(np.asarray(a, np.float64) - b).ravel()
                           for a, b in zip(after, before)])


def test_two_trainer_epochs_match_jax(tmp_path, f32):
    root = str(tmp_path / "scene")
    scale, offset = generate_synthetic_sequence(root, sequence_id=SEQ, num_frames=FRAMES, H=H,
                                                W=W, val_every=3)
    argv = ["--config", "/nonexistent", "--path", root, "--sequence_id", SEQ,
            "--num_frames", str(FRAMES), "--scale", repr(scale), "--offset", *map(repr, offset),
            "--iters", "8", "--hier_warmup_iters", "4", "--eval_interval", "100", *TINY]
    jopt, topt = _options(argv)
    jt, tt = _trainers(jopt, topt, str(tmp_path / "jws"), str(tmp_path / "tws"),
                       use_checkpoint="scratch")
    init = jax.tree.map(np.array, jt.state.params)
    tt.state.params = interop.params_from_jax(tt.field, init)
    tt.state.opt_state = tt.optimizer.init(tt.state.params)
    tt.state.ema = ttrainer_mod.ema_init(tt.state.params)
    key = [jax.random.PRNGKey(jopt.seed + 1)]            # the JAX trainer's key chain

    def next_draws(step_fn):
        key[0], k = jax.random.split(key[0])
        return _jax_draws(k, step_fn, tuple(jopt.fov_lidar))

    tt._next_draws = next_draws
    kw = dict(root_path=root, sequence_id=SEQ, scale=scale, offset=offset,
              num_rays_lidar=RAYS)
    jds = {s: jkitti.KITTI360Dataset(split=s, **kw) for s in ("train", "val", "refine")}
    tds = {s: tkitti.KITTI360Dataset(split=s, **kw) for s in ("train", "val", "refine")}
    jt.train(jds["train"], jds["val"], jds["refine"], max_epochs=2, run_refine=False)
    # the port loads the flow cache the JAX trainer wrote under the shared name
    assert any(f.startswith("flow_cache_") for f in os.listdir(root))
    tt.train(tds["train"], tds["val"], tds["refine"], max_epochs=2, run_refine=False)

    assert jt.global_step == tt.global_step == 2 * len(tds["train"])
    assert sorted(tt._steps) == [(H, W, (1,), 0, 0), (H, W, (2, 8), 8, 16)]
    assert len(tt.stats["loss"]) == len(jt.stats["loss"]) == 2
    for a, b in zip(tt.stats["loss"], jt.stats["loss"]):
        assert np.isfinite(a) and _rel(a, b) <= EPOCH_LOSS_RTOL
    before = interop.tree_leaves(init)
    for got, want in ((tt.state.params, jt.state.params),
                      (tt.state.ema.shadow, jt.state.ema.shadow)):
        t = _moves(interop.tree_leaves(interop.tree_to_numpy(got)), before)
        j = _moves(jax.tree.leaves(want), before)
        assert t @ j / (np.linalg.norm(t) * np.linalg.norm(j)) >= MOVE_COS
        assert abs(np.linalg.norm(t) / np.linalg.norm(j) - 1) <= MOVE_NORM_RTOL
    assert tt.state.ema.num_updates == int(jt.state.ema.num_updates) == 2
    assert tt.state.opt_state.count == 2 * len(tds["train"])
