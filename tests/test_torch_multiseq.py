"""Multi-sequence training (lidar4d_tpu_torch.parallel.multiseq) on the CPU.

S = 2 fields of the tiny config (tests/test_torch_train.py's sizes): the
stacked init carried over from the JAX package's `init_multiseq_state`
through `interop` (init only, no JAX step), the port's own seeded stacked
init, and the multi-sequence step against S single-sequence steps, bitwise
(the same operations in the same order on the same inputs; on one torch
thread, since the plain versions' scatter-adds add in an order that depends
on the threads). The sequence mesh, one block of sequences a rank, runs in
tests/test_torch_parallel.py.
"""

import random

import jax
import numpy as np
import pytest
import torch

from lidar4d_tpu.models import lidar4d as jl
from lidar4d_tpu.parallel.multiseq import init_multiseq_state as jax_init_multiseq_state
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.parallel.multiseq import init_multiseq_state, make_multiseq_train_step
from lidar4d_tpu_torch.train import flow_cache as tfc
from lidar4d_tpu_torch.train import train_step as tts
from lidar4d_tpu_torch.train.losses import LossConfig
from torch_threads import limit_under_xdist

limit_under_xdist()

H, W, FRAMES, SEQ, S = 16, 64, 6, "9000", 2
FOV = (2.0, 26.9)
RAYS, COARSE, FINE = 64, 8, 16
LR, ITERS, STEPS = 1e-2, 100, 2
TINY = dict(
    base_resolution=8, max_resolution=32, log2_hashmap_size=8, n_levels_hash=2,
    n_features_per_level_hash=8, hash_size_dynamic=(8, 7, 7), n_levels_plane=2,
    min_resolution=8, time_resolution=4, num_frames=FRAMES, flow_n_levels=2,
    flow_n_features=8, flow_log2_hashmap_size=8, flow_base_resolution=8,
    flow_max_resolution=16, plane_hash_scales=1, plane_hash_log2=7,
)
SCALE = 0.01


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX package's stacked init for S sequences, as numpy."""
    cfg = jl.LiDAR4DConfig(**TINY, near_lidar=1.0 * SCALE, far_lidar=81.0 * SCALE,
                           remat_density=False, density_chunk=0)
    field = jl.LiDAR4DField(cfg)
    params = jax.jit(lambda key: jax_init_multiseq_state(field, key, S)[0].params)(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _field(scale=SCALE):
    cfg = tl.LiDAR4DConfig(**TINY, near_lidar=1.0 * scale, far_lidar=81.0 * scale)
    return tl.LiDAR4DField(cfg, device="cpu")


def test_stacked_init_from_jax(jax_stack):
    field = _field()
    state, _ = init_multiseq_state(field, n_seq=S, params=interop.stacked_params_from_jax(
        field, jax_stack))
    leaves = interop.tree_leaves(state.params)
    want = jax.tree.leaves(jax_stack)
    assert len(leaves) == len(want)
    for got, ref in zip(leaves, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(want[0][0], want[0][1])          # S seeded inits
    for m, v in zip(state.opt_state.mu, state.opt_state.nu):
        assert m.shape[0] == S and not m.any() and not v.any()
    for a, b in zip(interop.tree_leaves(state.ema.shadow), leaves):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert state.step == 0 and state.opt_state.count == 0
    with pytest.raises(ValueError, match="does not match the field"):
        interop.stacked_params_from_jax(_field(), {**jax_stack, "sigma": jax_stack["sigma"][:1]})


def test_own_stacked_init_is_s_seeded_inits(jax_stack):
    field = _field()
    state, _ = init_multiseq_state(field, seed=3, n_seq=S)
    for got, ref in zip(interop.tree_leaves(state.params), jax.tree.leaves(jax_stack)):
        assert tuple(got.shape) == ref.shape
    for s in range(S):
        for got, one in zip(interop.tree_leaves(state.params),
                            interop.tree_leaves(field.init(3 + s))):
            assert torch.equal(got[s], one)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multiseq_step_equals_single_steps(jax_stack, tmp_path, one_thread):
    """STEPS steps of both sequences (a different frame each) against each
    sequence's own single-sequence step from the same parameters and seed:
    every metric and post-step leaf bitwise equal."""
    scale, offset = tsynth.generate_synthetic_sequence(str(tmp_path), sequence_id=SEQ,
                                                       num_frames=FRAMES, H=H, W=W, val_every=3)
    dk = dict(root_path=str(tmp_path), sequence_id=SEQ, scale=scale, offset=offset)
    random.seed(0)
    cache = tts.flow_cache_to_device(
        tfc.build_flow_cache(tkitti.KITTI360Dataset(split="refine", **dk), scale, FRAMES), "cpu")
    ds = tkitti.KITTI360Dataset(split="train", **dk)
    frames = [ds.frame(s) for s in range(S)]
    field = _field(scale)
    loss_cfg = LossConfig(flow_loss=True, scale=scale, num_frames=FRAMES, iters=ITERS)
    kw = dict(H=H, W=W, fov_lidar=FOV, num_rays=RAYS, num_coarse=COARSE, num_fine=FINE, seed=5)

    stack = interop.stacked_params_from_jax(field, jax_stack)
    state, opt = init_multiseq_state(field, n_seq=S, lr=LR, iters=ITERS, params=stack)
    step = make_multiseq_train_step(field, opt, loss_cfg, **kw)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, frames, [cache] * S)
        assert metrics["loss"].shape == (S,)
        losses.append(metrics)
    assert state.step == STEPS and state.opt_state.count == STEPS
    assert not torch.equal(losses[-1]["loss"][0], losses[-1]["loss"][1])

    for s in range(S):
        one, opt1 = tts.init_train_state(field, lr=LR, iters=ITERS, params=interop.tree_map(
            lambda x: x[s].clone(), interop.stacked_params_from_jax(field, jax_stack)))
        single = tts.make_train_step(field, opt1, loss_cfg, **{**kw, "seed": kw["seed"] + s})
        for i in range(STEPS):
            one, m = single(one, frames[s], cache)
            for k in m:
                assert torch.equal(m[k], losses[i][k][s]), (s, i, k)
        for got, want in zip(interop.tree_leaves(state.params), interop.tree_leaves(one.params)):
            assert torch.equal(got[s], want)
        for got, want in zip(state.opt_state.mu, one.opt_state.mu):
            assert torch.equal(got[s], want)
