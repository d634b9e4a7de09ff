"""Ray-parallel training and rendering (lidar4d_tpu_torch.parallel) on the CPU.

Two gloo ranks, a tiny field and scene (tests/test_torch_train.py's sizes).
One module fixture starts both ranks once (`parallel.launch`, a file://
rendezvous under the fixture's temporary directory, so that concurrent test
workers share no port), runs every sharded case there and takes the results
back through files:
  (a) the uniform-sampler step at patch 1 and the hierarchical steps at
      patch 2x8 and with the line-of-sight loss against the port's
      single-process step on the same draws: the loss within
      `LOSS_RTOL`, every gradient leaf within `GRAD_RTOL` of its largest
      entry, every post-step parameter within `PARAM_ATOL`, and the two
      ranks' post-step parameters bitwise equal;
  (b) the sharded uniform step against the JAX single-device
      `make_train_step` with the JAX step's own draws, at
      tests/test_torch_train.py's float32 tolerances (the JAX package's own
      sharded step equals its single step, tests/test_ray_dp.py);
  (c) `render_staged` over the two ranks against one process, with a chunk
      that does not split evenly, within `RENDER_RTOL`;
  (d) the (dcn, ici) = (1, 2) layout against the flat one;
  (e) a batch that does not split evenly over the ranks is refused;
and the sequence mesh of `parallel.multiseq`: each rank steps its own
sequence as a single-sequence step would.
Every step runs float32 MLPs: a bfloat16 GEMM over half the rows may round
differently. JAX is imported only where the JAX step runs: the ranks import
this module and need none of it.
"""

import functools
import os
import random

import numpy as np
import pytest
import torch

import lidar4d_tpu_torch.models.flow_field as tflow_mod
import lidar4d_tpu_torch.models.lidar4d as tlidar_mod
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.models.renderer import render_staged
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.parallel.launch import join_ranks, start_ranks
from lidar4d_tpu_torch.parallel.mesh import Mesh, make_hierarchical_mesh, make_mesh
from lidar4d_tpu_torch.parallel.multiseq import (
    init_multiseq_state,
    make_multiseq_train_step,
    make_seq_mesh,
)
from lidar4d_tpu_torch.train import flow_cache as tfc
from lidar4d_tpu_torch.train import train_step as tts
from lidar4d_tpu_torch.train.losses import LossConfig
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
HIERARCHICAL = dict(num_coarse=COARSE, num_fine=FINE)
# the uniform sampler at patch 1 (the trainer's warm-up), and hierarchical
# sampling at patch (2, 8) and with the line-of-sight loss
CASES = {"uniform": dict(patch_size=1, num_steps=COARSE + FINE),
         "patch": dict(patch_size=(2, 8), **HIERARCHICAL),
         "urf": dict(patch_size=1, urf_loss=True, **HIERARCHICAL)}
RANKS = 2
RENDER_RAYS, RENDER_CHUNK = 301, 128       # chunks of 128, 128 and 45 rays
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-5
RENDER_RTOL = 1e-6
TIMEOUT = 240


def _float32_mlps():
    f32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    tlidar_mod.apply_mlp = tflow_mod.apply_mlp = f32


def _field(scale):
    cfg = tl.LiDAR4DConfig(**TINY, near_lidar=1.0 * scale, far_lidar=81.0 * scale)
    return tl.LiDAR4DField(cfg, device="cpu")


def _step(inputs, case, draws, mesh):
    """One step of `case` from the inputs' parameters: (metrics, gradient
    leaves, post-step leaves) as numpy."""
    field = _field(inputs["scale"])
    state, opt = tts.init_train_state(field, lr=LR, iters=ITERS,
                                      params=interop.tree_to_torch(inputs["params"], "cpu"))
    kw = dict(CASES[case])
    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, urf_loss=kw.pop("urf_loss", False),
                          scale=inputs["scale"], num_frames=FRAMES, iters=ITERS)
    step = tts.make_train_step(field, opt, loss_cfg, H=H, W=W, fov_lidar=FOV, num_rays=RAYS,
                               mesh=mesh, **kw)
    cache = tts.flow_cache_to_device(inputs["cache"], "cpu")
    grads, metrics = step.grads(state.params, inputs["frame"], cache, draws, 0)
    opt.step(state.params, grads, state.opt_state)
    return ({k: float(v) for k, v in metrics.items()},
            [None if g is None else g.numpy() for g in grads],
            interop.tree_leaves(interop.tree_to_numpy(state.params)))


def _seq_steps(inputs, mesh):
    """One multi-sequence step of RANKS sequences (sequence s: the seeded
    init seed + s, train frame s), over the sequence mesh or, without it, as
    single-sequence steps: (losses, post-step leaves) of the sequences
    stepped here."""
    field = _field(inputs["scale"])
    loss_cfg = LossConfig(flow_loss=True, scale=inputs["scale"], num_frames=FRAMES,
                          iters=ITERS)
    kw = dict(H=H, W=W, fov_lidar=FOV, num_rays=RAYS, **HIERARCHICAL)
    cache = tts.flow_cache_to_device(inputs["cache"], "cpu")
    if mesh is not None:
        state, opt = init_multiseq_state(field, n_seq=RANKS, lr=LR, iters=ITERS, mesh=mesh)
        step = make_multiseq_train_step(field, opt, loss_cfg, mesh=mesh, seed=5, **kw)
        state, metrics = step(state, inputs["frames"], [cache] * RANKS)
        return ([float(v) for v in metrics["loss"]],
                [interop.tree_leaves(interop.tree_to_numpy(interop.tree_map(
                    lambda x, j=j: x[j], state.params))) for j in range(len(metrics["loss"]))])
    losses, leaves = [], []
    for s in range(RANKS):
        state, opt = tts.init_train_state(field, seed=s, lr=LR, iters=ITERS)
        step = tts.make_train_step(field, opt, loss_cfg, seed=5 + s, **kw)
        state, metrics = step(state, inputs["frames"][s], cache)
        losses.append(float(metrics["loss"]))
        leaves.append(interop.tree_leaves(interop.tree_to_numpy(state.params)))
    return losses, leaves


def _render(inputs, mesh):
    field = _field(inputs["scale"])
    params = interop.tree_to_torch(inputs["params"], "cpu")
    o, d = inputs["render_rays"]
    out = render_staged(field, params, o, d, np.float32(0.4), chunk=RENDER_CHUNK,
                        num_coarse=COARSE, num_fine=FINE, mesh=mesh)
    return {k: v.numpy() for k, v in out.items()}


def _rank_cases(rank, root):
    """Every sharded case on this rank (runs in the ranks' processes)."""
    _float32_mlps()
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    mesh = make_mesh(RANKS)
    out = {case: _step(inputs, case, inputs["draws"][case], mesh) for case in CASES}
    out["jax"] = _step(inputs, "uniform", inputs["jax_draws"], mesh)
    out["dcn_ici"] = _step(inputs, "uniform", inputs["draws"]["uniform"],
                           make_hierarchical_mesh(1, RANKS))
    out["own_hosts"] = make_hierarchical_mesh().shape      # hosts from the ranks' host names
    out["render"] = _render(inputs, mesh)
    out["multiseq"] = _seq_steps(inputs, make_seq_mesh(RANKS))
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def _signal_params(field):
    """The port's seeded init with O(0.1-1) hash and flow tables and time
    planes, so that every encoder moves the loss, as numpy (the JAX package's
    tree structure: `interop`)."""
    params = interop.tree_to_numpy(field.init(seed=0))
    rng = np.random.default_rng(1)
    for k in params["hash"]:
        params["hash"][k] = rng.uniform(-0.5, 0.5, params["hash"][k].shape).astype(np.float32)
    params["flow"]["grid"] = rng.uniform(-0.5, 0.5, params["flow"]["grid"].shape).astype(
        np.float32)
    for planes in params["planes"]:
        for ci in (2, 4, 5):
            planes[ci] = rng.uniform(0.5, 1.5, planes[ci].shape).astype(np.float32)
    return params


def _jax_step(inputs, key):
    """The JAX package's single-device step (float32, as
    tests/test_torch_train.py runs it) from the inputs' parameters, frame
    and cache; returns (field, metrics, gradient leaves, post-step leaves)."""
    import jax
    import jax.numpy as jnp

    import test_torch_train as ttt
    from lidar4d_tpu.models import lidar4d as jl
    from lidar4d_tpu.train import ema as jema
    from lidar4d_tpu.train import losses as jlosses
    from lidar4d_tpu.train import optimizer as jopt
    from lidar4d_tpu.train import train_step as jts

    scale, jparams = inputs["scale"], inputs["params"]
    jf = jl.LiDAR4DField(jl.LiDAR4DConfig(**TINY, near_lidar=1.0 * scale,
                                          far_lidar=81.0 * scale, remat_density=False,
                                          density_chunk=0))
    jloss = jlosses.LossConfig(flow_loss=True, grad_loss=True, scale=scale, num_frames=FRAMES,
                               iters=ITERS)
    spy = ttt._grad_spy(jopt.make_optimizer(LR, ITERS, jf.param_group_labels(jparams)))
    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = jts.TrainState(params=jp, opt_state=spy.init(jp), ema=jema.ema_init(jp),
                            step=jnp.int32(0))
    jstep = jts.make_train_step(jf, spy, jloss, H=H, W=W, fov_lidar=FOV, num_rays=RAYS,
                                **CASES["uniform"])
    with pytest.MonkeyPatch.context() as mp:
        ttt._f32_everywhere(mp)
        try:
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, inputs["frame"]),
                               jax.tree.map(jnp.asarray, inputs["cache"]), key)
        finally:
            jax.clear_caches()
    return (jf, {k: float(v) for k, v in jm.items()},
            [np.asarray(g) for g in jax.tree.leaves(jstate.opt_state["grads"])],
            [np.asarray(p) for p in jax.tree.leaves(jstate.params)])


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The inputs, the single-process results (the JAX step's and the
    port's, computed while the ranks run) and every rank's results."""
    import jax

    from lidar4d_tpu.ops import rays as jrays

    root = str(tmp_path_factory.mktemp("ranks"))
    scale, offset = tsynth.generate_synthetic_sequence(root, sequence_id=SEQ, num_frames=FRAMES,
                                                       H=H, W=W, val_every=3)
    dk = dict(root_path=root, sequence_id=SEQ, scale=scale, offset=offset)
    train = tkitti.KITTI360Dataset(split="train", **dk)
    random.seed(0)
    cache = tfc.build_flow_cache(tkitti.KITTI360Dataset(split="refine", **dk), scale, FRAMES)
    field = _field(scale)
    inputs = dict(scale=scale, params=_signal_params(field), cache=cache, frame=train.frame(1),
                  frames=[train.frame(s) for s in range(RANKS)])
    key = jax.random.PRNGKey(7)
    draws = {}
    for i, (case, kw) in enumerate(CASES.items()):
        state, opt = tts.init_train_state(field, lr=LR, iters=ITERS)
        step = tts.make_train_step(field, opt, LossConfig(), H=H, W=W, fov_lidar=FOV,
                                   num_rays=RAYS, seed=i, **{k: v for k, v in kw.items()
                                                             if k != "urf_loss"})
        draws[case] = step.draw()
    # the JAX uniform step's draws for its key (tests/test_torch_train.py::_jax_draws)
    k_rays, k_perturb, k_flow = jax.random.split(key, 3)
    jax_draws = {
        "inds": np.asarray(jrays.get_lidar_rays(jax.numpy.eye(4), FOV, H, W, key=k_rays,
                                                N=RAYS)["inds"]),
        "t_rand": float(jax.random.uniform(k_flow)),
        "z_jitter": torch.from_numpy(np.array(jax.random.uniform(
            k_perturb, (RAYS, CASES["uniform"]["num_steps"]))))}
    gen = torch.Generator().manual_seed(3)
    rays_d = torch.nn.functional.normalize(torch.randn(RENDER_RAYS, 3, generator=gen), dim=1)
    inputs.update(draws=draws, jax_draws=jax_draws,
                  render_rays=(torch.zeros(RENDER_RAYS, 3) + 0.01, rays_d))
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    procs = start_ranks(_rank_cases, (root,), RANKS, f"file://{root}/rendezvous", "gloo",
                        threads=1)
    try:
        single = {"jax": _jax_step(inputs, key)}
        with pytest.MonkeyPatch.context() as mp:
            f32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
            mp.setattr(tlidar_mod, "apply_mlp", f32)
            mp.setattr(tflow_mod, "apply_mlp", f32)
            single.update({case: _step(inputs, case, draws[case], None) for case in CASES})
            single["render"] = _render(inputs, None)
            single["multiseq"] = _seq_steps(inputs, None)
    finally:
        join_ranks(procs, TIMEOUT)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(RANKS)]
    return dict(inputs=inputs, single=single, ranks=ranks)


def _relative(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def _hold_step(got, want, loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL, param_atol=PARAM_ATOL):
    (m_got, g_got, p_got), (m_want, g_want, p_want) = got, want
    assert sorted(m_got) == sorted(m_want)
    for k in m_want:
        assert abs(m_got[k] - m_want[k]) <= loss_rtol * abs(m_want[k]), (k, m_got[k], m_want[k])
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert (a is None) == (b is None), f"leaf {i}"
        if b is not None and b.any():
            assert _relative(a, b) <= grad_rtol, f"grad leaf {i}: {_relative(a, b)}"
    for i, (a, b) in enumerate(zip(p_got, p_want)):
        assert np.abs(a - b).max() <= param_atol, f"post-step leaf {i}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_single_process(sharded, case):
    """(a): the reduced step on each rank equals one process's step, and
    the ranks leave the step with bitwise equal parameters."""
    single = sharded["single"][case]
    r0, r1 = (r[case] for r in sharded["ranks"])
    assert ("urf_loss" in single[0]) == (case == "urf")
    assert ("grad_loss" in single[0]) == (case == "patch")
    _hold_step(r0, single)
    assert r0[0] == r1[0]
    for a, b in zip(r0[2], r1[2]):
        np.testing.assert_array_equal(a, b)


def test_sharded_step_matches_jax_single_device(sharded):
    """(b): the sharded uniform step against the JAX package's
    single-device step with its own draws, float32 on both sides."""
    import jax

    import test_torch_train as ttt

    jparams = sharded["inputs"]["params"]
    jf, jm, jg, jp = sharded["single"]["jax"]
    for rank in sharded["ranks"]:
        tm, tg, tp = rank["jax"]
        tg = [np.zeros(p.shape, np.float32) if g is None else g for g, p in zip(tg, tp)]
        ttt._check_step((jm, jg, jp, tm, tg, tp), jparams,
                        jax.tree.leaves(jf.param_group_labels(jparams)), ttt.F32_TOL,
                        {None: ttt.F32_GRAD_TOL, "intensity": ttt.F32_ATTR_GRAD_TOL,
                         "raydrop": ttt.F32_ATTR_GRAD_TOL})


def test_sharded_render_matches_single_process(sharded):
    """(c): a render whose last chunk (45 rays) does not split evenly."""
    want = sharded["single"]["render"]
    assert want["depth_lidar"].shape == (RENDER_RAYS,)
    for rank in sharded["ranks"]:
        for k in want:
            assert rank["render"][k].shape == want[k].shape
            assert _relative(rank["render"][k], want[k]) <= RENDER_RTOL, k


def test_hierarchical_mesh_matches_flat(sharded):
    """(d): rays split over (dcn, ici) jointly, sums reduced within the
    host's ranks, then across hosts: the flat layout's step. Without a host
    count the layout counts the ranks' hosts: one here."""
    for rank in sharded["ranks"]:
        assert rank["own_hosts"] == (1, RANKS)
        _hold_step(rank["dcn_ici"], rank["uniform"])


def test_seq_mesh_steps_each_rank_s_sequence(sharded):
    """Rank r holds and steps sequence r: its loss and post-step parameters
    are the single-sequence step's (to PARAM_ATOL: the plain scatter-adds
    add in a thread-dependent order)."""
    losses, leaves = sharded["single"]["multiseq"]
    for r, rank in enumerate(sharded["ranks"]):
        got_losses, got_leaves = rank["multiseq"]
        assert got_losses == [losses[r]]
        for a, b in zip(got_leaves[0], leaves[r]):
            assert np.abs(a - b).max() <= PARAM_ATOL
    assert losses[0] != losses[1]


@pytest.mark.parametrize("rays, patch", [(63, 1), (48, (2, 8))])
def test_uneven_batch_is_refused(rays, patch):
    """(e): 63 rays, or 3 patches of 2x8, over 2 ranks."""
    field = _field(0.01)
    state, opt = tts.init_train_state(field)
    mesh = Mesh(("data",), (RANKS,), 0)
    with pytest.raises(ValueError, match="split evenly over 2 ranks"):
        tts.make_train_step(field, opt, LossConfig(), H=H, W=W, fov_lidar=FOV, num_rays=rays,
                            patch_size=patch, mesh=mesh)
