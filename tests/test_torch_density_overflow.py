"""The hazard behind the 10k URF run's non-finite stop (PERF.md), in
both packages, on the CPU at a tiny size.

`trunc_exp`'s forward is an unclamped exp in both packages, so a density-head
input above ~88.7 gives sigma = +inf. Then:
  * at a sample whose spacing to the next is exactly zero, `deltas * sigma`
    is 0 * inf = NaN, and so are the weights, the loss and the gradients:
    in both packages. A zero spacing is not rare: `sample_pdf` puts every
    fine sample whose u falls in the last coarse bin exactly on the last
    coarse sample (z_hi = z_lo there), and the merge keeps both;
  * elsewhere the port's stable sort and gather (`merge_sorted`) carry the
    +inf, whose alpha is 1, and the step stays finite; the reference's
    merge at train batch sizes permutes the samples with a one-hot matmul,
    a TPU workaround whose 0 * inf is NaN for every sample of the ray, so
    its step is non-finite as soon as one sigma overflows.

The state: the density head's output column scaled so that every sample's
sigma is +inf; one ray's last fine draw in the last coarse bin (the
trigger) or not (the control); the same draws in both packages (the JAX
step's `jax.random.uniform` / `randint` answer with them while it traces).
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu_torch.models.flow_field as tflow_mod
from lidar4d_tpu.models import lidar4d as jl
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.train import losses as jlosses
from lidar4d_tpu.train import optimizer as jopt
from lidar4d_tpu.train import train_step as jts
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.train import flow_cache as tfc
from lidar4d_tpu_torch.train import losses as tlosses
from lidar4d_tpu_torch.train import train_step as tts
from torch_threads import limit_under_xdist

limit_under_xdist()

H, W, FRAMES, SEQ = 16, 64, 6, "9000"
FOV = (2.0, 26.9)
RAYS, COARSE, FINE, ITERS, URF_STEP = 16, 8, 16, 100, 45
TINY = dict(
    base_resolution=8, max_resolution=32, log2_hashmap_size=8, n_levels_hash=2,
    n_features_per_level_hash=8, hash_size_dynamic=(8, 7, 7), n_levels_plane=2,
    min_resolution=8, time_resolution=4, num_frames=FRAMES, flow_n_levels=2,
    flow_n_features=8, flow_log2_hashmap_size=8, flow_base_resolution=8,
    flow_max_resolution=16, plane_hash_scales=1, plane_hash_log2=7,
)
HEAD_SCALE = 1e4            # the density head's output column: every head input >> 88.7


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    scale, offset = tsynth.generate_synthetic_sequence(root, sequence_id=SEQ, num_frames=FRAMES,
                                                       H=H, W=W, val_every=3)
    dk = dict(root_path=root, sequence_id=SEQ, scale=scale, offset=offset)
    random.seed(0)
    cache = tfc.build_flow_cache(tkitti.KITTI360Dataset(split="refine", **dk), scale, FRAMES)
    kw = dict(TINY, near_lidar=1.0 * scale, far_lidar=81.0 * scale)
    jf = jl.LiDAR4DField(jl.LiDAR4DConfig(**kw, remat_density=False, density_chunk=0))
    tf = tl.LiDAR4DField(tl.LiDAR4DConfig(**kw), device="cpu")
    params = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0)))
    head = np.array(params["sigma"][-1])
    head[:, 0] = HEAD_SCALE
    params["sigma"][-1] = head
    rng = np.random.default_rng(5)
    draws = {"inds": rng.integers(0, H * W, RAYS).astype(np.int32),
             "z_jitter": rng.uniform(0, 1, (RAYS, COARSE)).astype(np.float32),
             "u_jitter": rng.uniform(0, 0.9, (RAYS, FINE)).astype(np.float32),
             "t_rand": np.float32(0.3)}
    return dict(ds=tkitti.KITTI360Dataset(split="train", **dk), cache=cache, scale=scale,
                jf=jf, tf=tf, params=params, draws=draws)


def _nonfinite(metrics, grads, paths):
    return ([k for k in sorted(metrics) if not np.isfinite(metrics[k])]
            + [p for p, g in zip(paths, grads) if g is not None and not np.isfinite(g).all()])


def _loss_cfg(scale):
    return jlosses.LossConfig(flow_loss=True, grad_loss=True, scale=scale, num_frames=FRAMES,
                              iters=ITERS, urf_loss=True)


def _jax_step(s, draws):
    """(metrics, gradient leaves) of the JAX step on `draws`."""
    jf, params = s["jf"], s["params"]
    kw = dict(H=H, W=W, fov_lidar=FOV, num_rays=RAYS, num_coarse=COARSE, num_fine=FINE)
    inner = jopt.make_optimizer(1e-2, ITERS, jf.param_group_labels(params))

    def init(p):
        return {"inner": inner.init(p), "grads": jax.tree.map(jnp.zeros_like, p)}

    def update(g, st, p=None):
        u, st2 = inner.update(g, st["inner"], p)
        return u, {"inner": st2, "grads": g}

    spy = optax.GradientTransformation(init, update)
    jp = jax.tree.map(jnp.asarray, params)
    state = jts.TrainState(params=jp, opt_state=spy.init(jp), ema=None,
                           step=jnp.int32(URF_STEP))
    by_shape = {(RAYS, COARSE): draws["z_jitter"], (RAYS, FINE): draws["u_jitter"],
                (): draws["t_rand"]}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "uniform",
                  lambda key, shape=(), *a, **k: jnp.asarray(by_shape[tuple(shape)]))
        m.setattr(jax.random, "randint", lambda key, shape, *a, **k: jnp.asarray(draws["inds"]))
        step = jts.make_train_step(jf, spy, _loss_cfg(s["scale"]), **kw)
        state, metrics = step(state, jax.tree.map(jnp.asarray, s["ds"].frame(1)),
                              jax.tree.map(jnp.asarray, s["cache"]), jax.random.PRNGKey(0))
    jax.clear_caches()
    return ({k: float(v) for k, v in metrics.items()},
            [np.asarray(g) for g in jax.tree.leaves(state.opt_state["grads"])])


def _port_step(s, draws):
    tf = s["tf"]
    state, opt = tts.init_train_state(tf, lr=1e-2, iters=ITERS,
                                      params=interop.params_from_jax(tf, s["params"]))
    step = tts.make_train_step(tf, opt, tlosses.LossConfig(**vars(_loss_cfg(s["scale"]))), H=H,
                               W=W, fov_lidar=FOV, num_rays=RAYS, num_coarse=COARSE,
                               num_fine=FINE)
    td = {"inds": draws["inds"], "z_jitter": torch.from_numpy(draws["z_jitter"]),
          "u_jitter": torch.from_numpy(draws["u_jitter"]), "t_rand": float(draws["t_rand"])}
    grads, metrics = step.grads(state.params, s["ds"].frame(1),
                                tts.flow_cache_to_device(s["cache"], "cpu"), td, URF_STEP)
    return ({k: float(v) for k, v in metrics.items()},
            [None if g is None else g.numpy() for g in grads])


@pytest.fixture
def float32_mlps(monkeypatch):
    """Both packages' MLPs in float32 (the head's scaled column stays exact)."""
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    for mod, fn in ((jlidar_mod, j32), (jflow_mod, j32), (tl, t32), (tflow_mod, t32)):
        monkeypatch.setattr(mod, "apply_mlp", fn)


@pytest.mark.parametrize("trigger", [True, False], ids=["zero_spacing", "no_zero_spacing"])
def test_density_overflow_in_both_packages(setup, monkeypatch, float32_mlps, trigger):
    draws = {k: np.array(v) for k, v in setup["draws"].items()}
    if trigger:   # ray 0's last fine u in the last coarse bin: z = the last coarse z
        draws["u_jitter"][0, -1] = 0.99999
    paths = interop.tree_paths(interop.params_from_jax(setup["tf"], setup["params"]))
    port = _nonfinite(*_port_step(setup, draws), paths)
    jax_side = _nonfinite(*_jax_step(setup, draws), paths)
    # the reference: non-finite either way (its one-hot merge of a +inf sigma)
    assert "loss" in jax_side and "sigma.0" in jax_side
    if trigger:
        # the same non-finite loss terms; every leaf the reference's gradient
        # spoils, and the attribute heads besides (the reference's NaN
        # weights fail the renderer's weight > 1e-4 mask in every ray, so
        # no attribute reaches its loss; the port's finite rays keep theirs)
        assert "loss" in port and "urf_loss" in port and "lidar_loss" in port
        assert [k for k in port if "." not in k] == [k for k in jax_side if "." not in k]
        assert set(jax_side) <= set(port)
        assert set(port) - set(jax_side) <= {"intensity.0", "intensity.1", "intensity.2",
                                             "raydrop.0", "raydrop.1", "raydrop.2"}
    else:
        assert port == []
