"""The U-Net's training mode and the refine stage (lidar4d_tpu_torch.models.unet,
lidar4d_tpu_torch.train.refine) against the JAX package on the CPU.

Every random draw of the JAX side (Dropout2d keep masks, the attention drop
mask, the refine stage's boxes) is rebuilt here from its key, exactly as
`lidar4d_tpu/models/unet.py` and `lidar4d_tpu/train/refine.py` split and
use it, and fed to the port.

Tolerances, and why (float32 in both packages; the convolutions, the
bilinear upsample and the attention sum in different orders):
  * one training forward: probabilities `PROB_ATOL` (1e-4 absolute on
    [0, 1], the eval-mode test's tolerance; measured 2.3e-5), new
    BatchNorm statistics `STATE_RTOL` of each leaf's largest magnitude
    (1e-5; measured <= 2e-6);
  * the schedules over 1000 steps: `SCHED_RTOL` of the schedule's peak
    (1e-6; float32 cos in numpy against XLA's; measured 1.2e-7);
  * the refine stage's Adam against optax on the same gradients, 1000
    steps: `ADAM_RTOL` of each leaf's largest magnitude (1e-6; measured
    8.4e-8);
  * refine steps. The U-Net's float32 gradient is not a smooth function of
    rounding: a max-pool winner or a ReLU gate within rounding of a tie
    moves whole contributions, so the two packages' gradients part by far
    more than rounding. Adam's first moves are lr x sign(g), so their
    parameters part where |g| is that small. Held: the
    first step's BCE `LOSS0_RTOL` (1e-5; measured 1.4e-6), later steps'
    `LOSS_RTOL` (1e-3; measured <= 1.8e-4, against a fall of ~1.5% a
    step); the parameter moves' cosine >= `MOVE_COS` (0.98; measured
    0.992), norm ratio within `MOVE_NORM_RTOL` (1e-3; measured 6.6e-5) and
    same-sign share >= `MOVE_SIGN_SHARE` (0.98; measured 0.993); the
    BatchNorm state after one step, which depends on the initial
    parameters alone, `STATE_RTOL`, and after three `STATE3_RTOL` (0.1;
    measured 0.03).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar4d_tpu.models.unet import UNet as JUNet
from lidar4d_tpu.train import refine as jrefine
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.models.unet import UNet as TUNet
from lidar4d_tpu_torch.train import refine as trefine
from torch_threads import limit_under_xdist

limit_under_xdist()

B, H, W = 2, 32, 64
PROB_ATOL = 1e-4
STATE_RTOL = 1e-5
SCHED_RTOL = 1e-6
LOSS0_RTOL = 1e-5
LOSS_RTOL = 1e-3
STATE3_RTOL = 0.1
MOVE_COS = 0.98
MOVE_NORM_RTOL = 1e-3
MOVE_SIGN_SHARE = 0.98
ADAM_RTOL = 1e-6


@pytest.fixture(scope="module")
def unet():
    """Both U-Nets with the JAX init (numpy), an input batch and its
    ground-truth ray-drop."""
    jvars = jax.tree.map(np.asarray, JUNet().init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(B, 3, H, W)).astype(np.float32)
    gt = (rng.uniform(size=(B, 1, H, W)) > 0.3).astype(np.float32)
    # running statistics away from the init's (0, 1)
    jvars["state"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), jvars["state"])
    return JUNet(), TUNet(), jvars, x, gt


def _jax_masks(tunet, key, x_shape, rate=0.1):
    """The keep masks and attention drop mask JAX UNet.apply(train=True,
    key=key) draws (unet.py: split(key, 10); DoubleConv i splits keys[i]
    in two; the attention takes keys[4]; up i takes keys[5 + i])."""
    keep_shapes, attn_shape = tunet.dropout_shapes(x_shape)
    keys = jax.random.split(key, 10)
    keeps = []
    for i in (0, 1, 2, 3, 5, 6, 7, 8):
        k1, k2 = jax.random.split(keys[i])
        j = len(keeps)
        keeps += [np.asarray(jax.random.bernoulli(k1, 1.0 - rate, keep_shapes[j])),
                  np.asarray(jax.random.bernoulli(k2, 1.0 - rate, keep_shapes[j + 1]))]
    attn = np.asarray(jax.random.bernoulli(keys[4], rate, attn_shape))
    return [torch.from_numpy(k.copy()) for k in keeps], torch.from_numpy(attn.copy())


def _jax_boxes(key, shape, box_num_max=32):
    """The draws of JAX `_random_box_mask(key, shape)`."""
    _, _, h, w = shape
    by_max, bx_max = max(int(0.1 * h), 2), max(int(0.1 * w), 2)
    keys = jax.random.split(key, 5)
    return tuple(np.array(v) for v in (
        jax.random.randint(keys[0], (), 0, box_num_max),
        jax.random.randint(keys[1], (box_num_max,), 0, h - by_max),
        jax.random.randint(keys[2], (box_num_max,), 0, w - bx_max),
        jax.random.randint(keys[3], (box_num_max,), 1, by_max),
        jax.random.randint(keys[4], (box_num_max,), 1, bx_max)))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_unet_train_apply_matches_jax(unet):
    """One training forward with the JAX masks: probabilities and the new
    BatchNorm state (batch statistics, momentum 0.1, unbiased variance)."""
    ju, tu, jvars, x, _ = unet
    key = jax.random.PRNGKey(3)
    want, want_state = ju.apply(jax.tree.map(jnp.asarray, jvars), jnp.asarray(x), train=True,
                                key=key)
    keeps, attn = _jax_masks(tu, key, x.shape)
    assert attn.any() and not all(k.all() for k in keeps)
    got, got_state = tu.apply_train(interop.tree_to_torch(jvars, "cpu"), torch.from_numpy(x),
                                    keeps=keeps, attn_drop=attn)
    assert got.shape == (B, 1, H, W)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=PROB_ATOL)
    got_leaves = interop.tree_leaves(interop.tree_to_numpy(got_state))
    want_leaves = jax.tree.leaves(want_state)
    assert len(got_leaves) == len(want_leaves) == 2 * 18       # 18 BatchNorms
    for a, b in zip(got_leaves, want_leaves):
        assert _max_rel(a, b) <= STATE_RTOL
    # eval mode is unchanged by the training mode's arguments
    ev = tu.apply(interop.tree_to_torch(jvars, "cpu"), torch.from_numpy(x))
    jev, _ = ju.apply(jax.tree.map(jnp.asarray, jvars), jnp.asarray(x), train=False)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=0, atol=PROB_ATOL)


def test_unet_draws_its_own_masks(unet):
    _, tu, jvars, x, _ = unet
    g = torch.Generator()
    g.manual_seed(0)
    keeps, attn = tu.draw_dropout(x.shape, g)
    shapes, attn_shape = tu.dropout_shapes(x.shape)
    assert [tuple(k.shape) for k in keeps] == shapes and tuple(attn.shape) == attn_shape
    kept = torch.cat([k.reshape(-1) for k in keeps]).float().mean().item()
    assert 0.8 < kept < 0.97 and 0.05 < attn.float().mean().item() < 0.15
    variables = interop.tree_to_torch(jvars, "cpu")
    g.manual_seed(1)
    a, sa = tu.apply_train(variables, torch.from_numpy(x), generator=g)
    g.manual_seed(1)
    b, sb = tu.apply_train(variables, torch.from_numpy(x), generator=g)
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip(interop.tree_leaves(sa),
                                                  interop.tree_leaves(sb)))


def test_onecycle_schedules_match_jax():
    steps = np.arange(1000)
    for t_fn, j_fn in ((trefine.onecycle_lr(1e-3, 1000), jrefine.onecycle_lr(1e-3, 1000)),
                       (trefine.onecycle_b1(1000), jrefine.onecycle_b1(1000))):
        got = np.array([t_fn(s) for s in steps])
        want = np.asarray(j_fn(jnp.asarray(steps)))
        assert got.dtype == np.float32
        assert _max_rel(got, want) <= SCHED_RTOL
    lr = trefine.onecycle_lr(1e-3, 1000)
    assert lr(0) == pytest.approx(4e-5, rel=1e-5) and lr(299) == pytest.approx(1e-3, rel=1e-5)
    assert lr(999) < 1e-8


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_random_box_mask_matches_jax(seed):
    shape = (B, 3, H, W)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jrefine._random_box_mask(key, shape))
    boxes = _jax_boxes(key, shape)
    got = trefine._random_box_mask(shape, boxes)
    assert got.shape == (1, 1, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(boxes[0]) == 0 or (want == 0).any()


def test_random_box_mask_own_draws():
    g = torch.Generator()
    g.manual_seed(0)
    count, ys, xs, hs, ws = trefine.draw_boxes((1, 3, 66, 1030), g)
    by_max, bx_max = trefine.box_limits(66, 1030)
    assert (by_max, bx_max) == (6, 103)
    assert 0 <= int(count) < 32
    assert int(ys.max()) < 66 - by_max and int(xs.max()) < 1030 - bx_max
    assert 1 <= int(hs.min()) and int(hs.max()) < by_max and int(ws.max()) < bx_max
    g.manual_seed(0)
    mask = trefine._random_box_mask((1, 3, 66, 1030), generator=g)
    zeroed = int((mask == 0).sum())
    assert zeroed <= int(count) * (by_max - 1) * (bx_max - 1)


def _run_refine(unet, steps, lr=1e-3, key=11):
    """refine_unet of both packages from the same U-Net and batch, the JAX
    draws fed to the port. Returns (JAX log, JAX result, port log, port
    result, port input variables)."""
    ju, tu, jvars, x, gt = unet
    key = jax.random.PRNGKey(key)
    j_log, t_log = [], []
    want = jrefine.refine_unet(ju, jax.tree.map(jnp.asarray, jvars), jnp.asarray(x),
                               jnp.asarray(gt), steps=steps, lr=lr, key=key,
                               log_fn=j_log.append, log_every=1)
    draws, k = [], key
    for _ in range(steps):
        k, k_step = jax.random.split(k)
        k_mask, k_drop = jax.random.split(k_step)
        keeps, attn = _jax_masks(tu, k_drop, x.shape)
        draws.append({"boxes": _jax_boxes(k_mask, x.shape), "keeps": keeps, "attn_drop": attn})
    tvars = interop.tree_to_torch(jvars, "cpu")
    got = trefine.refine_unet(tu, tvars, torch.from_numpy(x), torch.from_numpy(gt), steps=steps,
                              lr=lr, draws=draws.__getitem__, log_fn=t_log.append, log_every=1)
    return j_log, want, t_log, got, tvars


def _bce(line):
    return float(line.split()[-1])


def _updates(got, want, jvars):
    """The port's and the JAX package's parameter moves, flattened."""
    t = np.concatenate([(a - p0).ravel() for a, p0 in zip(
        interop.tree_leaves(interop.tree_to_numpy(got["params"])),
        jax.tree.leaves(jvars["params"]))])
    j = np.concatenate([(np.asarray(a) - p0).ravel() for a, p0 in zip(
        jax.tree.leaves(want["params"]), jax.tree.leaves(jvars["params"]))])
    return t, j


@pytest.mark.parametrize("steps", [1, 3])
def test_refine_unet_matches_jax(unet, steps):
    """1 and 3 refine steps from the same U-Net and batch, with the JAX
    draws: the BCE of each step, the parameter moves, and (after one step,
    which depends on the initial parameters alone) the BatchNorm state."""
    ju, tu, jvars, x, gt = unet
    lr = 1e-3
    j_log, want, t_log, got, tvars = _run_refine(unet, steps, lr)
    # the input variables are left as they were
    for a, b in zip(interop.tree_leaves(interop.tree_to_numpy(tvars)), jax.tree.leaves(jvars)):
        np.testing.assert_array_equal(a, b)

    assert [line.split(":")[0] for line in t_log] == [line.split(":")[0] for line in j_log]
    assert len(t_log) == steps
    assert abs(_bce(t_log[0]) - _bce(j_log[0])) <= LOSS0_RTOL * _bce(j_log[0])
    for a, b in zip(t_log[1:], j_log[1:]):
        assert abs(_bce(a) - _bce(b)) <= LOSS_RTOL * _bce(b)
    assert _bce(t_log[-1]) < _bce(t_log[0]) or steps == 1

    t, j = _updates(got, want, jvars)
    assert np.abs(t).max() <= 2 * lr * steps and np.abs(j).max() <= 2 * lr * steps
    assert t @ j / (np.linalg.norm(t) * np.linalg.norm(j)) >= MOVE_COS
    assert abs(np.linalg.norm(t) / np.linalg.norm(j) - 1) <= MOVE_NORM_RTOL
    assert np.mean(np.sign(t) == np.sign(j)) >= MOVE_SIGN_SHARE

    state_tol = STATE_RTOL if steps == 1 else STATE3_RTOL
    for a, b in zip(interop.tree_leaves(interop.tree_to_numpy(got["state"])),
                    jax.tree.leaves(want["state"])):
        assert _max_rel(a, b) <= state_tol


def test_adam_update_matches_optax():
    """The refine stage's Adam (`adam_update`) against
    optax.inject_hyperparams(optax.adam) with the one-cycle lr and b1 over
    1000 steps of the same random gradients."""
    import optax

    steps = 1000
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((7, 3), (5,), (2, 2, 3))]
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=jrefine.onecycle_lr(1e-3, steps),
                                               b1=jrefine.onecycle_b1(steps))
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    update = jax.jit(opt.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    mu = [torch.zeros_like(p) for p in tp]
    nu = [torch.zeros_like(p) for p in tp]
    lr_fn, b1_fn = trefine.onecycle_lr(1e-3, steps), trefine.onecycle_b1(steps)
    worst = 0.0
    for i in range(steps):
        grads = [(rng.normal(size=p.shape) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
                 for p in params]
        u, js = update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, u)
        trefine.adam_update(tp, [torch.from_numpy(g) for g in grads], mu, nu, i, lr_fn(i),
                            b1_fn(i))
        if i % 100 == 99:
            for a, b in zip(tp, jp):
                worst = max(worst, _max_rel(a.numpy(), np.asarray(b)))
    assert worst <= ADAM_RTOL
