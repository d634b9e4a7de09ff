"""The port's ops (lidar4d_tpu_torch.ops) against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages as the same float32
arrays. On the CPU every kernel wrapper of the port runs its plain PyTorch
version, and the JAX package runs its gather path (its Pallas kernels engage
only on a TPU), so these hold the algorithms to each other in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar4d_tpu.ops import grid_sample as jgs
from lidar4d_tpu.ops import hash_enc as jhe
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.ops import pano as jpano
from lidar4d_tpu.ops import rays as jrays
from lidar4d_tpu.ops.trunc_exp import trunc_exp as jtrunc_exp
from lidar4d_tpu_torch.ops import grid_sample as tgs
from lidar4d_tpu_torch.ops import hash_enc as the
from lidar4d_tpu_torch.ops import hash_onehot as tho
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.ops import pano as tpano
from lidar4d_tpu_torch.ops import plane_onehot as tpo
from lidar4d_tpu_torch.ops import rays as trays
from lidar4d_tpu_torch.ops import trunc_exp as tte
from torch_threads import limit_under_xdist

limit_under_xdist()

# (n_dims, n_levels, n_features, log2, base, max): every kind of level
SPECS = {
    "3d_hashed": (3, 3, 4, 8, 16, 64),
    "3d_dense": (3, 2, 2, 12, 4, 8),
    "3d_mixed": (3, 3, 8, 8, 4, 16),
    "2d_hashed": (2, 3, 2, 6, 16, 64),
    "2d_dense": (2, 2, 8, 8, 4, 8),
    "2d_mixed": (2, 3, 4, 7, 4, 32),
}


def _specs(key):
    d, l, f, lg, b, m = SPECS[key]
    kw = dict(n_dims=d, n_levels=l, n_features=f, log2_hashmap_size=lg,
              base_resolution=b, max_resolution=m)
    return jhe.HashEncoderSpec(**kw), the.HashEncoderSpec(**kw)


def _points(seed, n, d, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)


def _table(seed, rows, f):
    return np.random.default_rng(seed).uniform(-1, 1, (rows, f)).astype(np.float32)


def test_specs_cover_dense_and_hashed_levels():
    for key in SPECS:
        _, spec = _specs(key)
        dense = [s == (r + 1) ** spec.n_dims for r, s in zip(spec.resolutions, spec.table_sizes)]
        kind = key.split("_")[1]
        assert {"hashed": not any(dense), "dense": all(dense),
                "mixed": any(dense) and not all(dense)}[kind], key


@pytest.mark.parametrize("key", sorted(SPECS))
def test_spec_geometry_matches_jax(key):
    js, ts = _specs(key)
    assert ts.resolutions == js.resolutions
    assert ts.table_sizes == js.table_sizes
    assert ts.level_offsets == js.level_offsets
    assert ts.n_rows == js.n_rows


@pytest.mark.parametrize("key", sorted(SPECS))
def test_level_indices_bit_identical(key):
    js, ts = _specs(key)
    x = _points(1, 513, js.n_dims)
    x[:4] = [[0.0] * js.n_dims, [1.0] * js.n_dims, [0.5] * js.n_dims,
             [1.0 - 1e-7] * js.n_dims]
    for level in range(js.n_levels):
        jidx, jw = jhe._level_indices(js, jnp.asarray(x), level)
        tidx, tw = the._level_indices(ts, torch.from_numpy(x), level)
        np.testing.assert_array_equal(tidx.numpy(), np.stack([np.asarray(i) for i in jidx]))
        np.testing.assert_array_equal(tw.numpy(), np.stack([np.asarray(w) for w in jw]))


@pytest.mark.parametrize("key", sorted(SPECS))
def test_hash_encode_matches_jax(key):
    js, ts = _specs(key)
    x = _points(2, 400, js.n_dims)
    table = _table(3, js.n_rows, js.n_features)
    want = np.asarray(jhe.hash_encode(js, jnp.asarray(table), jnp.asarray(x)))
    got = tho.hash_encode_auto(ts, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    # same gathers and weights; only the order of the corner sum may differ
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_lagrange_weights_match_jax(t):
    np.testing.assert_allclose(the.lagrange_weights(t, 4),
                               np.asarray(jhe.lagrange_weights(jnp.float32(t), 4)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("key", ["3d_hashed", "3d_mixed", "2d_dense", "2d_mixed"])
@pytest.mark.parametrize("t", [0.0, 0.61, 1.0])
def test_hash_encode_folded_matches_encode_then_interp(key, t):
    """interpT(Encode(T, x), t) == Encode(fold(T, w(t)), x): the port folds
    the table; the reference encodes then interpolates. Reassociation of
    one linear contraction: float32 rounding only (1e-5 of the scale)."""
    js, ts = _specs(key)
    nb = 2 if js.n_features == 2 else 4
    x = _points(4, 300, js.n_dims)
    table = _table(5, js.n_rows, js.n_features)
    g = jhe.hash_encode(js, jnp.asarray(table), jnp.asarray(x))
    want = np.asarray(jhe.lagrange_time_interp(g, jnp.float32(t), js.n_levels,
                                               js.n_features, nb))
    w = torch.from_numpy(the.lagrange_weights(t, nb))
    got = tho.hash_encode_folded(ts, torch.from_numpy(table), torch.from_numpy(x), w).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    auto = tho.hash_encode_interp_auto(ts, torch.from_numpy(table), torch.from_numpy(x), t, nb)
    np.testing.assert_array_equal(auto.numpy(), got)


def test_hash_grid_fwd_plain_stacks_variants():
    _, ts = _specs("2d_mixed")
    tables = np.stack([_table(10 + v, ts.n_rows, ts.n_features) for v in range(3)])
    xs = np.stack([_points(20 + v, 200, 2) for v in range(3)])
    out = tho.hash_grid_fwd(ts, torch.from_numpy(tables), torch.from_numpy(xs))
    assert out.shape == (3, 200, ts.n_output_dims)
    for v in range(3):
        np.testing.assert_array_equal(
            out[v].numpy(),
            the.hash_encode(ts, torch.from_numpy(tables[v]), torch.from_numpy(xs[v])).numpy())


def test_hash_grid_fwd_rejects_mismatched_shapes():
    _, ts = _specs("3d_hashed")
    with pytest.raises(ValueError):
        tho.hash_grid_fwd(ts, torch.zeros(1, ts.n_rows + 1, ts.n_features), torch.zeros(1, 5, 3))


@pytest.mark.parametrize("key", sorted(SPECS))
def test_eligibility_rules(key):
    _, ts = _specs(key)
    assert tho.onehot_eligible(ts)
    assert tho.folded_eligible(ts, 2)
    assert tho.folded_eligible(ts, 4) is (ts.n_features % 4 == 0)
    assert not tho.onehot_eligible(the.HashEncoderSpec(n_features=3))
    assert not tho.onehot_eligible(the.HashEncoderSpec(n_levels=17))


@pytest.mark.parametrize("hw", [(8, 8), (5, 13), (32, 32)])
def test_plane_bilinear_plain_matches_grid_sample_2d(hw):
    H, W = hw
    rng = np.random.default_rng(H * W)
    grid = rng.uniform(0.1, 0.5, (3, 8, H, W)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (3, 333, 2)).astype(np.float32)    # border clamp too
    want = np.stack([np.asarray(jgs.grid_sample_2d(jnp.asarray(g), jnp.asarray(p))).T
                     for g, p in zip(grid, pts)])
    got = tpo.plane_bilinear(torch.from_numpy(grid), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    idx, wgt = tgs.bilinear_corners(H, W, torch.from_numpy(pts[0]))
    jidx, jwgt = jgs.bilinear_corners(H, W, jnp.asarray(pts[0]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(wgt.numpy(), np.asarray(jwgt))


@pytest.mark.parametrize("width", [2, 32, 256])
def test_plane_linear_plain_matches_explicit_lerp(width):
    """plain plane_linear vs an explicit float32 lerp in numpy: 1e-5 relative."""
    rng = np.random.default_rng(width)
    grid = rng.uniform(0.1, 1.0, (9, 8, width)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (9, 301)).astype(np.float32)
    x[:, :3] = [0.0, 1.0, 0.5]
    u = np.clip(x, 0.0, 1.0).astype(np.float32) * np.float32(width - 1)
    j0 = np.clip(np.floor(u).astype(np.int64), 0, width - 1)
    j1 = np.minimum(j0 + 1, width - 1)
    f = (u - j0.astype(np.float32))[..., None]
    g0 = np.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = np.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    want = (np.float32(1.0) - f) * g0 + f * g1
    got = tpo.plane_linear(torch.from_numpy(grid), torch.from_numpy(x)).numpy()
    assert got.shape == (9, 301, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_apply_mlp_and_trunc_exp_match_jax():
    rng = np.random.default_rng(7)
    params = tmlp.init_mlp(rng, [20, 64, 64, 3])
    x = rng.normal(size=(257, 20)).astype(np.float32)
    want = np.asarray(jmlp.apply_mlp([jnp.asarray(w) for w in params], jnp.asarray(x)))
    got = tmlp.apply_mlp([torch.from_numpy(w) for w in params], torch.from_numpy(x)).numpy()
    # bf16 activations in both; accumulation order differs -> bf16-level agreement
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    got32 = tmlp.apply_mlp([torch.from_numpy(w) for w in params], torch.from_numpy(x),
                           dtype=torch.float32).numpy()
    want32 = np.asarray(jmlp.apply_mlp([jnp.asarray(w) for w in params], jnp.asarray(x),
                                       dtype=jnp.float32))
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-5)
    z = rng.normal(size=(100,)).astype(np.float32) * 5
    np.testing.assert_allclose(tte.trunc_exp(torch.from_numpy(z)).numpy(),
                               np.asarray(jtrunc_exp(jnp.asarray(z))), rtol=1e-6)


def test_init_mlp_distributions():
    rng = np.random.default_rng(0)
    w0, w1 = tmlp.init_mlp(rng, [100, 400, 6], final_init_std=0.001)
    assert w0.dtype == np.float32 and w0.shape == (100, 400)
    assert np.abs(w0).max() <= (6.0 / 100) ** 0.5
    assert abs(w1.std() - 0.001) < 2e-4


def test_pano_rays_and_back_projection_match_jax():
    H, W, fov = 6, 40, (2.0, 26.9)
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    want = np.asarray(jrays.pano_ray_directions(jnp.asarray(i), jnp.asarray(j), H, W, *fov))
    np.testing.assert_allclose(trays.pano_ray_directions(i, j, H, W, *fov), want, atol=1e-6)
    rng = np.random.default_rng(3)
    pano = rng.uniform(0, 10, (H, W)) * (rng.uniform(size=(H, W)) > 0.3)
    inten = rng.uniform(size=(H, W))
    np.testing.assert_array_equal(tpano.pano_to_lidar_with_intensities(pano, inten, fov),
                                  jpano.pano_to_lidar_with_intensities(pano, inten, fov))


# ------------------------------------------------------- backward contracts
# Each gradient of the port's autograd.Functions (plain versions on the CPU)
# against jax.grad of the reference's float32 oracles (`hash_enc.hash_encode`
# + the Lagrange contraction, `grid_sample_2d`, an explicit float32 lerp).
# Same gathers and weights, scattered in another order: 1e-5 of the scale.
GRAD_TOL = 1e-5


def _rel_close(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= tol


def _cot(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("key", sorted(SPECS))
def test_hash_encode_fact_backward_matches_jax(key):
    js, ts = _specs(key)
    x = _points(30, 300, js.n_dims)
    table = _table(31, js.n_rows, js.n_features)
    cot = _cot(32, (300, js.n_output_dims))
    want_dt, want_dx = jax.grad(lambda t, xx: jnp.sum(jhe.hash_encode(js, t, xx) * cot),
                                argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    (tho.hash_encode_auto(ts, tt, tx) * torch.from_numpy(cot)).sum().backward()
    _rel_close(tt.grad, want_dt)
    assert torch.isnan(tx.grad).all()                     # poison, not a silent zero
    tt.grad = tx.grad = None
    (tho.hash_encode_onehot_fact(ts, tt, tx) * 0.0).sum().backward()
    assert not tx.grad.any() and not tt.grad.any()        # a zero cotangent stays zero
    # coord_grad=True: the plain path, differentiable in x
    tt.grad = tx.grad = None
    (tho.hash_encode_auto(ts, tt, tx, coord_grad=True) * torch.from_numpy(cot)).sum().backward()
    _rel_close(tt.grad, want_dt)
    _rel_close(tx.grad, want_dx, 1e-4)


def _jax_interp(js, table, x, w):
    """interpT(hash_encode(table, x)) with explicit Lagrange weights w [B]."""
    g = jhe.hash_encode(js, table, x)
    b = w.shape[0]
    g = g.reshape(x.shape[0], js.n_levels, b, js.n_features // b)
    return jnp.einsum("nlbf,b->nlf", g, w).reshape(x.shape[0], -1)


@pytest.mark.parametrize("key", ["3d_hashed", "3d_mixed", "2d_mixed"])
def test_hash_encode_folded_backward_matches_jax(key):
    js, ts = _specs(key)
    nb = 2
    x = _points(33, 300, js.n_dims)
    table = _table(34, js.n_rows, js.n_features)
    w = the.lagrange_weights(0.37, nb)
    cot = _cot(35, (300, js.n_levels * js.n_features // nb))
    want = jax.grad(lambda t: jnp.sum(_jax_interp(js, t, jnp.asarray(x), jnp.asarray(w)) * cot))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tho.hash_encode_folded(ts, tt, tx, tw) * torch.from_numpy(cot)).sum().backward()
    _rel_close(tt.grad, want)
    assert torch.isnan(tx.grad).all() and torch.isnan(tw.grad).all()


def test_hash_encode_fact_multi_folded_backward_matches_jax():
    """Variant 0's table alone is trained; tables_ng get no gradient; the x
    and w poison is gated per variant (variant 1's cotangent is zero here,
    as for the detached warped variants of the density)."""
    js, ts = _specs("2d_mixed")
    nb = 2
    xs = np.stack([_points(40 + v, 200, 2) for v in range(3)])
    table = _table(44, js.n_rows, js.n_features)
    tables_ng = np.stack([_table(45 + v, js.n_rows, js.n_features) for v in range(2)])
    ws = np.stack([the.lagrange_weights(t, nb) for t in (0.5, 0.6, 0.4)])
    cot = _cot(47, (3, 200, js.n_levels * js.n_features // nb))
    cot[1] = 0.0
    want = jax.grad(lambda t: jnp.sum(
        _jax_interp(js, t, jnp.asarray(xs[0]), jnp.asarray(ws[0])) * cot[0]))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    tng = torch.from_numpy(tables_ng).requires_grad_()
    txs = torch.from_numpy(xs).requires_grad_()
    tws = torch.from_numpy(ws).requires_grad_()
    out = tho.hash_encode_fact_multi_folded(ts, tt, tng, txs, tws)
    for v in range(3):
        np.testing.assert_allclose(
            out[v].detach().numpy(),
            np.asarray(_jax_interp(js, jnp.asarray(table if v == 0 else tables_ng[v - 1]),
                                   jnp.asarray(xs[v]), jnp.asarray(ws[v]))),
            rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    _rel_close(tt.grad, want)
    assert tng.grad is None
    for v, dead in enumerate([False, True, False]):
        assert (not txs.grad[v].any()) if dead else torch.isnan(txs.grad[v]).all()
        assert (not tws.grad[v].any()) if dead else torch.isnan(tws.grad[v]).all()


def _jax_planes(grid, pts):
    return jnp.stack([jgs.grid_sample_2d(g, p).T for g, p in zip(grid, pts)])


@pytest.mark.parametrize("hw", [(8, 8), (5, 13)])
def test_plane_bilinear_backward_matches_jax(hw):
    rng = np.random.default_rng(50)
    grid = rng.uniform(0.1, 0.5, (3, 8, *hw)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (3, 333, 2)).astype(np.float32)
    cot = _cot(51, (3, 8, 333))
    want_g, want_p = jax.grad(lambda g, p: jnp.sum(_jax_planes(g, p) * cot), argnums=(0, 1))(
        jnp.asarray(grid), jnp.asarray(pts))
    tg = torch.from_numpy(grid).requires_grad_()
    tp = torch.from_numpy(pts).requires_grad_()
    (tpo.plane_bilinear(tg, tp, coord_grad=False) * torch.from_numpy(cot)).sum().backward()
    _rel_close(tg.grad, want_g)
    assert not tp.grad.any()                              # a silent zero by contract
    tg.grad = tp.grad = None
    (tpo.plane_bilinear(tg, tp) * torch.from_numpy(cot)).sum().backward()   # coord_grad=True
    _rel_close(tg.grad, want_g)
    _rel_close(tp.grad, want_p, 1e-4)


def _jax_lerp(grid, x, lead):
    x = jnp.concatenate([jax.lax.stop_gradient(x[:lead]), x[lead:]], axis=0)
    w = grid.shape[2]
    u = jnp.clip(x, 0.0, 1.0) * (w - 1)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    j1 = jnp.minimum(j0 + 1, w - 1)
    f = (u - j0.astype(jnp.float32))[..., None]
    g0 = jnp.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = jnp.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    return (1.0 - f) * g0 + f * g1


@pytest.mark.parametrize("lead", [0, 3])
def test_plane_linear_backward_matches_jax(lead):
    rng = np.random.default_rng(52 + lead)
    grid = rng.uniform(0.1, 1.0, (9, 8, 32)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (9, 301)).astype(np.float32)
    cot = _cot(53, (9, 301, 8))
    want_g, want_x = jax.grad(lambda g, xx: jnp.sum(_jax_lerp(g, xx, lead) * cot),
                              argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(x))
    tg = torch.from_numpy(grid).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    (tpo.plane_linear(tg, tx, coord_grad_lead=lead) * torch.from_numpy(cot)).sum().backward()
    _rel_close(tg.grad, want_g)
    _rel_close(tx.grad, want_x)
    assert not tx.grad[:lead].any()
    dg, dx = tpo.plane_linear_bwd(tg.detach(), tx.detach(), torch.from_numpy(cot), lead)
    np.testing.assert_array_equal(dg.numpy(), tg.grad.numpy())
    np.testing.assert_array_equal(dx.numpy(), tx.grad.numpy())
