"""The bfloat16 twins of the training-path kernels (`*_tpu` in the port's
`ops/hash_onehot.py` and `ops/plane_onehot.py`, swapped in by
`chip_smoke.tpu_numerics`) and the port's `plane_linear_ref` against the JAX
package's Pallas functions, run in interpret mode on the CPU as the JAX
package's own tests run them, forward and backward.

Tolerance: 1e-5 of each output's largest magnitude. The one exception is
an element where a float32 weight that the two sides compute in another
order rounds to bfloat16 on the other side of a tie: such elements are
counted, at most 1 in 10^4 (and at least 1 where fewer than 10^4 elements
are compared), each within one bfloat16 ulp (2^-8) of the scale. Where the
TPU rounds, the exact float32 plain version must sit at least 10x farther
from the JAX function in mean relative error than the twin: the twin
reproduces what the float32 path does not.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidar4d_tpu.ops import hash_enc as jhe
from lidar4d_tpu.ops import hash_onehot as jho
from lidar4d_tpu.ops import plane_onehot as jpo
from lidar4d_tpu_torch.ops import hash_enc as the
from lidar4d_tpu_torch.ops import hash_onehot as tho
from lidar4d_tpu_torch.ops import plane_onehot as tpo
from torch_threads import limit_under_xdist

limit_under_xdist()

TOL = 1e-5
TIE_ULP = 2.0 ** -8
TIE_SHARE = 1e-4
MARGIN = 10.0
N = 384


def _rng(seed):
    return np.random.default_rng(seed)


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)


def check_twin(twin, want, exact=None):
    """`twin` within TOL of `want` (the JAX function) relative to want's
    largest magnitude, but for the counted tie elements; where `exact` (the
    float32 plain version) is given, its mean relative error from `want` is
    at least MARGIN times the twin's. Returns (twin's, exact's) mean
    relative errors."""
    twin, want = _np(twin), _np(want)
    assert twin.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(twin - want) / scale
    ties = err > TOL
    assert ties.sum() <= max(1, int(TIE_SHARE * err.size)), (ties.sum(), err.max())
    assert err.max() <= TIE_ULP, err.max()
    mean_twin = float(err.mean())
    if exact is None:
        return mean_twin, None
    mean_exact = float((np.abs(_np(exact) - want) / scale).mean())
    assert mean_exact >= MARGIN * max(mean_twin, 1e-12), (mean_exact, mean_twin)
    return mean_twin, mean_exact


# ---------------------------------------------------------------- hash grids
# (spec, whether the TPU's forward gathers at the folded width F' = 2)
FACT_SPEC = dict(n_dims=3, n_levels=4, n_features=8, log2_hashmap_size=9,
                 base_resolution=4, max_resolution=64)
# 2-D levels of at most 128 rows: the packed table's HI * F' = 2 rows do not
# fill an 8-row group, so the TPU takes the one-hot form at F' = 2
SMALL_SPEC = dict(n_dims=2, n_levels=3, n_features=8, log2_hashmap_size=7,
                  base_resolution=4, max_resolution=32)


def _specs(kw):
    return jhe.HashEncoderSpec(**kw), the.HashEncoderSpec(**kw)


def _lagrange(t, b=4):
    return np.asarray(jhe.lagrange_weights(t, b), np.float32)


def test_fact_encode_twin():
    """Rows 3 and 4: `hash_encode_onehot_fact` (`_fwd_call_fact`, which
    gathers in exact float32 at F = 8, and `_bwd_call_fact`, bfloat16
    weights and cotangent)."""
    jspec, tspec = _specs(FACT_SPEC)
    assert tho.tpu_fwd_gathers(tspec)
    table = (_rng(1).normal(size=(jspec.n_rows, 8)) * 0.1).astype(np.float32)
    x = _rng(2).random((N, 3)).astype(np.float32)
    cot = _rng(3).normal(size=(N, jspec.n_output_dims)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jho.hash_encode_onehot_fact(jspec, t, jnp.asarray(x)),
                        jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))

    def port(swap):
        t = torch.from_numpy(table).requires_grad_()
        with swap():
            out = tho.hash_encode_onehot_fact(tspec, t, torch.from_numpy(x))
            (g,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
        return out, g

    out, grad = port(chip_smoke.tpu_numerics)
    _, exact_grad = port(contextlib.nullcontext)
    check_twin(out, want)                   # the TPU gathers: float32 on both sides
    check_twin(grad, want_grad, exact_grad)


@pytest.mark.parametrize("kw,gathers", [(FACT_SPEC, True), (SMALL_SPEC, False)],
                         ids=["gather", "onehot"])
def test_folded_encode_twin(kw, gathers):
    """Rows 5 and 6: `hash_encode_folded` (the interpT-folded table at
    F' = 2: `_fwd_call_fact_grouped`, gather or one-hot form as the TPU
    picks at the spec, and `_folded_table_bwd`, expanded by the Lagrange
    weights in float32)."""
    jspec, tspec = _specs(kw)
    fspec = tho._folded_spec(tspec, 4)
    assert tho.tpu_fwd_gathers(fspec) == gathers
    table = (_rng(4).normal(size=(jspec.n_rows, 8)) * 0.1).astype(np.float32)
    x = _rng(5).random((N, jspec.n_dims)).astype(np.float32)
    w = _lagrange(0.37)
    cot = _rng(6).normal(size=(N, jspec.n_levels * 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jho.hash_encode_folded(jspec, t, jnp.asarray(x),
                                                         jnp.asarray(w)), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))

    def port(swap):
        t = torch.from_numpy(table).requires_grad_()
        with swap():
            out = tho.hash_encode_folded(tspec, t, torch.from_numpy(x), torch.from_numpy(w))
            (g,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
        return out, g

    out, grad = port(chip_smoke.tpu_numerics)
    exact_out, exact_grad = port(contextlib.nullcontext)
    check_twin(out, want, None if gathers else exact_out)
    check_twin(grad, want_grad, exact_grad)


def test_multi_folded_encode_twin():
    """Rows 5 and 6 fused over V = 3 variants (`hash_encode_fact_multi_folded`:
    one grouped forward over three folded tables, variant 0's gradient)."""
    jspec, tspec = _specs(FACT_SPEC)
    tables = (_rng(7).normal(size=(3, jspec.n_rows, 8)) * 0.1).astype(np.float32)
    xs = _rng(8).random((3, N, 3)).astype(np.float32)
    ws = np.stack([_lagrange(t) for t in (0.2, 0.5, 0.9)])
    cot = _rng(9).normal(size=(3, N, jspec.n_levels * 2)).astype(np.float32)
    cot[1:] = 0.0
    want, vjp = jax.vjp(lambda t: jho.hash_encode_fact_multi_folded(
        jspec, t, jnp.asarray(tables[1:]), jnp.asarray(xs), jnp.asarray(ws)),
        jnp.asarray(tables[0]))
    (want_grad,) = vjp(jnp.asarray(cot))

    def port(swap):
        t = torch.from_numpy(tables[0]).requires_grad_()
        with swap():
            out = tho.hash_encode_fact_multi_folded(tspec, t, torch.from_numpy(tables[1:]),
                                                    torch.from_numpy(xs),
                                                    torch.from_numpy(ws))
            (g,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
        return out, g

    out, grad = port(chip_smoke.tpu_numerics)
    _, exact_grad = port(contextlib.nullcontext)
    check_twin(out, want)
    check_twin(grad, want_grad, exact_grad)


# -------------------------------------------------------------------- planes
def test_plane_bilinear_twin():
    """Rows 7 and 9: `plane_bilinear(coord_grad=False)` (`_fwd_kernel`,
    bfloat16 planes and tents; `_bwd_kernel_tables`, bf16(bf16(y tent) *
    cot) times the bfloat16 x tent), P = 3 planes of 8 channels, 24 x 40."""
    grid = _rng(10).normal(size=(3, 8, 24, 40)).astype(np.float32)
    pts = _rng(11).uniform(-0.02, 1.02, (3, N, 2)).astype(np.float32)
    cot = _rng(12).normal(size=(3, 8, N)).astype(np.float32)
    want, vjp = jax.vjp(lambda g: jpo.plane_bilinear(g, jnp.asarray(pts), coord_grad=False),
                        jnp.asarray(grid))
    (want_grad,) = vjp(jnp.asarray(cot))

    def port(swap):
        g = torch.from_numpy(grid).requires_grad_()
        with swap():
            out = tpo.plane_bilinear(g, torch.from_numpy(pts), coord_grad=False)
            (dg,) = torch.autograd.grad(out, g, torch.from_numpy(cot))
        return out, dg

    out, grad = port(chip_smoke.tpu_numerics)
    exact_out, exact_grad = port(contextlib.nullcontext)
    check_twin(out, want, exact_out)
    check_twin(grad, want_grad, exact_grad)


@pytest.mark.parametrize("w,gathers", [(64, True), (200, False)], ids=["gather", "tent"])
def test_plane_linear_twin(w, gathers):
    """Rows 10 and 11: `_plane_linear_kernel_lead` (the forward gathers in
    exact float32 at C = 8 and W <= 128, else the bfloat16 tent matmul;
    `_lin_bwd_kernel`, bfloat16 throughout) with coord_grad_lead = 1 of
    P = 3 tables."""
    assert tpo.tpu_linear_gathers(8, w) == gathers
    grid = _rng(13).normal(size=(3, 8, w)).astype(np.float32)
    x = _rng(14).uniform(-0.02, 1.02, (3, N)).astype(np.float32)
    cot = _rng(15).normal(size=(3, N, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda g, xx: jpo._plane_linear_kernel_lead(1, g, xx),
                        jnp.asarray(grid), jnp.asarray(x))
    want_dg, want_dx = vjp(jnp.asarray(cot))

    def port(swap):
        g = torch.from_numpy(grid).requires_grad_()
        xx = torch.from_numpy(x).requires_grad_()
        with swap():
            out = tpo.plane_linear(g, xx, coord_grad_lead=1)
            dg, dx = torch.autograd.grad(out, (g, xx), torch.from_numpy(cot))
        return out, dg, dx

    out, dg, dx = port(chip_smoke.tpu_numerics)
    exact_out, exact_dg, exact_dx = port(contextlib.nullcontext)
    check_twin(out, want, None if gathers else exact_out)
    check_twin(dg, want_dg, exact_dg)
    check_twin(dx, want_dx, exact_dx)
    assert float(dx[0].abs().max()) == 0.0


def test_plane_linear_ref_is_the_references():
    """The port's `plane_linear_ref` is the JAX package's: the bfloat16
    one-hot matmul (`plane_onehot.py:338-361`), values and autograd's grid
    and x gradients; `plane_linear_plain` stays the exact float32 lerp."""
    grid = _rng(16).normal(size=(3, 8, 48)).astype(np.float32)
    x = _rng(17).uniform(0.0, 1.0, (3, N)).astype(np.float32)
    cot = _rng(18).normal(size=(3, N, 8)).astype(np.float32)
    want, vjp = jax.vjp(jpo.plane_linear_ref, jnp.asarray(grid), jnp.asarray(x))
    want_dg, want_dx = vjp(jnp.asarray(cot))

    def port(fn):
        g = torch.from_numpy(grid).requires_grad_()
        xx = torch.from_numpy(x).requires_grad_()
        out = fn(g, xx)
        return (out, *torch.autograd.grad(out, (g, xx), torch.from_numpy(cot)))

    got = port(tpo.plane_linear_ref)
    exact = port(tpo.plane_linear_plain)
    for g, e, w in zip(got, exact, (want, want_dg, want_dx)):
        check_twin(g, w, e)


def test_tpu_numerics_swaps_the_training_path_wrappers():
    """`chip_smoke.tpu_numerics` swaps the six wrappers that serve the
    eight training-path rows (3-7, 9-11) for their twins, leaves
    `plane_bilinear_vjp` (row 8, off the path) a kernel, and restores
    them."""
    names = ("hash_grid_fwd", "hash_grid_bwd", "plane_bilinear_fwd", "plane_bilinear_bwd",
             "plane_linear_fwd", "plane_linear_bwd", "plane_bilinear_vjp")
    mods = {n: chip_smoke.kernel_module(n) for n in names}
    before = {n: getattr(mods[n], n) for n in names}
    with chip_smoke.tpu_numerics():
        inside = {n: getattr(mods[n], n) for n in names}
    assert {n: getattr(mods[n], n) for n in names} == before
    assert set(chip_smoke.TPU_VERSIONS) == set(names[:-1])
    for n, twin in chip_smoke.TPU_VERSIONS.items():
        assert inside[n] is getattr(mods[n], twin) and twin.endswith("_tpu")
    assert inside["plane_bilinear_vjp"] is before["plane_bilinear_vjp"]
