"""The port's encoder layer against the JAX package on the CPU: the hash
encodes of the classic one-hot route (`hash_encode_onehot`, the reference's
Pallas `_fwd_call` / `_bwd_call`), `hash_encode(row_offset)`,
`hash_encode_blend`, `hash_encode_fact_multi`, the `hash_encode_auto`
dispatch, `HashGrid4D.__call__` and its unfused `forward_dynamic_multi`,
`plane_bilinear(coord_grad=True)` (the reference's `_vjp_bwd`) and the
per-sample-time `Planes4D.forward_dynamic` / `__call__`.

On the CPU the port runs its plain versions. The JAX package runs its
float32 gathers, or its Pallas kernels in interpret mode where a test asks
for the reference kernel itself (bf16 matmuls: 1e-2 of the scale).
Tolerances: values 1e-5 and gradients 1e-4 of each output's largest
magnitude against the float32 gathers (the same float32 arithmetic, summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar4d_tpu.models import hash_field as jhf
from lidar4d_tpu.models import planes_field as jpf
from lidar4d_tpu.ops import grid_sample as jgs
from lidar4d_tpu.ops import hash_enc as jhe
from lidar4d_tpu.ops import hash_onehot as jho
from lidar4d_tpu.ops import plane_onehot as jpo
from lidar4d_tpu_torch.models import hash_field as thf
from lidar4d_tpu_torch.models import planes_field as tpf
from lidar4d_tpu_torch.ops import hash_enc as the
from lidar4d_tpu_torch.ops import hash_onehot as tho
from lidar4d_tpu_torch.ops import plane_onehot as tpo
from torch_threads import limit_under_xdist

limit_under_xdist()

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _uniform(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _off_integer(seed, shape, size):
    """Coordinates in [0, 1] whose pixel coordinate u = x * (size - 1) sits
    at least 0.05 pixel from an integer (and so off the border too)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, size - 1, shape)
    return ((k + rng.uniform(0.05, 0.95, shape)) / (size - 1)).astype(np.float32)


def _plane_points(seed, p, n, h, w):
    return np.stack([_off_integer(seed, (p, n), w), _off_integer(seed + 1, (p, n), h)], -1)


def _jax_planes(grid, pts):
    return jnp.stack([jgs.grid_sample_2d(g, q).T for g, q in zip(grid, pts)])


# ------------------------------------------------------------ plane_bilinear
@pytest.mark.parametrize("hw", [(8, 32), (5, 13), (8, 256)])
def test_plane_bilinear_default_coord_grad_matches_f32_gather(hw):
    """The default call (coord_grad=True, as in the reference) gives pts the
    float32 gather's gradient off integer pixels."""
    h, w = hw
    grid = _uniform(60, (3, 8, h, w), 0.1, 0.5)
    pts = _plane_points(61, 3, 301, h, w)
    cot = _normal(62, (3, 8, 301))
    want = _jax_planes(jnp.asarray(grid), jnp.asarray(pts))
    want_g, want_p = jax.grad(lambda g, q: jnp.sum(_jax_planes(g, q) * cot), argnums=(0, 1))(
        jnp.asarray(grid), jnp.asarray(pts))
    tg = torch.from_numpy(grid).requires_grad_()
    tp = torch.from_numpy(pts).requires_grad_()
    out = tpo.plane_bilinear(tg, tp)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(out, want) <= VALUE_TOL
    assert _rel(tg.grad, want_g) <= VALUE_TOL
    assert _rel(tp.grad, want_p) <= GRAD_TOL
    dg, dp = tpo.plane_bilinear_vjp(tg.detach(), tp.detach(), torch.from_numpy(cot))
    np.testing.assert_array_equal(dg.numpy(), tg.grad.numpy())
    np.testing.assert_array_equal(dp.numpy(), tp.grad.numpy())


def test_plane_bilinear_matches_reference_kernel_in_interpret_mode():
    """The reference's default `plane_bilinear` (its Pallas kernel, bf16
    one-hot matmuls) in interpret mode: values and both gradients."""
    h, w = 8, 32
    grid = _uniform(63, (3, 8, h, w), 0.1, 0.5)
    pts = _plane_points(64, 3, 97, h, w)
    cot = _normal(65, (3, 8, 97))

    def loss(g, q):
        return jnp.sum(jpo.plane_bilinear(g, q) * cot)

    want = jpo.plane_bilinear(jnp.asarray(grid), jnp.asarray(pts))
    want_g, want_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(pts))
    tg = torch.from_numpy(grid).requires_grad_()
    tp = torch.from_numpy(pts).requires_grad_()
    out = tpo.plane_bilinear(tg, tp)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(out, want) <= BF16_TOL
    assert _rel(tg.grad, want_g) <= BF16_TOL
    assert _rel(tp.grad, want_p) <= BF16_TOL


def test_plane_bilinear_coordinate_convention_at_integers_and_border():
    """The tent convention: du = 0 at an exact integer u (border included),
    dv = 0 at an exact integer v, both 0 outside [0, 1]; elsewhere the float32
    gather's gradient. The reference kernel (interpret mode) gives 0 at the
    same points. W - 1 = 8 and H - 1 = 4 make k/8 and k/4 exact."""
    h, w = 5, 9
    xs = [0.0, 3 / 8, 1.0, 0.3, 0.71, -0.2, 1.3]
    ys = [0.0, 2 / 4, 1.0, 0.6, 0.33, -0.1, 1.2]
    q = np.array([(x, y) for x in xs for y in ys], np.float32)
    pts = np.stack([q, q[::-1]])                                # [2, 49, 2]
    grid = _uniform(66, (2, 4, h, w), 0.1, 0.9)
    cot = _normal(67, (2, 4, pts.shape[1]))
    tp = torch.from_numpy(pts).requires_grad_()
    (tpo.plane_bilinear(torch.from_numpy(grid), tp) * torch.from_numpy(cot)).sum().backward()
    got = tp.grad.numpy()
    u, v = pts[..., 0] * (w - 1), pts[..., 1] * (h - 1)
    dead_x = (u == np.round(u)) | (pts[..., 0] < 0) | (pts[..., 0] > 1)
    dead_y = (v == np.round(v)) | (pts[..., 1] < 0) | (pts[..., 1] > 1)
    assert dead_x.any() and (~dead_x).any() and dead_y.any() and (~dead_y).any()
    assert not got[..., 0][dead_x].any() and not got[..., 1][dead_y].any()
    _, gather = jax.grad(lambda g, p: jnp.sum(_jax_planes(g, p) * cot), argnums=(0, 1))(
        jnp.asarray(grid), jnp.asarray(pts))
    gather = np.asarray(gather)
    np.testing.assert_allclose(got[..., 0][~dead_x], gather[..., 0][~dead_x], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., 1][~dead_y], gather[..., 1][~dead_y], rtol=1e-5,
                               atol=1e-5)
    kernel = np.asarray(jax.grad(lambda p: jnp.sum(
        jpo.plane_bilinear(jnp.asarray(grid), p) * cot))(jnp.asarray(pts)))
    assert not kernel[..., 0][dead_x].any() and not kernel[..., 1][dead_y].any()


def test_plane_bilinear_out_of_range_coordinate_gradient_is_zero():
    grid = torch.from_numpy(_normal(68, (3, 8, 16, 24)))
    pts = torch.full((3, 8, 2), 1.5).requires_grad_()
    tpo.plane_bilinear(grid, pts).sum().backward()
    assert not pts.grad.any()


def test_plane_refs_are_the_float32_plain_versions():
    """`plane_bilinear_ref` is the float32 plain version; `plane_linear_ref`
    is, like the reference's, the bfloat16 tent matmul (held to the JAX
    function in tests/test_torch_tpu_numerics.py): the float32 lerp's taps
    and table rounded to bfloat16, within bfloat16 precision of the plain
    version, which stays the exact float32 lerp."""
    grid = torch.from_numpy(_uniform(69, (3, 8, 6, 10)))
    pts = torch.from_numpy(_uniform(70, (3, 50, 2), -0.1, 1.1))
    np.testing.assert_array_equal(tpo.plane_bilinear_ref(grid, pts).numpy(),
                                  tpo.plane_bilinear_plain(grid, pts).numpy())
    lin = torch.from_numpy(_uniform(71, (9, 8, 16)))
    x = torch.from_numpy(_uniform(72, (9, 50)))
    u = x * 15
    j0 = torch.floor(u)
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    gt = bf(lin).transpose(1, 2)
    g0 = torch.gather(gt, 1, j0.long()[..., None].expand(-1, -1, 8))
    g1 = torch.gather(gt, 1, (j0.long() + 1).clamp(max=15)[..., None].expand(-1, -1, 8))
    want = g0 * bf(1.0 - (u - j0))[..., None] + g1 * bf(1.0 - (j0 + 1.0 - u))[..., None]
    got = tpo.plane_linear_ref(lin, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-7)
    plain = tpo.plane_linear_plain(lin, x)
    assert 0 < float((got - plain).abs().max()) < 2.0 ** -7


# ------------------------------------------------------------------ Planes4D
PLANES = dict(output_dim=4, resolution=(8, 8, 8, 4), multiscale_res=(1, 2), hash_scales=1,
              hash_log2=6)


@pytest.fixture(scope="module")
def planes():
    """The reference's Planes4D and the port's, with every plane (the time
    planes included: their init of ones would zero the coordinate gradient)
    drawn from U(0.5, 1.5)."""
    jenc, tenc = jpf.Planes4D(**PLANES), tpf.Planes4D(**PLANES)
    jp = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(73)
    jp = [[rng.uniform(0.5, 1.5, a.shape).astype(np.float32) for a in scale] for scale in jp]
    assert jp[1][0].ndim == 2                                   # the hashed static plane
    return jenc, tenc, jp


def _torch_planes(jp):
    return [[torch.from_numpy(a).requires_grad_() for a in scale] for scale in jp]


def _points4d(seed, n, t_res):
    """xyz in (0, 1) off the 8- and 16-pixel grids' integers, and a
    per-sample t off the time nodes."""
    xyz = np.stack([_off_integer(seed + k, (n,), 16) for k in range(3)], -1)
    return np.concatenate([xyz, _off_integer(seed + 3, (n, 1), t_res)], -1)


def test_planes4d_call_matches_jax(planes):
    """__call__ = (forward_static, forward_dynamic): values, the gradient of
    every plane, and the gradient in pts through the per-sample-time
    dynamic planes (the static lookups' points are ray positions: the
    reference's kernels give them no gradient)."""
    jenc, tenc, jp = planes
    pts = _points4d(74, 257, 4)
    cs, cd = _normal(75, (257, 8)), _normal(76, (257, 8))
    js, jd = jenc(jp, jnp.asarray(pts))
    want_planes = jax.grad(lambda p: jnp.sum(jenc(p, jnp.asarray(pts))[0] * cs)
                           + jnp.sum(jenc(p, jnp.asarray(pts))[1] * cd))(jp)
    want_pts = jax.grad(lambda q: jnp.sum(jenc.forward_dynamic(jp, q) * cd))(jnp.asarray(pts))
    tp = _torch_planes(jp)
    tq = torch.from_numpy(pts).requires_grad_()
    ts, td = tenc(tp, tq)
    assert _rel(ts, js) <= VALUE_TOL and _rel(td, jd) <= VALUE_TOL
    leaves = [a for scale in tp for a in scale]
    got_planes = torch.autograd.grad(
        (ts * torch.from_numpy(cs)).sum() + (td * torch.from_numpy(cd)).sum(), leaves,
        retain_graph=True)
    for got, want in zip(got_planes, jax.tree.leaves(want_planes)):
        assert _rel(got, want) <= VALUE_TOL
    (got_pts,) = torch.autograd.grad((td * torch.from_numpy(cd)).sum(), tq)
    assert _rel(got_pts, want_pts) <= GRAD_TOL


def test_planes4d_forward_dynamic_at_shared_t_equals_scalar_t(planes):
    """forward_dynamic at one t for every sample == forward_dynamic_scalar_t
    (mirrors tests/test_plane_onehot.py's test): values, plane gradients and
    xyz gradients; both are float32 in the port."""
    _, tenc, jp = planes
    xyz = torch.from_numpy(_points4d(77, 157, 4)[:, :3])
    for t in (0.0, 0.37, 1.0):
        tp = _torch_planes(jp)
        want = tenc.forward_dynamic_scalar_t(tp, xyz, t)
        got = tenc.forward_dynamic(tp, torch.cat([xyz, torch.full((157, 1), t)], -1))
        assert _rel(got, want.detach()) <= VALUE_TOL
    tp, tp2 = _torch_planes(jp), _torch_planes(jp)
    x1, x2 = xyz.clone().requires_grad_(), xyz.clone().requires_grad_()
    tenc.forward_dynamic(tp, torch.cat([x1, torch.full((157, 1), 0.4)], -1)).sum().backward()
    tenc.forward_dynamic_scalar_t(tp2, x2, 0.4).sum().backward()
    for a, b in zip([a for s in tp for a in s], [b for s in tp2 for b in s]):
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            assert _rel(a.grad, b.grad.numpy()) <= VALUE_TOL
    assert _rel(x1.grad, x2.grad.numpy()) <= GRAD_TOL


def test_planes4d_anisotropic_planes_match_jax():
    """Planes of unequal shapes in a group (anisotropic resolution) take
    one plane_bilinear call each: values and gradients against JAX."""
    kw = dict(output_dim=4, resolution=(8, 12, 6, 4), multiscale_res=(1,))
    jenc, tenc = jpf.Planes4D(**kw), tpf.Planes4D(**kw)
    rng = np.random.default_rng(78)
    jp = [[rng.uniform(0.5, 1.5, a.shape).astype(np.float32) for a in scale]
          for scale in jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0)))]
    pts = np.concatenate([_uniform(79, (211, 3), 0.02, 0.98), _uniform(80, (211, 1))], -1)
    cot = _normal(81, (211, 4))
    want = jenc.forward_dynamic(jp, jnp.asarray(pts))
    want_p, want_q = jax.grad(lambda p, q: jnp.sum(jenc.forward_dynamic(p, q) * cot),
                              argnums=(0, 1))(jp, jnp.asarray(pts))
    tp = _torch_planes(jp)
    tq = torch.from_numpy(pts).requires_grad_()
    got = tenc.forward_dynamic(tp, tq)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(got, want) <= VALUE_TOL
    for a, b in zip([a for s in tp for a in s], jax.tree.leaves(want_p)):
        assert (a.grad is None) == (not np.asarray(b).any())
        if a.grad is not None:
            assert _rel(a.grad, b) <= VALUE_TOL
    assert _rel(tq.grad, want_q) <= GRAD_TOL


# ------------------------------------------------------------- hash encodes
ONEHOT_SPEC = dict(n_dims=3, n_levels=4, n_features=8, log2_hashmap_size=10,
                   base_resolution=8, max_resolution=64)


def test_hash_encode_onehot_matches_reference_kernel_and_gather():
    """hash_encode_onehot vs the reference's classic Pallas kernel in
    interpret mode (bf16: 1e-2) and vs the float32 gather (1e-5): values and
    the table gradient (mirrors tests/test_ops_core.py's test)."""
    js, ts = jhe.HashEncoderSpec(**ONEHOT_SPEC), the.HashEncoderSpec(**ONEHOT_SPEC)
    assert jho.onehot_eligible(js) and tho.onehot_eligible(ts)
    table = _uniform(80, (js.n_rows, 8), -1, 1)
    x = _uniform(81, (300, 3))
    w = np.sin(np.arange(300 * js.n_output_dims).reshape(300, -1) * 0.37).astype(np.float32)
    jt, jx = jnp.asarray(table), jnp.asarray(x)
    kernel = jho.hash_encode_onehot(js, jt, jx)
    kernel_g = jax.grad(lambda t: jnp.sum(jho.hash_encode_onehot(js, t, jx) * w))(jt)
    gather = jhe.hash_encode(js, jt, jx)
    gather_g = jax.grad(lambda t: jnp.sum(jhe.hash_encode(js, t, jx) * w))(jt)
    tt = torch.from_numpy(table).requires_grad_()
    out = tho.hash_encode_onehot(ts, tt, torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    assert _rel(out, kernel) <= BF16_TOL and _rel(tt.grad, kernel_g) <= BF16_TOL
    assert _rel(out, gather) <= VALUE_TOL and _rel(tt.grad, gather_g) <= VALUE_TOL


def test_hash_encode_onehot_poisons_the_coordinate_gradient():
    """Mirrors tests/test_ops_core.py's trap test: a differentiated x gets
    NaN; a zero cotangent stays zero; detached coordinates leave the table
    gradient finite."""
    ts = the.HashEncoderSpec(n_dims=2, n_levels=2, n_features=4, log2_hashmap_size=9,
                             base_resolution=8, max_resolution=16)
    table = torch.from_numpy(_uniform(82, (ts.n_rows, 4), -1, 1)).requires_grad_()
    x = torch.from_numpy(_uniform(83, (64, 2)))
    shift = torch.zeros(2, requires_grad=True)
    tho.hash_encode_onehot(ts, table, x + shift).sum().backward()
    assert torch.isnan(shift.grad).all() and torch.isfinite(table.grad).all()
    shift.grad = table.grad = None
    (tho.hash_encode_onehot(ts, table, x + shift) * 0.0).sum().backward()
    assert not shift.grad.any() and not table.grad.any()
    table.grad = None
    tho.hash_encode_onehot(ts, table, (x + shift).detach()).sum().backward()
    assert torch.isfinite(table.grad).all() and table.grad.any()


def test_hash_encode_row_offset_and_blend_match_jax():
    """Mirrors tests/test_ops_core.py's row_offset test, and
    hash_encode_blend against the reference's."""
    kw = dict(n_dims=2, n_levels=2, n_features=2, log2_hashmap_size=8, base_resolution=8,
              max_resolution=16)
    js, ts = jhe.HashEncoderSpec(**kw), the.HashEncoderSpec(**kw)
    table = _uniform(84, (3 * js.n_rows, 2), -1, 1)
    x = _uniform(85, (32, 2))
    jt, jx, tt, tx = jnp.asarray(table), jnp.asarray(x), torch.from_numpy(table), \
        torch.from_numpy(x)
    for k, off in enumerate((0, js.n_rows, torch.tensor(2 * js.n_rows))):
        got = the.hash_encode(ts, tt, tx, row_offset=off)
        want = jhe.hash_encode(js, jt, jx, row_offset=jnp.int32(k * js.n_rows))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got.numpy(), the.hash_encode(ts, tt[k * ts.n_rows:(k + 1) * ts.n_rows], tx).numpy(),
            rtol=1e-6, atol=1e-7)
    offs, blend = [js.n_rows, 2 * js.n_rows], [0.3, 0.7]
    got = the.hash_encode_blend(ts, tt, tx, offs, blend)
    want = jhe.hash_encode_blend(js, jt, jx, jnp.asarray(offs, jnp.int32),
                                 jnp.asarray(blend, jnp.float32))
    assert _rel(got, want) <= VALUE_TOL


def test_hash_encode_fact_multi_matches_jax():
    """Mirrors tests/test_ops_core.py's fused multi-variant test against the
    float32 gathers: values per variant, variant 0's table gradient, zero
    for tables_ng, finite coordinates under detached neighbour outputs, NaN
    where a neighbour's output is consumed with its coordinates
    differentiated."""
    kw = dict(n_dims=2, n_levels=3, n_features=4, log2_hashmap_size=9, base_resolution=16,
              max_resolution=128)
    js, ts = jhe.HashEncoderSpec(**kw), the.HashEncoderSpec(**kw)
    tab0 = _uniform(86, (js.n_rows, 4), -1, 1)
    tabs_ng = _uniform(87, (2, js.n_rows, 4), -1, 1)
    xs = _uniform(88, (3, 300, 2))
    w = np.sin(np.arange(300 * js.n_output_dims).reshape(300, -1) * 0.37).astype(np.float32)
    t0 = torch.from_numpy(tab0).requires_grad_()
    tng = torch.from_numpy(tabs_ng).requires_grad_()
    out = tho.hash_encode_fact_multi(ts, t0, tng, torch.from_numpy(xs))
    for v in range(3):
        tab = tab0 if v == 0 else tabs_ng[v - 1]
        assert _rel(out[v], jhe.hash_encode(js, jnp.asarray(tab), jnp.asarray(xs[v]))) \
            <= VALUE_TOL
    ((out[0] * torch.from_numpy(w)).sum() + out[1:].detach().sum()).backward()
    want = jax.grad(lambda t: jnp.sum(jhe.hash_encode(js, t, jnp.asarray(xs[0])) * w))(
        jnp.asarray(tab0))
    assert _rel(t0.grad, want) <= VALUE_TOL
    assert tng.grad is None or not tng.grad.any()
    shift = torch.zeros(2, requires_grad=True)
    txs = torch.from_numpy(xs)
    o = tho.hash_encode_fact_multi(ts, t0, tng, torch.stack([txs[0], txs[1] + shift,
                                                             txs[2] + shift]))
    ((o[0] * torch.from_numpy(w)).sum() + o[1:].detach().sum()).backward()
    assert torch.isfinite(shift.grad).all()
    shift.grad = None
    tho.hash_encode_fact_multi(ts, t0, tng, torch.stack([txs[0], txs[1] + shift, txs[2]]))[
        1].sum().backward()
    assert torch.isnan(shift.grad).all()


def _dispatch_spec(log2):
    """A 2D one-level spec whose table has 2^log2 rows."""
    return the.HashEncoderSpec(n_dims=2, n_levels=1, n_features=2, log2_hashmap_size=log2,
                               base_resolution=255, max_resolution=255)


# (variant, log2 rows, row_offset, coord_grad, x requires grad) -> route
DISPATCH = [
    ("fact", 8, None, False, False, "fact"),
    ("fact", 13, None, False, True, "fact"),          # inside FACT_MAX_ROWS: NaN x-grad
    ("fact", 15, None, False, False, "onehot"),       # the gather, x needs no gradient
    ("fact", 15, None, False, True, "plain"),         # the gather, x needs a gradient
    ("fact", 8, 0, False, False, "plain"),            # row_offset
    ("fact", 8, None, True, True, "plain"),           # coord_grad
    ("classic", 8, None, False, False, "onehot"),
    ("classic", 8, None, False, True, "onehot"),      # inside max_rows: NaN x-grad
    ("classic", 13, None, False, False, "onehot"),    # past max_rows: the gather
    ("classic", 13, None, False, True, "plain"),
    ("classic", 8, 0, False, True, "plain"),
    ("classic", 13, None, True, True, "plain"),
]


@pytest.mark.parametrize("variant,log2,row_offset,coord_grad,x_grad,route", DISPATCH,
                         ids=["-".join(map(str, c)) for c in DISPATCH])
def test_hash_encode_auto_dispatch(monkeypatch, variant, log2, row_offset, coord_grad,
                                   x_grad, route):
    """hash_encode_auto takes the reference's route (a spy on each entry
    point records the first one called), its values match the reference's
    float32 gather, and its x gradient is NaN on the one-hot routes and the
    gather's own on the plain one."""
    monkeypatch.setattr(tho, "ONEHOT_VARIANT", variant)
    calls = []
    for name, label in (("hash_encode_onehot_fact", "fact"), ("hash_encode_onehot", "onehot"),
                        ("hash_encode", "plain")):
        fn = getattr(tho, name)
        monkeypatch.setattr(tho, name, lambda *a, _fn=fn, _l=label, **k: (
            calls.append(_l), _fn(*a, **k))[1])
    ts = _dispatch_spec(log2)
    js = jhe.HashEncoderSpec(**vars(ts))
    table = _uniform(89, (ts.n_rows, 2), -1, 1)
    x = _uniform(90, (200, 2))
    cot = _normal(91, (200, 2))
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_(x_grad)
    out = tho.hash_encode_auto(ts, tt, tx, row_offset=row_offset, coord_grad=coord_grad)
    assert calls[0] == route
    jt, jx = jnp.asarray(table), jnp.asarray(x)
    want_t, want_x = jax.grad(lambda t, xx: jnp.sum(jhe.hash_encode(js, t, xx) * cot),
                              argnums=(0, 1))(jt, jx)
    assert _rel(out, jhe.hash_encode(js, jt, jx)) <= VALUE_TOL
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(tt.grad, want_t) <= VALUE_TOL
    if x_grad:
        if route == "plain":
            assert _rel(tx.grad, want_x) <= GRAD_TOL
        else:
            assert torch.isnan(tx.grad).all()


def test_hash_encode_auto_windows_mean_what_they_mean_in_jax():
    assert tho.FACT_MAX_ROWS == jho.FACT_MAX_ROWS
    assert tho.ONEHOT_VARIANT == jho.ONEHOT_VARIANT == "fact"
    for log2 in (8, 12, 13, 14, 15):
        ts = _dispatch_spec(log2)
        js = jhe.HashEncoderSpec(**{**vars(ts), "n_features": 8})
        ts8 = the.HashEncoderSpec(**vars(js))
        assert tho.onehot_eligible(ts8) == jho.onehot_eligible(js)
        assert tho.onehot_eligible(ts8, tho.FACT_MAX_ROWS) == jho.onehot_eligible(
            js, jho.FACT_MAX_ROWS)
    assert tho.onehot_eligible(_dispatch_spec(20), tho.KERNEL_MAX_ROWS)


# ---------------------------------------------------------------- HashGrid4D
GRID = dict(base_resolution=8, max_resolution=32, time_resolution=4, n_levels=2,
            log2_hashmap_size=8, hash_size_dynamic=(8, 7, 7))


@pytest.mark.parametrize("variant,features,fused", [
    ("fact", 8, True),
    ("classic", 8, False),
    ("fact", 12, False),            # F' = 3: no kernel width, so unfused
])
def test_hash_grid4d_matches_jax(monkeypatch, variant, features, fused):
    """HashGrid4D.__call__ and forward_dynamic_multi (fused or not by the
    reference's rule) against the reference's unfused path: values and the
    tables' gradients through variant 0."""
    monkeypatch.setattr(tho, "ONEHOT_VARIANT", variant)
    ran_fused = []
    fused_fn = thf.hash_encode_fact_multi_folded
    monkeypatch.setattr(thf, "hash_encode_fact_multi_folded",
                        lambda *a: (ran_fused.append(True), fused_fn(*a))[1])
    jenc = jhf.HashGrid4D(**GRID, n_features_per_level=features)
    tenc = thf.HashGrid4D(**GRID, n_features_per_level=features)
    rng = np.random.default_rng(92)
    jp = {k: rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
          for k, v in jenc.init(jax.random.PRNGKey(0)).items()}
    x = _uniform(93, (200, 3))
    xs = np.stack([x, x + 0.01, x - 0.02]).astype(np.float32)
    ts = [0.45, 0.7, 0.2]

    def tparams():
        return {k: torch.from_numpy(v).requires_grad_() for k, v in jp.items()}

    js, jd = jax.jit(jenc.__call__)(jp, jnp.asarray(x), jnp.float32(ts[0]))
    s, d = tenc(tparams(), torch.from_numpy(x), ts[0])
    assert _rel(s, js) <= VALUE_TOL and _rel(d, jd) <= VALUE_TOL

    cot = _normal(94, (3, 200, tenc.n_output_dims_dynamic))

    def jloss(p):
        out = jenc.forward_dynamic_multi(p, jnp.asarray(xs), jnp.asarray(ts), fused=False)
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = tparams()
    got = tenc.forward_dynamic_multi(tp, torch.from_numpy(xs), ts)
    assert bool(ran_fused) == fused
    assert _rel(got, want) <= VALUE_TOL
    unfused = tenc.forward_dynamic_multi(tparams(), torch.from_numpy(xs), ts, fused=False)
    assert _rel(unfused, want) <= VALUE_TOL
    (got * torch.from_numpy(cot)).sum().backward()
    for k in ("dynamic_0", "dynamic_1", "dynamic_2"):
        assert _rel(tp[k].grad, want_g[k]) <= VALUE_TOL
    assert tp["static"].grad is None


def test_hash_encode_interp_auto_follows_the_variant(monkeypatch):
    """Under "classic" the encode runs at F and interpT follows it (the
    reference's order), under "fact" the fold runs; both equal the
    reference's encode-then-interpT."""
    kw = dict(n_dims=3, n_levels=2, n_features=8, log2_hashmap_size=8, base_resolution=4,
              max_resolution=16)
    js, ts = jhe.HashEncoderSpec(**kw), the.HashEncoderSpec(**kw)
    table = _uniform(95, (js.n_rows, 8), -1, 1)
    x = _uniform(96, (150, 3))
    want = jhe.lagrange_time_interp(jhe.hash_encode(js, jnp.asarray(table), jnp.asarray(x)),
                                    jnp.float32(0.3), 2, 8, 4)
    folded = tho.hash_encode_folded
    for variant, expect_fold in (("fact", True), ("classic", False)):
        monkeypatch.setattr(tho, "ONEHOT_VARIANT", variant)
        ran = []
        monkeypatch.setattr(tho, "hash_encode_folded",
                            lambda *a: (ran.append(True), folded(*a))[1])
        got = tho.hash_encode_interp_auto(ts, torch.from_numpy(table), torch.from_numpy(x),
                                          0.3, 4)
        assert bool(ran) == expect_fold
        assert _rel(got, want) <= VALUE_TOL

