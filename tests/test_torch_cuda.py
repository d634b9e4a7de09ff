"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch has no CUDA device (every CPU-only
machine). On a GPU machine run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

This file imports no JAX, so it runs where JAX is not installed
(`--noconftest` skips tests/conftest.py, which imports JAX).
"""

import numpy as np
import pytest
import torch

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops import hash_onehot as ho
from lidar4d_tpu_torch.ops import plane_onehot as po
from lidar4d_tpu_torch.ops.hash_enc import HashEncoderSpec

pytestmark = pytest.mark.cuda

RTOL = 1e-6      # same gathers in the same order; only FMA contraction differs
GRAD_RTOL = 1e-4  # atomics add in another order than the plain scatter


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda.library()
    return torch.device("cuda", 0)


def _rand(dev, *shape, lo=0.0, hi=1.0, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return lo + (hi - lo) * torch.rand(*shape, generator=g, device=dev)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("spec", [
    HashEncoderSpec(3, 6, 8, 11, 64, 2048),      # flagship static
    HashEncoderSpec(3, 4, 2, 11, 16, 256),       # flagship flow, folded
    HashEncoderSpec(2, 6, 2, 10, 64, 2048),      # flagship dynamic, folded
    HashEncoderSpec(2, 1, 8, 11, 255, 255),      # flagship hashed static plane
    HashEncoderSpec(3, 3, 4, 12, 4, 32),         # dense and hashed levels
    HashEncoderSpec(2, 2, 1, 8, 4, 8),           # F = 1
], ids=str)
def test_hash_grid_fwd_matches_plain(dev, spec):
    tables = _rand(dev, 3, spec.n_rows, spec.n_features, lo=-1, hi=1, seed=1)
    xs = _rand(dev, 3, 5000, spec.n_dims, seed=2)
    xs[:, :3] = torch.tensor([0.0, 1.0, 0.5], device=dev)[:, None]
    before = _cuda.LAUNCHES["hash_grid_fwd"]
    got = ho.hash_grid_fwd(spec, tables, xs)
    assert _cuda.LAUNCHES["hash_grid_fwd"] == before + 1
    assert _rel(got, ho.hash_grid_fwd_plain(spec, tables, xs)) <= RTOL


@pytest.mark.parametrize("hw", [(32, 32), (128, 128), (5, 17)])
def test_plane_bilinear_fwd_matches_plain(dev, hw):
    grid = _rand(dev, 3, 8, *hw, lo=0.1, hi=0.5, seed=3)
    pts = _rand(dev, 3, 7000, 2, lo=-0.1, hi=1.1, seed=4)
    before = _cuda.LAUNCHES["plane_bilinear_fwd"]
    got = po.plane_bilinear(grid, pts)
    assert _cuda.LAUNCHES["plane_bilinear_fwd"] == before + 1
    assert _rel(got, po.plane_bilinear_plain(grid, pts)) <= RTOL


@pytest.mark.parametrize("c,w", [(8, 32), (8, 256), (4, 2), (16, 64)])
def test_plane_linear_fwd_matches_plain(dev, c, w):
    grid = _rand(dev, 9, c, w, lo=0.1, hi=1.0, seed=5)
    x = _rand(dev, 9, 6000, lo=-0.1, hi=1.1, seed=6)
    before = _cuda.LAUNCHES["plane_linear_fwd"]
    got = po.plane_linear(grid, x)
    assert _cuda.LAUNCHES["plane_linear_fwd"] == before + 1
    assert _rel(got, po.plane_linear_plain(grid, x)) <= RTOL


def test_wrappers_raise_instead_of_falling_back(dev):
    spec = HashEncoderSpec(3, 2, 8, 8, 4, 16)
    tables = _rand(dev, 1, spec.n_rows, 8)
    with pytest.raises(TypeError):
        ho.hash_grid_fwd(spec, tables.double(), _rand(dev, 1, 10, 3).double())
    with pytest.raises(ValueError):
        po.plane_linear(_rand(dev, 2, 3, 16), _rand(dev, 2, 10))        # C = 3
    with pytest.raises(ValueError):
        po.plane_bilinear(_rand(dev, 1, 8, 4, 4),
                          _rand(dev, 1, 2, 5).transpose(1, 2))      # not contiguous
    with pytest.raises(NotImplementedError):
        ho.hash_grid_fwd(spec, tables.requires_grad_(), _rand(dev, 1, 10, 3))


def _edge_points(dev, p, n, h, w, seed):
    """[P, N, 2] points in [-0.1, 1.1]^2 whose first rows sit on exact
    integer pixels, on the border and on the time nodes t = k / (H - 1)."""
    pts = _rand(dev, p, n, 2, lo=-0.1, hi=1.1, seed=seed)
    k = torch.arange(64, device=dev, dtype=torch.float32)
    pts[:, :64, 0] = (k % w) / (w - 1)
    pts[:, :64, 1] = (k % h) / (h - 1)
    pts[:, 64:70] = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.5], [0.5, 0.0],
                                  [1.2, -0.1]], device=dev)
    return pts


@pytest.mark.parametrize("hw", [(8, 32), (8, 256), (32, 32), (128, 128), (5, 17)])
def test_plane_bilinear_vjp_matches_plain(dev, hw):
    """Row 8 (the reference's `_vjp_bwd`): dG and dpts against the plain
    version, exact-integer and border coordinates included (a [8, 8, 256]
    time plane fills the kernel's 64 KB shared accumulator; 128^2 takes
    the global atomics)."""
    h, w = hw
    grid = _rand(dev, 3, 8, h, w, lo=0.1, hi=0.9, seed=30)
    pts = _edge_points(dev, 3, 7000, h, w, seed=31)
    cot = _rand(dev, 3, 8, 7000, lo=-1, hi=1, seed=32)
    before = _cuda.LAUNCHES["plane_bilinear_vjp"]
    dg, dp = po.plane_bilinear_vjp(grid, pts, cot)
    assert _cuda.LAUNCHES["plane_bilinear_vjp"] == before + 1
    want_dg, want_dp = po.plane_bilinear_vjp_plain(grid, pts, cot)
    assert _rel(dg, want_dg) <= GRAD_RTOL
    assert _rel(dp, want_dp) <= GRAD_RTOL
    assert torch.equal(dp == 0, want_dp == 0)          # the tent's zeros, point by point


def test_plane_bilinear_coord_grad_launches_vjp(dev):
    """The default plane_bilinear (coord_grad=True) with pts that need a
    gradient runs its backward on the row-8 kernel, and matches the CPU."""
    grid = _rand(dev, 3, 8, 8, 64, seed=33).requires_grad_()
    pts = _edge_points(dev, 3, 5000, 8, 64, seed=34).requires_grad_()
    before = dict(_cuda.LAUNCHES)
    po.plane_bilinear(grid, pts).square().sum().backward()
    assert _cuda.LAUNCHES["plane_bilinear_vjp"] == before["plane_bilinear_vjp"] + 1
    assert _cuda.LAUNCHES["plane_bilinear_bwd"] == before["plane_bilinear_bwd"]
    gc, pc = (t.detach().cpu().requires_grad_() for t in (grid, pts))
    po.plane_bilinear(gc, pc).square().sum().backward()
    assert _rel(grid.grad.cpu(), gc.grad) <= GRAD_RTOL
    assert _rel(pts.grad.cpu(), pc.grad) <= GRAD_RTOL


@pytest.mark.parametrize("spec", [
    HashEncoderSpec(3, 6, 8, 11, 64, 2048),      # flagship static
    HashEncoderSpec(2, 6, 8, 11, 64, 2048),      # flagship dynamic xy, unfolded
    HashEncoderSpec(3, 4, 8, 11, 16, 256),       # flagship flow grid, unfolded
], ids=str)
def test_hash_encode_onehot_matches_plain(dev, spec):
    """Rows 1-2 (the reference's classic `_fwd_call` / `_bwd_call`): one
    launch of each kernel, values and table gradient against the CPU."""
    table = _rand(dev, spec.n_rows, spec.n_features, lo=-1, hi=1, seed=35).requires_grad_()
    x = _rand(dev, 6000, spec.n_dims, seed=36)
    cot = _rand(dev, 6000, spec.n_output_dims, lo=-1, hi=1, seed=37)
    before = dict(_cuda.LAUNCHES)
    out = ho.hash_encode_onehot(spec, table, x)
    (out * cot).sum().backward()
    for name in ("hash_grid_fwd", "hash_grid_bwd"):
        assert _cuda.LAUNCHES[name] == before[name] + 1, name
    tc = table.detach().cpu().requires_grad_()
    want = ho.hash_encode_onehot(spec, tc, x.cpu())
    (want * cot.cpu()).sum().backward()
    assert _rel(out.detach().cpu(), want.detach()) <= RTOL
    assert _rel(table.grad.cpu(), tc.grad) <= GRAD_RTOL


def test_zero_points_launch_nothing(dev):
    before = dict(_cuda.LAUNCHES)
    assert po.plane_linear(_rand(dev, 9, 8, 32), torch.zeros(9, 0, device=dev)).shape == (9, 0, 8)
    assert _cuda.LAUNCHES == before


def test_aligned_copy(dev):
    t = _rand(dev, 17)
    assert _cuda.aligned(t[1:]).data_ptr() % 16 == 0
    np.testing.assert_array_equal(_cuda.aligned(t[1:]).cpu().numpy(), t[1:].cpu().numpy())


@pytest.mark.parametrize("spec", [
    HashEncoderSpec(3, 6, 8, 11, 64, 2048),      # flagship static
    HashEncoderSpec(3, 4, 2, 11, 16, 256),       # flagship flow, folded
    HashEncoderSpec(2, 6, 2, 10, 64, 2048),      # flagship dynamic, folded
    HashEncoderSpec(2, 1, 8, 11, 255, 255),      # flagship hashed static plane
    HashEncoderSpec(3, 3, 4, 12, 4, 32),         # dense and hashed levels
    HashEncoderSpec(3, 2, 8, 14, 4, 64),         # a level too large for shared memory
    HashEncoderSpec(2, 2, 1, 8, 4, 8),           # F = 1
], ids=str)
def test_hash_grid_bwd_matches_plain(dev, spec):
    xs = _rand(dev, 3, 5000, spec.n_dims, seed=7)
    xs[:, :3] = torch.tensor([0.0, 1.0, 0.5], device=dev)[:, None]
    cot = _rand(dev, 3, 5000, spec.n_output_dims, lo=-1, hi=1, seed=8)
    before = _cuda.LAUNCHES["hash_grid_bwd"]
    got = ho.hash_grid_bwd(spec, xs[:1], cot[:1], n_tables=3)
    assert _cuda.LAUNCHES["hash_grid_bwd"] == before + 1
    assert got.shape == (3, spec.n_rows, spec.n_features)
    assert _rel(got[:1], ho.hash_grid_bwd_plain(spec, xs[:1], cot[:1])) <= GRAD_RTOL
    assert not got[1:].any()
    assert _rel(ho.hash_grid_bwd(spec, xs, cot), ho.hash_grid_bwd_plain(spec, xs, cot)) \
        <= GRAD_RTOL


@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (128, 128), (5, 17)])
def test_plane_bilinear_bwd_matches_plain(dev, hw):
    pts = _rand(dev, 3, 7000, 2, lo=-0.1, hi=1.1, seed=9)
    cot = _rand(dev, 3, 8, 7000, lo=-1, hi=1, seed=10)
    before = _cuda.LAUNCHES["plane_bilinear_bwd"]
    got = po.plane_bilinear_bwd(pts, cot, hw)
    assert _cuda.LAUNCHES["plane_bilinear_bwd"] == before + 1
    assert _rel(got, po.plane_bilinear_bwd_plain(pts, cot, hw)) <= GRAD_RTOL


@pytest.mark.parametrize("c,w,lead", [(8, 32, 3), (8, 256, 0), (4, 2, 9), (16, 64, 1)])
def test_plane_linear_bwd_matches_plain(dev, c, w, lead):
    grid = _rand(dev, 9, c, w, lo=0.1, hi=1.0, seed=11)
    x = _rand(dev, 9, 6000, lo=-0.1, hi=1.1, seed=12)
    cot = _rand(dev, 9, 6000, c, lo=-1, hi=1, seed=13)
    before = _cuda.LAUNCHES["plane_linear_bwd"]
    dg, dx = po.plane_linear_bwd(grid, x, cot, lead)
    assert _cuda.LAUNCHES["plane_linear_bwd"] == before + 1
    want_dg, want_dx = po.plane_linear_bwd_plain(grid, x, cot, lead)
    assert _rel(dg, want_dg) <= GRAD_RTOL
    assert not dx[:lead].any()
    if lead < 9:
        assert _rel(dx, want_dx) <= GRAD_RTOL


def test_autograd_functions_launch_backward_kernels(dev):
    """A backward pass through the differentiable entry points launches
    each backward kernel once and matches the plain versions' gradients."""
    spec = HashEncoderSpec(3, 3, 8, 10, 8, 64)
    table = _rand(dev, spec.n_rows, 8, lo=-1, hi=1, seed=14).requires_grad_()
    x = _rand(dev, 4000, 3, seed=15)
    grid = _rand(dev, 3, 8, 32, 32, seed=16).requires_grad_()
    pts = _rand(dev, 3, 4000, 2, seed=17)
    lin = _rand(dev, 9, 8, 64, seed=18).requires_grad_()
    xl = _rand(dev, 9, 4000, seed=19).requires_grad_()
    before = dict(_cuda.LAUNCHES)
    loss = (ho.hash_encode_auto(spec, table, x).square().sum()
            + po.plane_bilinear(grid, pts).square().sum()
            + po.plane_linear(lin, xl, coord_grad_lead=3).square().sum())
    loss.backward()
    for name in ("hash_grid_bwd", "plane_bilinear_bwd", "plane_linear_bwd"):
        assert _cuda.LAUNCHES[name] == before[name] + 1, name
    tp, gp, lp, xp = (t.detach().cpu().requires_grad_() for t in (table, grid, lin, xl))
    want = (ho.hash_encode_auto(spec, tp, x.cpu()).square().sum()
            + po.plane_bilinear(gp, pts.cpu()).square().sum()
            + po.plane_linear(lp, xp, coord_grad_lead=3).square().sum())
    want.backward()
    for got, ref in ((table, tp), (grid, gp), (lin, lp), (xl, xp)):
        assert _rel(got.grad.cpu(), ref.grad) <= GRAD_RTOL


def _ray_points(dev, n_rays, steps, seed):
    """[n_rays * steps, 3] points in [0, 1]^3, `steps` consecutive samples
    along each ray, as a density call sees them: neighbouring points share
    cells, rows and columns, which the backward kernels sum in registers."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    o = 0.5 + 0.02 * torch.randn(n_rays, 1, 3, generator=g, device=dev)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 1, 3, generator=g, device=dev), dim=-1)
    z = torch.linspace(0.0, 0.6, steps, device=dev)[None, :, None]
    return torch.clamp(o + d * z, 0.0, 1.0).reshape(-1, 3)


def test_backward_kernels_on_ray_ordered_points(dev):
    pts = _ray_points(dev, 64, 256, seed=20)
    n = pts.shape[0]
    spec = HashEncoderSpec(3, 6, 8, 11, 64, 2048)
    cot = _rand(dev, 1, n, spec.n_output_dims, lo=-1, hi=1, seed=21)
    assert _rel(ho.hash_grid_bwd(spec, pts[None], cot),
                ho.hash_grid_bwd_plain(spec, pts[None], cot)) <= GRAD_RTOL
    q = torch.stack([pts[:, [0, 1]], pts[:, [0, 2]], pts[:, [1, 2]]]).contiguous()
    cot = _rand(dev, 3, 8, n, lo=-1, hi=1, seed=22)
    for hw in ((32, 32), (128, 128)):
        assert _rel(po.plane_bilinear_bwd(q, cot, hw), po.plane_bilinear_bwd_plain(q, cot, hw)) \
            <= GRAD_RTOL
    grid = _rand(dev, 9, 8, 64, seed=23)
    x = pts.T.repeat(3, 1).contiguous()
    cot = _rand(dev, 9, n, 8, lo=-1, hi=1, seed=24)
    for got, want in zip(po.plane_linear_bwd(grid, x, cot, 3),
                         po.plane_linear_bwd_plain(grid, x, cot, 3)):
        assert _rel(got, want) <= GRAD_RTOL


# Edges of the persistent backward kernels: every point on one row or column
# (the longest register runs and the worst same-address collisions), a single
# point, one point either side of a block's share of points, enough points that
# each persistent block walks several tiles, a level too large for shared
# memory, and a table whose copy does not fit beside its gradient there.
_STATIC = HashEncoderSpec(3, 6, 8, 11, 64, 2048)       # flagship static hash
_DYNAMIC = HashEncoderSpec(2, 6, 2, 10, 64, 2048)      # flagship dynamic, folded
_LARGE = HashEncoderSpec(3, 2, 8, 14, 4, 64)           # a level too large for shared memory


def _hash_share(spec):
    """Points a block of hash_grid_bwd takes at the minimum run."""
    return ho.HASH_BWD_THREADS // spec.n_features * ho.HASH_BWD_MIN_RUN


@pytest.mark.parametrize("spec,n,layout", [
    (_STATIC, 5000, "one cell"),
    (_DYNAMIC, 5000, "one cell"),
    (_STATIC, 1, "uniform"),
    (_STATIC, _hash_share(_STATIC) - 1, "uniform"),
    (_STATIC, _hash_share(_STATIC) + 1, "uniform"),
    (_DYNAMIC, _hash_share(_DYNAMIC) - 1, "uniform"),
    (_DYNAMIC, _hash_share(_DYNAMIC) + 1, "uniform"),
    (_STATIC, (1 << 20) + 3, "rays"),
    (_LARGE, 7000, "rays"),
], ids=lambda v: v if isinstance(v, str) else str(v))
def test_hash_grid_bwd_edges(dev, spec, n, layout):
    """Against the plain version, two variants scattered into three tables
    (the third gets a zero gradient)."""
    if layout == "one cell":
        xs = torch.full((2, n, spec.n_dims), 0.3712, device=dev)
    elif layout == "rays":
        pts = _ray_points(dev, -(-n // 256), 256, seed=40)[:n]
        xs = torch.stack([pts[:, :spec.n_dims], pts[:, -spec.n_dims:]]).contiguous()
    else:
        xs = _rand(dev, 2, n, spec.n_dims, seed=41)
    cot = _rand(dev, 2, n, spec.n_output_dims, lo=-1, hi=1, seed=42)
    before = _cuda.LAUNCHES["hash_grid_bwd"]
    got = ho.hash_grid_bwd(spec, xs, cot, n_tables=3)
    assert _cuda.LAUNCHES["hash_grid_bwd"] == before + 1
    assert _rel(got[:2], ho.hash_grid_bwd_plain(spec, xs, cot)) <= GRAD_RTOL
    assert not got[2:].any()


def _lin_share(c):
    """Points a block of plane_linear_bwd takes at the minimum run."""
    return po.LIN_BWD_THREADS // c * po.LIN_BWD_MIN_RUN


@pytest.mark.parametrize("c,w,n,layout", [
    (8, 256, 5000, "one column"),
    (8, 32, 1, "uniform"),
    (8, 64, _lin_share(8) - 1, "uniform"),
    (8, 64, _lin_share(8) + 1, "uniform"),
    (8, 128, (1 << 20) + 3, "rays"),
    (4, 32, 1001, "uniform"),          # N % 4 != 0: rows of x start unaligned
    (4, 32, 4 * _lin_share(4) + 3, "uniform"),
    (16, 2048, 9000, "uniform"),       # table copy and gradient too large for shared memory
    (16, 3584, 9000, "uniform"),       # the largest C * W: the gradient takes 224 KB
], ids=str)
def test_plane_linear_bwd_edges(dev, c, w, n, layout):
    """Against the plain version, 9 tables with lead 3, points off [0, 1]
    and on its ends included."""
    grid = _rand(dev, 9, c, w, lo=0.1, hi=1.0, seed=43)
    if layout == "one column":
        x = torch.full((9, n), 0.4123, device=dev)
    elif layout == "rays":
        x = _ray_points(dev, -(-n // 256), 256, seed=44)[:n].T.repeat(3, 1).contiguous()
    else:
        x = _rand(dev, 9, n, lo=-0.1, hi=1.1, seed=45)
        x[:, :2] = torch.tensor([0.0, 1.0], device=dev)[: min(n, 2)]
    cot = _rand(dev, 9, n, c, lo=-1, hi=1, seed=46)
    before = _cuda.LAUNCHES["plane_linear_bwd"]
    dg, dx = po.plane_linear_bwd(grid, x, cot, 3)
    assert _cuda.LAUNCHES["plane_linear_bwd"] == before + 1
    want_dg, want_dx = po.plane_linear_bwd_plain(grid, x, cot, 3)
    assert _rel(dg, want_dg) <= GRAD_RTOL
    assert not dx[:3].any()
    assert _rel(dx, want_dx) <= GRAD_RTOL
