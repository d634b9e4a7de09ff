"""K-planes lookups on the CUDA kernels `plane_bilinear_fwd` / `_bwd` /
`_vjp` and `plane_linear_fwd` / `_bwd`.

Port of `lidar4d_tpu/ops/plane_onehot.py`. The TPU kernels contract weighted
2-hot vectors with the planes as bf16 matmuls, forward and backward; on
Hopper the kernels (`csrc/plane_bilinear_*.cu`, `csrc/plane_linear_*.cu`)
gather the corners and interpolate in exact float32, and scatter the
gradient with float32 atomics.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. The plain versions are the float32
`grid_sample_2d` and an explicit float32 lerp — not the reference's bf16
`plane_linear_ref` — and their backward halves are autograd of them, but
for `plane_bilinear`'s coordinate gradient, which is written out in the
kernel's subgradient convention (below).

Gradient contracts (the reference's custom VJPs):
  * `plane_bilinear(coord_grad=True)`, the default: the plane gradient and
    the coordinate gradient, both from `plane_bilinear_vjp` (the reference's
    `_vjp_bwd`; kernel `csrc/plane_bilinear_vjp.cu`).
  * `plane_bilinear(coord_grad=False)`: the plane gradient only
    (`plane_bilinear_bwd`), and a silent zero for pts (static planes: pts
    are ray positions).
  * `plane_linear(coord_grad_lead)`: the table gradient, and the coordinate
    gradient for the tables from `coord_grad_lead` on; the first
    `coord_grad_lead` tables get zero and their kernel skips that work.

Coordinate subgradient convention (kernel and plain version alike): the
reference kernel's tent. d/du of the bilinear weights is taken as
sign(x - u) * [|x - u| < 1] per pixel column x, which is 0 at an exact
integer u (u = clip(px, 0, 1) * (W - 1)), so du = 0 there, on the border
u = 0 and u = W - 1 included; dv likewise. The chain through the clip
passes 1 on the closed interval 0 <= px <= 1 and 0 outside. Elsewhere this
is the float32 gather's gradient (`jax.grad` of `grid_sample_2d`), which
takes a one-sided difference at integers instead; per-sample times at frame
nodes (t = k / (T - 1)) put v on integers often.
"""

import torch

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops.grid_sample import grid_sample_2d

_KERNEL_CHANNELS = (4, 8, 16)


def plane_bilinear_plain(grid, pts):
    """Plain version of `plane_bilinear_fwd`: [P, C, H, W], [P, N, 2] -> [P, C, N]."""
    return torch.stack([grid_sample_2d(g, p).T for g, p in zip(grid, pts)])


def plane_bilinear_fwd(grid, pts):
    """Bilinear-sample P feature planes at P point sets (no autograd).

    Args:
      grid: [P, C, H, W] float32 planes.
      pts:  [P, N, 2] in [0, 1]; pts[..., 0] indexes W, pts[..., 1] indexes H
            (align_corners=True, border clamp — `ops.grid_sample`).
    Returns:
      [P, C, N] float32.
    """
    p, c, h, w = grid.shape
    if pts.shape[0] != p or pts.shape[2] != 2:
        raise ValueError(f"plane_bilinear: grid {tuple(grid.shape)} / pts {tuple(pts.shape)}")
    if pts.device.type == "cpu":
        return plane_bilinear_plain(grid, pts)
    _cuda.check_cuda_tensor("grid", grid)
    _cuda.check_cuda_tensor("pts", pts)
    pts = _cuda.aligned(pts, 8)
    n = pts.shape[1]
    out = torch.empty((p, c, n), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    _cuda.launch("plane_bilinear_fwd", pts.device, grid.data_ptr(), pts.data_ptr(),
                 out.data_ptr(), p, n, c, h, w)
    return out


def plane_bilinear_bwd_plain(pts, cot, hw):
    """Plain version of `plane_bilinear_bwd`: autograd of
    `plane_bilinear_plain` with respect to the planes."""
    p, c, _ = cot.shape
    with torch.enable_grad():
        grid = torch.zeros((p, c, *hw), dtype=cot.dtype, device=cot.device,
                           requires_grad=True)
        (dgrid,) = torch.autograd.grad(plane_bilinear_plain(grid, pts.detach()), grid, cot)
    return dgrid


def plane_bilinear_bwd(pts, cot, hw):
    """Plane gradient of `plane_bilinear_fwd`: pts [P, N, 2], cot [P, C, N],
    hw = (H, W) -> dG [P, C, H, W] float32."""
    p, c, n = cot.shape
    if pts.shape != (p, n, 2):
        raise ValueError(f"plane_bilinear_bwd: pts {tuple(pts.shape)} / cot {tuple(cot.shape)}")
    if pts.device.type == "cpu":
        return plane_bilinear_bwd_plain(pts, cot, hw)
    if c not in _KERNEL_CHANNELS:
        raise ValueError(f"plane_bilinear_bwd kernel takes C in {_KERNEL_CHANNELS}, got {c}")
    _cuda.check_cuda_tensor("pts", pts)
    _cuda.check_cuda_tensor("cot", cot)
    pts = _cuda.aligned(pts, 8)
    dgrid = torch.zeros((p, c, *hw), dtype=torch.float32, device=pts.device)
    if n == 0:
        return dgrid
    _cuda.launch("plane_bilinear_bwd", pts.device, pts.data_ptr(), cot.data_ptr(),
                 dgrid.data_ptr(), p, n, c, hw[0], hw[1])
    return dgrid


def plane_bilinear_vjp_plain(grid, pts, cot):
    """Plain version of `plane_bilinear_vjp`: (dG, dpts) in float32 with
    the tent convention of the module docstring."""
    p, c, h, w = grid.shape
    dgrid = plane_bilinear_bwd_plain(pts, cot, (h, w))
    px, py = pts[..., 0], pts[..., 1]
    x = torch.clamp(px, 0.0, 1.0) * (w - 1)
    y = torch.clamp(py, 0.0, 1.0) * (h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    flat = grid.reshape(p, c, h * w)

    def corner(yi, xi):                                          # [P, C, N]
        return torch.gather(flat, 2, (yi * w + xi)[:, None, :].expand(-1, c, -1))

    g00, g01, g10, g11 = corner(y0i, x0i), corner(y0i, x1i), corner(y1i, x0i), corner(y1i, x1i)
    tx_, ty_ = tx[:, None, :], ty[:, None, :]
    du = torch.sum(cot * ((1.0 - ty_) * (g01 - g00) + ty_ * (g11 - g10)), dim=1)
    dv = torch.sum(cot * ((1.0 - tx_) * (g10 - g00) + tx_ * (g11 - g01)), dim=1)
    live_x = (tx != 0) & (px >= 0.0) & (px <= 1.0)
    live_y = (ty != 0) & (py >= 0.0) & (py <= 1.0)
    dpts = torch.stack([torch.where(live_x, du * (w - 1), 0.0),
                        torch.where(live_y, dv * (h - 1), 0.0)], dim=-1)
    return dgrid, dpts


def plane_bilinear_vjp(grid, pts, cot):
    """Both gradients of `plane_bilinear_fwd`: grid [P, C, H, W], pts
    [P, N, 2], cot [P, C, N] -> (dG [P, C, H, W], dpts [P, N, 2]) float32,
    with the tent convention of the module docstring."""
    p, c, h, w = grid.shape
    n = pts.shape[1]
    if pts.shape != (p, n, 2) or cot.shape != (p, c, n):
        raise ValueError(f"plane_bilinear_vjp: grid {tuple(grid.shape)} / pts "
                         f"{tuple(pts.shape)} / cot {tuple(cot.shape)}")
    if pts.device.type == "cpu":
        return plane_bilinear_vjp_plain(grid, pts, cot)
    if c not in _KERNEL_CHANNELS:
        raise ValueError(f"plane_bilinear_vjp kernel takes C in {_KERNEL_CHANNELS}, got {c}")
    for name, t in (("grid", grid), ("pts", pts), ("cot", cot)):
        _cuda.check_cuda_tensor(name, t)
    pts = _cuda.aligned(pts, 8)
    dgrid = torch.zeros((p, c, h, w), dtype=torch.float32, device=pts.device)
    dpts = torch.empty((p, n, 2), dtype=torch.float32, device=pts.device)
    if n == 0:
        return dgrid, dpts
    _cuda.launch("plane_bilinear_vjp", pts.device, grid.data_ptr(), pts.data_ptr(),
                 cot.data_ptr(), dgrid.data_ptr(), dpts.data_ptr(), p, n, c, h, w)
    return dgrid, dpts


class _PlaneBilinear(torch.autograd.Function):
    """`plane_bilinear_fwd`; backward `plane_bilinear_vjp` when pts need a
    gradient and `coord_grad`, else `plane_bilinear_bwd` (pts get zero)."""

    @staticmethod
    def forward(ctx, grid, pts, coord_grad):
        ctx.coord_grad = coord_grad
        ctx.save_for_backward(grid, pts)
        return plane_bilinear_fwd(grid, pts)

    @staticmethod
    def backward(ctx, cot):
        grid, pts = ctx.saved_tensors
        cot = cot.contiguous()
        dgrid = dpts = None
        if ctx.coord_grad and ctx.needs_input_grad[1]:
            dgrid, dpts = plane_bilinear_vjp(grid, pts, cot)
        elif ctx.needs_input_grad[0]:
            dgrid = plane_bilinear_bwd(pts, cot, tuple(grid.shape[2:]))
        if ctx.needs_input_grad[1] and dpts is None:
            dpts = torch.zeros_like(pts)
        return (dgrid if ctx.needs_input_grad[0] else None), dpts, None


def plane_bilinear(grid, pts, coord_grad=True):
    """Bilinear-sample P feature planes at P point sets: [P, C, H, W],
    [P, N, 2] -> [P, C, N] (see `plane_bilinear_fwd`), differentiable in the
    planes and, with coord_grad=True (the reference's default), in pts;
    coord_grad=False gives pts a zero gradient."""
    return _PlaneBilinear.apply(grid, pts, coord_grad)


# The reference's name for its gather path of `plane_bilinear`.
plane_bilinear_ref = plane_bilinear_plain


def plane_linear_plain(grid, x):
    """Plain version of `plane_linear_fwd`: explicit float32 lerp,
    [P, C, W], [P, N] -> [P, N, C]."""
    p, c, w = grid.shape
    u = torch.clamp(x, 0.0, 1.0) * (w - 1)
    j0 = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 1)
    j1 = torch.clamp(j0 + 1, max=w - 1)
    f = (u - j0.to(u.dtype))[:, :, None]                        # [P, N, 1]
    gt = grid.transpose(1, 2)                                   # [P, W, C]
    g0 = torch.gather(gt, 1, j0[:, :, None].expand(-1, -1, c))  # [P, N, C]
    g1 = torch.gather(gt, 1, j1[:, :, None].expand(-1, -1, c))
    return (1.0 - f) * g0 + f * g1


# The reference's name for its pure-XLA `plane_linear`, which is a one-hot
# bfloat16 matmul; the port's is the exact float32 lerp.
plane_linear_ref = plane_linear_plain


def plane_linear_fwd(grid, x):
    """Linear-interpolate P 1-D feature tables at P coordinate sets (no
    autograd): grid [P, C, W] float32, x [P, N] in [0, 1] -> [P, N, C]
    float32, with u = clip(x, 0, 1) * (W - 1) (align_corners)."""
    p, c, w = grid.shape
    if x.shape[0] != p:
        raise ValueError(f"plane_linear: grid {tuple(grid.shape)} / x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plane_linear_plain(grid, x)
    if c not in _KERNEL_CHANNELS:
        raise ValueError(f"plane_linear kernel takes C in {_KERNEL_CHANNELS}, got {c}")
    _cuda.check_cuda_tensor("grid", grid)
    _cuda.check_cuda_tensor("x", x)
    n = x.shape[1]
    out = torch.empty((p, n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _cuda.launch("plane_linear_fwd", x.device, grid.data_ptr(), x.data_ptr(),
                 out.data_ptr(), p, n, c, w)
    return out


# The launch of `plane_linear_bwd` (csrc/plane_linear_bwd.cu): threads a
# block (the kernel's kThreads), the fewest consecutive points a group of C
# lanes takes, and the shared memory a block may take (the kernel's
# kSmemLimit, the H100's 227 KB).
LIN_BWD_THREADS = 256
LIN_BWD_MIN_RUN = 16
LIN_BWD_SMEM_LIMIT = 227 * 1024


def plane_linear_bwd_table_copy(c, w):
    """Whether `plane_linear_bwd` reads the table from a copy in shared
    memory beside its [W][C] gradient (2 x C x W floats in all) for C
    channels and W columns, or through L1 where both do not fit."""
    return 2 * c * w * 4 <= LIN_BWD_SMEM_LIMIT


def plane_linear_bwd_plain(grid, x, cot, lead=0):
    """Plain version of `plane_linear_bwd`: autograd of `plane_linear_plain`,
    with the coordinate gradient of the first `lead` tables set to zero."""
    with torch.enable_grad():
        g = grid.detach().requires_grad_()
        xx = x.detach().requires_grad_()
        dgrid, dx = torch.autograd.grad(plane_linear_plain(g, xx), (g, xx), cot)
    dx[:lead] = 0.0
    return dgrid, dx


def plane_linear_bwd(grid, x, cot, lead=0):
    """Gradients of `plane_linear_fwd`: grid [P, C, W], x [P, N], cot
    [P, N, C] -> (dG [P, C, W], dx [P, N]), dx zero for the first `lead`
    tables (whose coordinate work the kernel skips)."""
    p, c, w = grid.shape
    n = x.shape[1]
    if x.shape != (p, n) or cot.shape != (p, n, c):
        raise ValueError(f"plane_linear_bwd: grid {tuple(grid.shape)} / x {tuple(x.shape)} "
                         f"/ cot {tuple(cot.shape)}")
    lead = min(max(lead, 0), p)
    if x.device.type == "cpu":
        return plane_linear_bwd_plain(grid, x, cot, lead)
    if c not in _KERNEL_CHANNELS:
        raise ValueError(f"plane_linear kernel takes C in {_KERNEL_CHANNELS}, got {c}")
    for name, t in (("grid", grid), ("x", x), ("cot", cot)):
        _cuda.check_cuda_tensor(name, t)
    dgrid = torch.zeros((p, c, w), dtype=torch.float32, device=x.device)
    dx = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return dgrid, dx
    copy = int(plane_linear_bwd_table_copy(c, w))
    bps = _cuda.blocks_per_sm("plane_linear_bwd_blocks_per_sm", c, w, copy)
    run = _cuda.persistent_run(n, LIN_BWD_THREADS // c, p, LIN_BWD_MIN_RUN,
                               _cuda.sm_count(x.device), bps)
    _cuda.launch("plane_linear_bwd", x.device, grid.data_ptr(), x.data_ptr(), cot.data_ptr(),
                 dgrid.data_ptr(), dx.data_ptr(), p, n, c, w, lead, run, copy)
    return dgrid, dx


class _PlaneLinear(torch.autograd.Function):
    """`plane_linear_fwd`, backward `plane_linear_bwd` with the static lead."""

    @staticmethod
    def forward(ctx, grid, x, lead):
        ctx.lead = lead
        ctx.save_for_backward(grid, x)
        return plane_linear_fwd(grid, x)

    @staticmethod
    def backward(ctx, cot):
        grid, x = ctx.saved_tensors
        lead = ctx.lead if ctx.needs_input_grad[1] else grid.shape[0]
        dgrid, dx = plane_linear_bwd(grid, x, cot.contiguous(), lead)
        return (dgrid if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None)


def plane_linear(grid, x, coord_grad_lead=0):
    """Linear-interpolate P 1-D feature tables at P coordinate sets:
    [P, C, W], [P, N] -> [P, N, C] (see `plane_linear_fwd`), differentiable
    in grid and x; the first `coord_grad_lead` tables get a zero x gradient
    (their coordinates are raw ray positions) and skip that work."""
    return _PlaneLinear.apply(grid, x, coord_grad_lead)
