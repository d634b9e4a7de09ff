"""K-planes lookups on the CUDA kernels `plane_bilinear_fwd` / `_bwd` and
`plane_linear_fwd` / `_bwd`.

Port of `lidar4d_tpu/ops/plane_onehot.py`. The TPU kernels contract weighted
2-hot vectors with the planes as bf16 matmuls, forward and backward; on
Hopper the kernels (`csrc/plane_bilinear_*.cu`, `csrc/plane_linear_*.cu`)
gather the corners and interpolate in exact float32, and scatter the
gradient with float32 atomics.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. The plain versions are the float32
`grid_sample_2d` and an explicit float32 lerp — not the reference's bf16
`plane_linear_ref` — and their backward halves are autograd of them.

Gradient contracts (the reference's custom VJPs):
  * `plane_bilinear(coord_grad=False)`: the plane gradient only, and a
    silent zero for pts (static planes: pts are ray positions).
    `coord_grad=True` (the coordinate gradient, TPU row `_vjp_bwd`) has no
    kernel yet: it runs the plain version on the CPU and raises on CUDA.
  * `plane_linear(coord_grad_lead)`: the table gradient, and the coordinate
    gradient for the tables from `coord_grad_lead` on; the first
    `coord_grad_lead` tables get zero and their kernel skips that work.
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


class _PlaneBilinear(torch.autograd.Function):
    """`plane_bilinear_fwd`, backward `plane_bilinear_bwd`; pts get zero."""

    @staticmethod
    def forward(ctx, grid, pts):
        ctx.hw = tuple(grid.shape[2:])
        ctx.save_for_backward(pts)
        return plane_bilinear_fwd(grid, pts)

    @staticmethod
    def backward(ctx, cot):
        (pts,) = ctx.saved_tensors
        dgrid = dpts = None
        if ctx.needs_input_grad[0]:
            dgrid = plane_bilinear_bwd(pts, cot.contiguous(), ctx.hw)
        if ctx.needs_input_grad[1]:
            dpts = torch.zeros_like(pts)
        return dgrid, dpts


def plane_bilinear(grid, pts, coord_grad=False):
    """Bilinear-sample P feature planes at P point sets: [P, C, H, W],
    [P, N, 2] -> [P, C, N] (see `plane_bilinear_fwd`), differentiable in the
    planes; pts get a zero gradient unless coord_grad=True, which runs the
    plain version, differentiable in pts too, and raises on CUDA (its kernel,
    the reference's `_vjp_bwd`, is not ported yet)."""
    if coord_grad:
        if pts.device.type != "cpu":
            raise NotImplementedError(
                "plane_bilinear(coord_grad=True) has no CUDA kernel yet")
        return plane_bilinear_plain(grid, pts)
    return _PlaneBilinear.apply(grid, pts)


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
    cot = _cuda.aligned(cot)
    dgrid = torch.zeros((p, c, w), dtype=torch.float32, device=x.device)
    dx = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return dgrid, dx
    _cuda.launch("plane_linear_bwd", x.device, grid.data_ptr(), x.data_ptr(), cot.data_ptr(),
                 dgrid.data_ptr(), dx.data_ptr(), p, n, c, w, lead)
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
