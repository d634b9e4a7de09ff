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

from typing import NamedTuple

import torch

from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.ops.grid_sample import grid_sample_2d
from lidar4d_tpu_torch.ops.hash_onehot import _chunks

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


# The launch of `plane_bilinear_bwd` (csrc/plane_bilinear_bwd.cu): threads a
# block (the kernel's kThreads), points a lane group loads at once (its
# kChunk; runs are multiples of it), the fewest consecutive points a group
# takes, the shared memory a block may take (its kSmemLimit, the H100's
# 227 KB), the shared memory a block's channel slice should stay within so
# that several blocks share an SM, and the resident waves the grid fills.
PLANE_BWD_THREADS = 512
PLANE_BWD_CHUNK = 8
PLANE_BWD_MIN_RUN = 16
PLANE_BWD_SMEM_LIMIT = 227 * 1024
PLANE_BWD_SLICE_BYTES = PLANE_BWD_SMEM_LIMIT // 3
PLANE_BWD_WAVES = 1
_SLICES = (16, 8, 4, 2, 1)


def plane_bilinear_bwd_stride(h, w):
    """Floats a channel takes in the kernel's shared accumulator: H x W
    rounded up to 4, plus 4 (channels start on different banks)."""
    return -(-h * w // 4) * 4 + 4


def plane_bilinear_bwd_slice(c, h, w, slice_bytes=None):
    """Channels a block of `plane_bilinear_bwd` accumulates in shared memory
    for C channels of H x W: the most (a power of two dividing C) whose
    accumulator fits `slice_bytes` (default PLANE_BWD_SLICE_BYTES), else
    one channel if it fits the 227 KB at all, else 0: the global path."""
    slice_bytes = PLANE_BWD_SLICE_BYTES if slice_bytes is None else slice_bytes
    floats = plane_bilinear_bwd_stride(h, w)
    for cb in _SLICES:
        if cb <= c and c % cb == 0 and cb * floats * 4 <= slice_bytes:
            return cb
    return 1 if floats * 4 <= PLANE_BWD_SMEM_LIMIT else 0


def plane_bilinear_bwd_run(n, c, cb, n_planes, sms, blocks_per_sm):
    """Consecutive points a lane group of `plane_bilinear_bwd` takes: the
    persistent run for P x C / cb slices (cb = 0: the global path's groups of
    min(C, 8) lanes), rounded up to a multiple of PLANE_BWD_CHUNK."""
    lanes = cb or min(c, 8)
    run = _cuda.persistent_run(n, PLANE_BWD_THREADS // lanes, n_planes * (c // lanes),
                               PLANE_BWD_MIN_RUN, sms, blocks_per_sm, PLANE_BWD_WAVES)
    return -(-run // PLANE_BWD_CHUNK) * PLANE_BWD_CHUNK


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
    h, w = hw
    dgrid = torch.zeros((p, c, h, w), dtype=torch.float32, device=pts.device)
    if n == 0:
        return dgrid
    cb = plane_bilinear_bwd_slice(c, h, w)
    stride = plane_bilinear_bwd_stride(h, w)
    bps = _cuda.blocks_per_sm("plane_bilinear_bwd_blocks_per_sm", c, cb, h, w, stride)
    run = plane_bilinear_bwd_run(n, c, cb, p, _cuda.sm_count(pts.device), bps)
    _cuda.launch("plane_bilinear_bwd", pts.device, pts.data_ptr(), cot.data_ptr(),
                 dgrid.data_ptr(), p, n, c, h, w, cb, run, stride)
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


# The launch of `plane_bilinear_vjp` (csrc/plane_bilinear_vjp.cu): the most
# threads a block (the kernel's kMaxThreads) and the threads a block takes,
# points a lane group loads at once (its kChunk; runs are multiples of it),
# the fewest consecutive points a group takes, the shared memory a block may
# take (its kSmemLimit, the H100's 227 KB), the SM's unified L1 / shared
# memory and the threads resident on an SM, the shared memory CUDA
# reserves a block, the L1 a launch that reads the plane through L1 keeps,
# whether the plane may be staged in shared memory and the blocks an SM
# must still hold with it staged (two: the kernel's occupancy by its 64
# registers a thread), and the resident waves the grid fills (staging,
# waves and threads are the variants PERF.md times). The kernel's modes: dG
# added to global memory directly, accumulated in shared memory, and
# accumulated there beside a staged copy of the plane.
PLANE_VJP_MAX_THREADS = 512
PLANE_VJP_THREADS = 512
PLANE_VJP_CHUNK = 8
PLANE_VJP_MIN_RUN = 16
PLANE_VJP_SMEM_LIMIT = 227 * 1024
PLANE_VJP_SM_SMEM = 228 * 1024
PLANE_VJP_SM_THREADS = 2048
PLANE_VJP_BLOCK_RESERVE = 1024
PLANE_VJP_L1_KEEP = 64 * 1024
PLANE_VJP_STAGE = True
PLANE_VJP_STAGE_BLOCKS = 2
PLANE_VJP_WAVES = 1
PLANE_VJP_GLOBAL, PLANE_VJP_SHARED, PLANE_VJP_STAGED = 0, 1, 2


class VjpLaunch(NamedTuple):
    """One launch of `plane_bilinear_vjp`: the kernel's mode, the floats a
    channel takes in shared memory (`plane_bilinear_bwd_stride`), and the
    SM's shared-memory share in percent (-1: the default)."""
    mode: int
    stride: int
    carveout: int


def plane_bilinear_vjp_smem(c, mode, stride):
    """Dynamic shared memory of a `plane_bilinear_vjp` block in bytes: none
    on the global path, the [C][stride] accumulator, and with the staged
    plane a second [C][stride] and the 16-byte mbarrier."""
    if mode == PLANE_VJP_GLOBAL:
        return 0
    acc = c * stride * 4
    return 2 * acc + 16 if mode == PLANE_VJP_STAGED else acc


def plane_bilinear_vjp_plan(c, h, w):
    """The `VjpLaunch` of `plane_bilinear_vjp` for C channels of H x W.

    A plane whose [C, H, W] gradient does not fit the 227 KB takes the
    global path (the default shared-memory share). Else the block
    accumulates it in shared memory, and stages the plane beside it (bulk
    copies of H x W floats, a multiple of 4; all of the SM's fast memory
    shared) where PLANE_VJP_STAGE and PLANE_VJP_STAGE_BLOCKS such blocks fit
    an SM (the flagship time planes at S <= 128); otherwise it reads the
    plane through L1 (S = 256), with a shared-memory share that holds the
    resident blocks (as many as the SM's threads allow) and leaves
    PLANE_VJP_L1_KEEP bytes of L1, at least one block's."""
    stride = plane_bilinear_bwd_stride(h, w)
    acc = plane_bilinear_vjp_smem(c, PLANE_VJP_SHARED, stride)
    if acc > PLANE_VJP_SMEM_LIMIT:
        return VjpLaunch(PLANE_VJP_GLOBAL, stride, -1)
    staged = plane_bilinear_vjp_smem(c, PLANE_VJP_STAGED, stride)
    if (PLANE_VJP_STAGE and h * w % 4 == 0 and staged <= PLANE_VJP_SMEM_LIMIT
            and PLANE_VJP_STAGE_BLOCKS * (staged + PLANE_VJP_BLOCK_RESERVE)
            <= PLANE_VJP_SM_SMEM):
        return VjpLaunch(PLANE_VJP_STAGED, stride, 100)
    block = acc + PLANE_VJP_BLOCK_RESERVE
    blocks = max(1, min(PLANE_VJP_SM_THREADS // PLANE_VJP_THREADS,
                        (PLANE_VJP_SM_SMEM - PLANE_VJP_L1_KEEP) // block))
    return VjpLaunch(PLANE_VJP_SHARED, stride,
                     min(100, -(-100 * blocks * block // PLANE_VJP_SM_SMEM)))


def plane_bilinear_vjp_run(n, c, n_planes, sms, blocks_per_sm):
    """Consecutive points a lane group (C lanes) of `plane_bilinear_vjp`
    takes: the persistent run for P planes of blocks of PLANE_VJP_THREADS
    threads, rounded up to a multiple of PLANE_VJP_CHUNK."""
    run = _cuda.persistent_run(n, PLANE_VJP_THREADS // c, n_planes, PLANE_VJP_MIN_RUN, sms,
                               blocks_per_sm, PLANE_VJP_WAVES)
    return -(-run // PLANE_VJP_CHUNK) * PLANE_VJP_CHUNK


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
    grid = _cuda.aligned(grid)
    pts = _cuda.aligned(pts, 8)
    dgrid = torch.zeros((p, c, h, w), dtype=torch.float32, device=pts.device)
    dpts = torch.empty((p, n, 2), dtype=torch.float32, device=pts.device)
    if n == 0:
        return dgrid, dpts
    plan = plane_bilinear_vjp_plan(c, h, w)
    bps = _cuda.blocks_per_sm("plane_bilinear_vjp_blocks_per_sm", c, plan.mode, h, w,
                              PLANE_VJP_THREADS, plan.stride, plan.carveout)
    run = plane_bilinear_vjp_run(n, c, p, _cuda.sm_count(pts.device), bps)
    _cuda.launch("plane_bilinear_vjp", pts.device, grid.data_ptr(), pts.data_ptr(),
                 cot.data_ptr(), dgrid.data_ptr(), dpts.data_ptr(), p, n, c, h, w, plan.mode,
                 PLANE_VJP_THREADS, run, plan.stride, plan.carveout)
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


def plane_linear_ref(grid, x):
    """The reference's pure-XLA `plane_linear_ref`: the tent 2-hot
    relu(1 - |iota - u|) rounded to bfloat16 times the bfloat16 table,
    [P, C, W], [P, N] -> [P, N, C]. The products of bfloat16 values are
    exact and at most two per output are nonzero, so the float64 matmul
    rounded to float32 is the float32-accumulated matmul (and no TF32
    setting reaches it); autograd differentiates it in grid and x, through
    the tent. A witness: `plane_linear_plain` is the exact float32 lerp the
    main path's kernel is held to."""
    w = grid.shape[2]
    u = torch.clamp(x, 0.0, 1.0) * (w - 1)
    iota = torch.arange(w, dtype=torch.float32, device=x.device)
    oh = torch.clamp(1.0 - torch.abs(iota[None, None, :] - u[..., None]), min=0.0)
    g = grid.to(torch.bfloat16).to(torch.float64)
    return torch.matmul(oh.to(torch.bfloat16).to(torch.float64),
                        g.transpose(1, 2)).to(torch.float32)


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


# ------------------------------------------------- the TPU kernels' numerics
#
# Plain versions of what the reference's Pallas kernels compute on the TPU,
# witnesses of whether that arithmetic moves a run's quality and never the
# main path (`chip_smoke.tpu_numerics` swaps them in). The kernels build
# the align_corners tents relu(1 - |s - u|) in float32 and round them,
# the planes and the cotangents to bfloat16 for the MXU, which accumulates
# in float32. A tent has two nonzero taps, at s0 = floor(u) and s0 + 1
# (zero when u is an integer); the twins take those two, form the same
# exact products and add them in float32.


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _taps(u, size):
    """The two tent taps at u in [0, size - 1]: columns s0 (clamped into the
    table) and s1 = min(s0 + 1, size - 1), and their float32 tents, the
    second zero wherever s0 + 1 is past the table (u = size - 1)."""
    s0f = torch.floor(u)
    t0 = torch.clamp(1.0 - torch.abs(s0f - u), min=0.0)
    t1 = torch.clamp(1.0 - torch.abs(s0f + 1.0 - u), min=0.0)
    s0 = torch.clamp(s0f.to(torch.int64), 0, size - 1)
    s1 = torch.clamp(s0 + 1, max=size - 1)
    return s0, s1, t0, t1


def _bilinear_taps(pts, h, w):
    u = torch.clamp(pts[..., 0], 0.0, 1.0) * (w - 1)
    v = torch.clamp(pts[..., 1], 0.0, 1.0) * (h - 1)
    return _taps(u, w), _taps(v, h)


def plane_bilinear_tpu(grid, pts):
    """`plane_bilinear_fwd` as the TPU computes it (`_fwd_kernel`): the
    bfloat16 plane times the bfloat16 x tents on the MXU (float32 sums),
    then times the bfloat16 y tents in float32. [P, C, H, W], [P, N, 2] ->
    [P, C, N]."""
    p, c, h, w = grid.shape
    flat = _bf16(grid).reshape(p, c, h * w)
    out = torch.empty((p, c, pts.shape[1]), dtype=torch.float32, device=pts.device)
    for s, e in _chunks(pts.shape[1]):
        (x0, x1, tx0, tx1), (y0, y1, ty0, ty1) = _bilinear_taps(pts[:, s:e], h, w)

        def row(y):
            def at(x):
                return torch.gather(flat, 2, (y * w + x)[:, None, :].expand(-1, c, -1))
            return at(x0) * _bf16(tx0)[:, None] + at(x1) * _bf16(tx1)[:, None]

        out[:, :, s:e] = row(y0) * _bf16(ty0)[:, None] + row(y1) * _bf16(ty1)[:, None]
    return out


def plane_bilinear_bwd_tpu(pts, cot, hw):
    """`plane_bilinear_bwd` as the TPU computes it (`_bwd_kernel_tables`):
    bf16(bf16(y tent) * cot) times the bfloat16 x tent, accumulated in a
    float32 gradient. Returns [P, C, H, W]."""
    p, c, _ = cot.shape
    h, w = hw
    (x0, x1, tx0, tx1), (y0, y1, ty0, ty1) = _bilinear_taps(pts, h, w)
    dflat = torch.zeros((p, c, h * w), dtype=torch.float32, device=cot.device)
    for y, ty in ((y0, ty0), (y1, ty1)):
        a = _bf16(_bf16(ty)[:, None] * cot)                               # [P, C, N]
        for x, tx in ((x0, tx0), (x1, tx1)):
            dflat.scatter_add_(2, (y * w + x)[:, None, :].expand(-1, c, -1),
                               a * _bf16(tx)[:, None])
    return dflat.reshape(p, c, h, w)


def tpu_linear_gathers(c, w):
    """Whether the TPU's `plane_linear` forward at C channels and W columns
    is its exact float32 gather form (`_lin_fwd_kernel_gather`: C = 8 and
    one 128-lane row), else the bfloat16 tent matmul (`_lin_fwd_kernel`)."""
    return c == 8 and w <= 128


def plane_linear_tpu(grid, x):
    """`plane_linear_fwd` as the TPU computes it: the exact float32 lerp
    where the TPU gathers (`tpu_linear_gathers`), else the bfloat16 table
    times the bfloat16 tents, added in float32. [P, C, W], [P, N] ->
    [P, N, C]."""
    p, c, w = grid.shape
    gathers = tpu_linear_gathers(c, w)
    gt = _bf16(grid).transpose(1, 2)                                     # [P, W, C]
    out = torch.empty((p, x.shape[1], c), dtype=torch.float32, device=x.device)
    for s, e in _chunks(x.shape[1]):
        if gathers:
            out[:, s:e] = plane_linear_plain(grid, x[:, s:e])
            continue
        s0, s1, t0, t1 = _taps(torch.clamp(x[:, s:e], 0.0, 1.0) * (w - 1), w)
        g0 = torch.gather(gt, 1, s0[:, :, None].expand(-1, -1, c))
        g1 = torch.gather(gt, 1, s1[:, :, None].expand(-1, -1, c))
        out[:, s:e] = g0 * _bf16(t0)[..., None] + g1 * _bf16(t1)[..., None]
    return out


def plane_linear_bwd_tpu(grid, x, cot, lead=0):
    """`plane_linear_bwd` as the TPU computes it (`_lin_bwd_kernel`): the
    table gradient sums bfloat16 cotangents times bfloat16 tents in float32;
    the coordinate gradient contracts bf16(grid) with bf16(cot) over C in
    float32 at both taps, signed by the tents' derivative (-1 at s0 where u
    is past it, +1 at s0 + 1 where its tent is positive), times (W - 1)
    inside [0, 1]; zero for the first `lead` tables. Returns (dG, dx)."""
    p, c, w = grid.shape
    u = torch.clamp(x, 0.0, 1.0) * (w - 1)
    s0, s1, t0, t1 = _taps(u, w)
    cot_b = _bf16(cot)                                                   # [P, N, C]
    dgt = torch.zeros((p, w, c), dtype=torch.float32, device=x.device)
    dgt.scatter_add_(1, s0[:, :, None].expand(-1, -1, c), cot_b * _bf16(t0)[..., None])
    dgt.scatter_add_(1, s1[:, :, None].expand(-1, -1, c), cot_b * _bf16(t1)[..., None])
    gt = _bf16(grid).transpose(1, 2)
    m0 = torch.sum(torch.gather(gt, 1, s0[:, :, None].expand(-1, -1, c)) * cot_b, dim=2)
    m1 = torch.sum(torch.gather(gt, 1, s1[:, :, None].expand(-1, -1, c)) * cot_b, dim=2)
    dt = (torch.where(t1 > 0.0, m1, 0.0)
          - torch.where(u > torch.floor(u), m0, 0.0))
    in_rng = ((x >= 0.0) & (x <= 1.0)).to(torch.float32)
    dx = dt * (w - 1) * in_rng
    dx[:lead] = 0.0
    return dgt.transpose(1, 2).contiguous(), dx
