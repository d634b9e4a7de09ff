"""Differentiable bidirectional Chamfer distance, plain PyTorch.

Port of `lidar4d_tpu/ops/chamfer.py` (itself the reference's CUDA extension
`chamfer3D`): squared nearest-neighbour distances and argmin indices in both
directions, with the analytic backward of that extension

    d dist1_i / d x_i =  2 (x_i - y_nn(i))
    d dist1_i / d y_j = -2 (x_i - y_j)   summed over i with nn(i) == j

The forward walks y in tiles of `_TILE` points, so memory stays
O(N * tile): |x|^2 + |y|^2 - 2 x.y per tile, then a running (min, argmin)
in which an earlier tile wins a tie. The JAX version is a `lax.scan`, not a
Pallas kernel, so this plain version is the port.

Precision: float32 throughout, and the port computes exact float32 in both
of the reference's variants. The reference's metric chamfer runs its
matmul at HIGHEST precision and its loss chamfer (`chamfer_distance_fast`)
at DEFAULT, which is one bf16 pass on the TPU and exact on a CPU; here both
are the same float32 computation (the batched product never runs in TF32
unless a caller turns TF32 on globally, which this package never does).

Padded points sit at `_PAD_SENTINEL` (far away), so they never win an
argmin for a real point; callers mask padded queries out of their losses.
"""

import torch

_TILE = 2048
_PAD_SENTINEL = 1e8


def _nn_one_way(x, y):
    """For each point of x [B, N, 3]: squared distance [B, N] and index
    [B, N] int64 of its nearest point in y [B, M, 3]."""
    b, n, _ = x.shape
    x_norm = torch.sum(x * x, dim=-1)                              # [B, N]
    best_d = torch.full((b, n), float("inf"), dtype=x.dtype, device=x.device)
    best_i = torch.zeros((b, n), dtype=torch.int64, device=x.device)
    for start in range(0, y.shape[1], _TILE):
        y_t = y[:, start:start + _TILE]
        y_norm = torch.sum(y_t * y_t, dim=-1)                      # [B, T]
        d = x_norm[:, :, None] + y_norm[:, None, :] - 2.0 * torch.bmm(x, y_t.transpose(1, 2))
        tile_d, tile_i = torch.min(d, dim=-1)
        take = tile_d < best_d
        best_d = torch.where(take, tile_d, best_d)
        best_i = torch.where(take, tile_i + start, best_i)
    # the matmul identity can go slightly negative from rounding
    return torch.clamp(best_d, min=0.0), best_i


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        d1, i1 = _nn_one_way(x, y)
        d2, i2 = _nn_one_way(y, x)
        ctx.save_for_backward(x, y, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x, y, i1, i2 = ctx.saved_tensors
        y_nn = torch.gather(y, 1, i1[..., None].expand(-1, -1, 3))
        x_nn = torch.gather(x, 1, i2[..., None].expand(-1, -1, 3))
        t1 = 2.0 * g1[..., None] * (x - y_nn)                      # d dist1 / dx
        t2 = 2.0 * g2[..., None] * (y - x_nn)                      # d dist2 / dy
        gx = t1.scatter_add(1, i2[..., None].expand(-1, -1, 3), -t2)
        gy = t2.scatter_add(1, i1[..., None].expand(-1, -1, 3), -t1)
        return gx, gy


def chamfer_distance(x, y):
    """x [B, N, 3], y [B, M, 3] -> dist1 [B, N], dist2 [B, M], idx1 [B, N],
    idx2 [B, M] (int64): squared distances to, and indices of, each point's
    nearest neighbour in the other cloud. Differentiable in x and y."""
    return _Chamfer.apply(x, y)


# The reference's loss-grade variant; the same exact float32 computation here.
chamfer_distance_fast = chamfer_distance


def pad_cloud(points, size):
    """Pad [P, 3] to [size, 3] with the far-away sentinel; returns
    (padded, count)."""
    p = points.shape[0]
    out = torch.full((size, 3), _PAD_SENTINEL, dtype=points.dtype, device=points.device)
    out[:min(p, size)] = points[:size]
    return out, min(p, size)


def chamfer_loss(x, y, x_mask=None, y_mask=None, reduction="mean"):
    """Masked symmetric chamfer loss 0.5 * (red(dist1) + red(dist2)).

    Masks select valid (non-padding) points; padded points of the target
    cloud must already sit at the sentinel so they never win a neighbour.
    """
    d1, d2, _, _ = chamfer_distance(x, y)
    if x_mask is not None:
        d1 = d1 * x_mask
    if y_mask is not None:
        d2 = d2 * y_mask
    if reduction == "mean":
        n1 = torch.sum(x_mask) if x_mask is not None else d1.numel()
        n2 = torch.sum(y_mask) if y_mask is not None else d2.numel()
        return 0.5 * (torch.sum(d1) / torch.clamp(torch.as_tensor(n1, dtype=d1.dtype), min=1)
                      + torch.sum(d2) / torch.clamp(torch.as_tensor(n2, dtype=d2.dtype), min=1))
    return 0.5 * (torch.sum(d1) + torch.sum(d2))
