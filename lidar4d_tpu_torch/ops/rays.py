"""LiDAR panorama rays.

Port of `lidar4d_tpu/ops/rays.py`: azimuth beta = -(i - W/2)/W * 2pi,
elevation alpha = (fov_up - j/H * fov) degrees, directions rotated by the
pose, origins at the pose translation. `pano_ray_directions` is numpy (host
side); `get_lidar_rays` is PyTorch on the pose's device, with full-frame,
uniformly random and overlapped-patch sampling, and the random pixel
indices injectable.
"""

import numpy as np
import torch


def pano_ray_directions(i, j, H, W, fov_up, fov):
    """Sensor-frame directions for pano pixel coords (i = column, j = row)."""
    beta = -(i - W / 2) / W * 2 * np.pi
    alpha = (fov_up - j / H * fov) / 180 * np.pi
    return np.stack(
        [np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta), np.sin(alpha)],
        axis=-1)


def patch_dims(patch_size):
    """(px, py) of an int, a 1-tuple or a 2-tuple patch size."""
    if isinstance(patch_size, int):
        return patch_size, patch_size
    if len(patch_size) == 1:
        return patch_size[0], patch_size[0]
    return tuple(patch_size)


def sample_ray_indices(H, W, N, patch_size=1, generator=None, device="cpu"):
    """Random pixel indices [N'] int64 of one training batch (reference
    `get_lidar_rays` with a key): N uniform pixels, or with patch_size > 1
    N // (px * py) overlapped px x py patches with a random top-left, the
    row drawn in [0, H - px), the column in [0, W) and wrapped mod W."""
    px, py = patch_dims(patch_size)
    N = min(N, H * W)
    if px > 1:
        num_patch = N // (px * py)
        ix = torch.randint(0, H - px, (num_patch,), generator=generator, device=device)
        iy = torch.randint(0, W, (num_patch,), generator=generator, device=device)
        pi, pj = torch.meshgrid(torch.arange(px, device=device),
                                torch.arange(py, device=device), indexing="ij")
        rows = (ix[:, None] + pi.reshape(-1)[None]).reshape(-1)
        cols = (iy[:, None] + pj.reshape(-1)[None]).reshape(-1)
        return rows * W + cols % W
    return torch.randint(0, H * W, (N,), generator=generator, device=device)


def get_lidar_rays(pose, intrinsics, H, W, N=-1, patch_size=1, inds=None, generator=None):
    """Rays of one pano frame.

    Args:
      pose: [4, 4] float32 lidar-to-world tensor (offset and scaled).
      intrinsics: (fov_up, fov) in degrees.
      N: number of rays; -1 = every pixel.
      patch_size: int or (px, py); > 1 samples overlapped patches.
      inds: the pixel indices to use instead of drawing them (a test feeds
        the reference's draws in); else `sample_ray_indices` draws from
        `generator`.
    Returns:
      dict(rays_o [N, 3], rays_d [N, 3], inds [N] int64).
    """
    fov_up, fov = intrinsics
    dev = pose.device
    if N > 0:
        if inds is None:
            inds = sample_ray_indices(H, W, N, patch_size, generator, dev)
        if not torch.is_tensor(inds):
            inds = torch.from_numpy(np.array(inds))
        inds = inds.to(dev).long()
    else:
        inds = torch.arange(H * W, device=dev)
    i = (inds % W).float()
    j = torch.div(inds, W, rounding_mode="floor").float()
    beta = -(i - W / 2) / W * 2 * np.pi
    alpha = (fov_up - j / H * fov) / 180 * np.pi
    directions = torch.stack([torch.cos(alpha) * torch.cos(beta),
                              torch.cos(alpha) * torch.sin(beta),
                              torch.sin(alpha)], dim=-1)
    rays_d = directions @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}
