"""Range-image (pano) <-> point-cloud conversions, numpy.

Port of `lidar4d_tpu/ops/pano.py` (the reference's `utils/convert.py`),
host side:
  * `lidar_to_pano_with_intensities` (convert.py:4-65): points sorted by
    distance, descending, and written in order, so each pixel keeps the
    nearest point and its intensity (the reference loop's z-buffer); ties
    go to the earliest point;
  * `pano_to_lidar_with_intensities` (convert.py:99-138): back-projection
    through the pano ray model.
"""

import numpy as np


def lidar_to_pano_with_intensities(
    local_points_with_intensities: np.ndarray,
    lidar_H: int,
    lidar_W: int,
    lidar_K,
    max_depth: float = 80.0,
):
    """Project (N, 4) lidar-frame points (xyz + intensity) to an (H, W) pano pair."""
    pts = np.asarray(local_points_with_intensities, dtype=np.float64)
    xyz = pts[:, :3]
    intens = pts[:, 3]
    fov_up, fov = lidar_K
    fov_down = fov - fov_up

    dists = np.linalg.norm(xyz, axis=1)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    beta = np.pi - np.arctan2(y, x)
    alpha = np.arctan2(z, np.sqrt(x**2 + y**2)) + fov_down / 180 * np.pi
    c = np.round(beta / (2 * np.pi / lidar_W)).astype(np.int64)
    r = np.round(lidar_H - alpha / (fov / 180 * np.pi / lidar_H)).astype(np.int64)

    valid = (
        (dists < max_depth)
        & (r >= 0)
        & (r < lidar_H)
        & (c >= 0)
        & (c < lidar_W)
    )
    r, c, dists, intens = r[valid], c[valid], dists[valid], intens[valid]

    # Sort by distance descending; sequential writes leave the min-distance
    # point (and its intensity) in each pixel — same z-buffer result as the
    # reference's loop. Ties break to the earliest point in input order
    # (the reference's strict `pano > dist` comparison), hence the secondary
    # descending-index key.
    order = np.lexsort((-np.arange(dists.shape[0]), -dists))
    flat = r[order] * lidar_W + c[order]
    pano = np.zeros(lidar_H * lidar_W)
    intensities = np.zeros(lidar_H * lidar_W)
    pano[flat] = dists[order]
    intensities[flat] = intens[order]
    return pano.reshape(lidar_H, lidar_W), intensities.reshape(lidar_H, lidar_W)


def lidar_to_pano(local_points, lidar_H, lidar_W, lidar_K, max_depth=80.0):
    pts = np.concatenate(
        [local_points, np.zeros((local_points.shape[0], 1))], axis=1
    )
    pano, _ = lidar_to_pano_with_intensities(pts, lidar_H, lidar_W, lidar_K, max_depth)
    return pano


def pano_to_lidar_with_intensities(pano: np.ndarray, intensities, lidar_K):
    """Back-project an (H, W) range pano (+ intensities) to (N, 4) points."""
    fov_up, fov = lidar_K
    H, W = pano.shape
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    beta = -(i - W / 2) / W * 2 * np.pi
    alpha = (fov_up - j / H * fov) / 180 * np.pi
    dirs = np.stack(
        [np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta), np.sin(alpha)],
        axis=-1,
    )
    local_points = dirs * pano.reshape(H, W, 1)
    out = np.concatenate([local_points, intensities.reshape(H, W, 1)], axis=2)
    idx = np.where(pano != 0.0)
    return out[idx]


def pano_to_lidar(pano, lidar_K):
    return pano_to_lidar_with_intensities(pano, np.zeros_like(pano), lidar_K)[:, :3]
