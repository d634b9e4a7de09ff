"""Synthetic LiDAR sequence generator (for tests, smoke fits and benches).

A numpy copy of `lidar4d_tpu/data/synthetic.py` (the port imports nothing
of the JAX package); the same seed writes the same files.

Produces data in exactly the reference's on-disk format
(`data/preprocess/generate_rangeview.py` + `kitti360_to_nerf.py` output):
per-frame range-view npys [H, W, 3] = (unused, intensity, depth-meters) and
`transforms_{seq}_{split}.json` files with per-frame `lidar2world`, so the
KITTI360Dataset and the whole training/eval stack run on it unchanged.

The scene: a ground plane, a set of static boxes, and one moving box (so the
dynamic field + flow have signal), ray-cast analytically from a forward-moving
sensor. No real KITTI-360 data is available in this environment.
"""

import json
import os

import numpy as np


def _pano_ray_directions_np(i, j, H, W, fov_up, fov):
    """Host-side numpy twin of ops.rays.pano_ray_directions (float64)."""
    beta = -(i - W / 2) / W * 2 * np.pi
    alpha = (fov_up - j / H * fov) / 180 * np.pi
    return np.stack(
        [np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta), np.sin(alpha)],
        axis=-1,
    )


def _ray_plane(o, d, z0):
    """Intersect rays with plane z = z0. Returns t (inf if none)."""
    dz = d[..., 2]
    t = (z0 - o[..., 2]) / np.where(np.abs(dz) < 1e-8, 1e-8, dz)
    return np.where((np.abs(dz) > 1e-8) & (t > 0), t, np.inf)


def _ray_aabb(o, d, lo, hi):
    """Slab-method ray/AABB intersection. Returns entry t (inf if miss)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit, t, np.inf)


def generate_synthetic_sequence(
    root,
    sequence_id="9000",
    num_frames=12,
    H=32,
    W=256,
    fov_lidar=(2.0, 26.9),
    speed=1.5,
    seed=0,
    val_every=5,
    max_depth=80.0,
):
    """Write a synthetic sequence under `root`; returns (scale, offset) config."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)

    fov_up, fov = fov_lidar
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    dirs = _pano_ray_directions_np(i, j, H, W, fov_up, fov)  # [H,W,3]

    # static boxes flanking the path
    boxes = []
    for k in range(8):
        x = 5.0 + 7.0 * k
        y = (-1) ** k * (4.0 + 2.0 * rng.uniform())
        w, l, h = 1.5 + rng.uniform(), 2.0 + rng.uniform(), 1.5 + rng.uniform()
        boxes.append((np.array([x - l / 2, y - w / 2, -1.8]),
                      np.array([x + l / 2, y + w / 2, -1.8 + h])))

    frame_start = int(sequence_id)
    frames_meta = []
    for f in range(num_frames):
        # sensor pose: forward along +x, slight yaw wobble
        tx = speed * f
        yaw = 0.02 * np.sin(f / 3.0)
        c, s = np.cos(yaw), np.sin(yaw)
        pose = np.eye(4)
        pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pose[:3, 3] = [tx, 0.3 * np.sin(f / 4.0), 0.0]

        world_dirs = dirs @ pose[:3, :3].T
        o = np.broadcast_to(pose[:3, 3], world_dirs.shape)

        # moving box crossing the street
        mb_x = 12.0 + speed * 0.7 * f
        mb_y = -3.0 + 0.5 * f
        mlo = np.array([mb_x - 1.0, mb_y - 0.8, -1.8])
        mhi = np.array([mb_x + 1.0, mb_y + 0.8, -0.2])

        t_best = _ray_plane(o, world_dirs, -1.8)
        albedo = np.full(t_best.shape, 0.3)
        for lo, hi in boxes:
            t_box = _ray_aabb(o, world_dirs, lo, hi)
            closer = t_box < t_best
            t_best = np.where(closer, t_box, t_best)
            albedo = np.where(closer, 0.6, albedo)
        t_mb = _ray_aabb(o, world_dirs, mlo, mhi)
        closer = t_mb < t_best
        t_best = np.where(closer, t_mb, t_best)
        albedo = np.where(closer, 0.9, albedo)

        depth = np.where(np.isfinite(t_best) & (t_best < max_depth), t_best, 0.0)
        # simple range-dependent intensity + raydrop for grazing ground hits
        intensity = albedo * np.exp(-depth / 60.0) * (depth > 0)
        drop = (depth > 0.95 * max_depth) | (
            (depth > 0) & (rng.uniform(size=depth.shape) < 0.02)
        )
        depth = np.where(drop, 0.0, depth)
        intensity = np.where(drop, 0.0, intensity)

        rv = np.zeros((H, W, 3), np.float32)
        rv[..., 1] = intensity
        rv[..., 2] = depth
        frame_id = frame_start + f
        np.save(os.path.join(root, "train", f"{frame_id:010d}.npy"), rv)
        frames_meta.append((frame_id, pose))

    # splits: every `val_every`-th frame is val/test (reference style)
    val_ids = [frame_start + f for f in range(num_frames) if f % val_every == val_every - 1]
    splits = {
        "train": [m for m in frames_meta if m[0] not in val_ids],
        "val": [m for m in frames_meta if m[0] in val_ids],
        "test": [m for m in frames_meta if m[0] in val_ids],
    }
    for split, metas in splits.items():
        json_dict = {
            "w_lidar": W,
            "h_lidar": H,
            "num_frames": num_frames,
            "num_frames_split": len(metas),
            "frames": [
                {
                    "frame_id": int(fid),
                    "lidar_file_path": f"train/{fid:010d}.npy",
                    "lidar2world": pose.tolist(),
                }
                for fid, pose in metas
            ],
        }
        with open(os.path.join(root, f"transforms_{sequence_id}_{split}.json"), "w") as fjs:
            json.dump(json_dict, fjs)

    # scale/offset a la cal_seq_config.py:28-67: fit world points in [-1,1]^3
    all_pts = []
    for fid, pose in frames_meta:
        rv = np.load(os.path.join(root, "train", f"{fid:010d}.npy"))
        d = rv[..., 2]
        pts = dirs * d[..., None]
        pts = pts[d > 0]
        pts_h = np.concatenate([pts, np.ones((len(pts), 1))], -1)
        all_pts.append((pts_h @ pose.T)[:, :3])
    pc = np.concatenate(all_pts)
    center = [(pc[:, k].max() + pc[:, k].min()) / 2 for k in range(3)]
    bound_ori = max(np.abs(pc - center).max(axis=0))
    scale = 1.0 / bound_ori
    return float(scale), [float(c) for c in center]
