"""Point-cloud cache for the flow-consistency loss.

Port of `lidar4d_tpu/train/flow_cache.py` (the reference's
`Trainer.process_pointcloud`): for every train frame, back-project the
ground-truth range image, split off the ground (`utils/pointcloud.point_removal`),
move both clouds to scaled world coordinates, and pad them with a far-away
sentinel into [F, P, 3] arrays with masks, so the flow loss runs on fixed
shapes. numpy on the host; the train step moves the arrays to the device.
"""

import numpy as np

from lidar4d_tpu_torch.ops.chamfer import _PAD_SENTINEL
from lidar4d_tpu_torch.ops.pano import pano_to_lidar
from lidar4d_tpu_torch.utils.pointcloud import point_removal


def _pad_stack(clouds, num_frames, frame_indices, align=1024):
    sizes = [len(c) for c in clouds] or [1]
    pmax = max(sizes)
    pmax = ((pmax + align - 1) // align) * align
    points = np.full((num_frames, pmax, 3), _PAD_SENTINEL, np.float32)
    mask = np.zeros((num_frames, pmax), np.float32)
    for fi, c in zip(frame_indices, clouds):
        n = len(c)
        points[fi, :n] = c
        mask[fi, :n] = 1.0
    return points, mask


def build_flow_cache(dataset, scale, num_frames_total, verbose=False, max_points=0, seed=0,
                     frames=None):
    """dataset: a refine-split KITTI360Dataset (full train frames).

    max_points > 0 subsamples each frame's non-ground cloud to at most that
    many points and its ground cloud to max_points // 4 (the flow chamfer is
    O(P^2) per neighbour pair). frames: the sequence frame indices to build
    (default all); the others are left out and marked valid = 0, so the
    flow loss skips them as it skips a missing neighbour.
    """
    rng = np.random.default_rng(seed)
    clouds, grounds, fidx = [], [], []
    for i in range(len(dataset)):
        t = float(dataset.times[i])
        fi = int(round(t * (num_frames_total - 1)))
        if frames is not None and fi not in frames:
            continue
        img = dataset.images_lidar[i]
        raydrop = img[..., 0]
        depth = img[..., 2] * raydrop  # scaled depth
        gt_lidar = pano_to_lidar(np.asarray(depth, np.float64) / scale,
                                 dataset.intrinsics_lidar)
        points, ground = point_removal(gt_lidar)
        if max_points and len(points) > max_points:
            points = points[rng.choice(len(points), max_points, replace=False)]
        if max_points and len(ground) > max_points // 4:
            ground = ground[rng.choice(len(ground), max_points // 4, replace=False)]

        pose = np.asarray(dataset.poses_lidar[i], np.float64)
        for arr, dest in ((points, clouds), (ground, grounds)):
            a = arr * scale
            a = np.hstack([a, np.ones((len(a), 1))])
            dest.append(((pose @ a.T).T[:, :3]).astype(np.float32))
        fidx.append(fi)
        if verbose and i % 10 == 0:
            print(f"flow cache {i + 1}/{len(dataset)}")

    points, mask = _pad_stack(clouds, num_frames_total, fidx)
    ground, gmask = _pad_stack(grounds, num_frames_total, fidx)
    valid = np.zeros((num_frames_total,), np.float32)
    valid[fidx] = 1.0
    return {"points": points, "mask": mask, "ground": ground, "gmask": gmask,
            "valid": valid}
