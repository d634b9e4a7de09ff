"""KITTI-360 range-image dataset.

A numpy copy of `lidar4d_tpu/data/kitti360.py` (the port imports nothing of
the JAX package): the split is held as numpy arrays; the train step moves
a frame to the device.

Behavioral parity with the reference's `data/kitti360_dataset.py`:
  * same `transforms_{seq}_{split}.json` format + per-frame range-view npy
    files (66 x 1030 x 3: [unused, intensity, depth]);
  * channels become [raydrop = (depth != 0), intensity, depth * scale]
    (kitti360_dataset.py:114-123);
  * times normalized to [0, 1] over the sequence frame range
    (kitti360_dataset.py:125);
  * pose translations offset/scaled into the unit box
    (kitti360_dataset.py:131-135);
  * split='refine' loads the train split with full-image rays
    (kitti360_dataset.py:78-80).

Idiomatic departures: no DataLoader/collate — the whole split is stacked
into arrays (frames [F,H,W,3], poses [F,4,4], times [F]); per-step ray
sampling happens inside the train step. Iteration order comes
from an epoch permutation (matching the reference's shuffle=True).

Unknown sequence ids fall back to frame ranges derived from the JSON itself,
so synthetic sequences ride the same path.
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np

SEQUENCE_RANGES = {
    # static scenes (64 frames)
    "1538": (1538, 1601), "1728": (1728, 1791),
    "1908": (1908, 1971), "3353": (3353, 3416),
    # dynamic scenes (51 frames)
    "2350": (2350, 2400), "4950": (4950, 5000),
    "8120": (8120, 8170), "10200": (10200, 10250),
    "10750": (10750, 10800), "11400": (11400, 11450),
}

VAL_FRAMES = {
    "1538": [1551, 1564, 1577, 1590], "1728": [1741, 1754, 1767, 1780],
    "1908": [1921, 1934, 1947, 1960], "3353": [3366, 3379, 3392, 3405],
    "2350": [2360, 2370, 2380, 2390], "4950": [4960, 4970, 4980, 4990],
    "8120": [8130, 8140, 8150, 8160], "10200": [10210, 10220, 10230, 10240],
    "10750": [10760, 10770, 10780, 10790], "11400": [11410, 11420, 11430, 11440],
}


@dataclass
class KITTI360Dataset:
    split: str = "train"  # train / val / test / refine
    root_path: str = "data/kitti360"
    sequence_id: str = "4950"
    scale: float = 1.0
    offset: list = field(default_factory=lambda: [0.0, 0.0, 0.0])
    fov_lidar: list = field(default_factory=lambda: [2.0, 26.9])
    num_rays_lidar: int = 4096
    patch_size_lidar: int = 1

    def __post_init__(self):
        json_split = self.split
        self.training = self.split in ("train", "all", "trainval")
        if self.split == "refine":
            json_split = "train"
            self.num_rays_lidar = -1
        if not self.training:
            self.num_rays_lidar = -1

        path = os.path.join(
            self.root_path, f"transforms_{self.sequence_id}_{json_split}.json"
        )
        with open(path) as f:
            transform = json.load(f)

        self.H_lidar = int(transform["h_lidar"])
        self.W_lidar = int(transform["w_lidar"])

        frames = sorted(transform["frames"], key=lambda d: d["lidar_file_path"])
        frame_ids = [int(fr["frame_id"]) for fr in frames]
        if self.sequence_id in SEQUENCE_RANGES:
            frame_start, frame_end = SEQUENCE_RANGES[self.sequence_id]
        else:
            # synthetic / external sequences: derive from the JSON
            frame_start = min(frame_ids)
            frame_end = frame_start + int(transform["num_frames"]) - 1
        self.frame_start, self.frame_end = frame_start, frame_end

        poses, images, times = [], [], []
        for fr in frames:
            pose = np.array(fr["lidar2world"], dtype=np.float32)
            pc = np.load(os.path.join(self.root_path, fr["lidar_file_path"]))
            ray_drop = np.where(pc[..., 2] == 0.0, 0.0, 1.0)[..., None]
            image = np.concatenate(
                [ray_drop, pc[..., 1:2], pc[..., 2:3] * self.scale], axis=-1
            ).astype(np.float32)
            t = (fr["frame_id"] - frame_start) / (frame_end - frame_start)
            poses.append(pose)
            images.append(image)
            times.append(t)

        self.poses_lidar = np.stack(poses)
        self.poses_lidar[:, :3, -1] = (
            self.poses_lidar[:, :3, -1] - np.asarray(self.offset, np.float32)
        ) * self.scale
        self.images_lidar = np.stack(images)  # [F, H, W, 3]
        self.times = np.asarray(times, np.float32)
        self.frame_ids = np.asarray(frame_ids, np.int32)
        self.intrinsics_lidar = tuple(self.fov_lidar)

    def __len__(self):
        return len(self.poses_lidar)

    def num_frames_total(self):
        return self.frame_end - self.frame_start + 1

    def frame(self, i):
        """Per-frame dict consumed by the train step."""
        return {
            "pose": self.poses_lidar[i],
            "image": self.images_lidar[i],
            "time": self.times[i],
        }

    def epoch_order(self, rng: np.random.Generator):
        """Shuffled frame order per epoch (DataLoader shuffle=True parity)."""
        if self.training:
            return rng.permutation(len(self))
        return np.arange(len(self))
