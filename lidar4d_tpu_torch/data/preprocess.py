"""KITTI-360 preprocessing: raw scans -> range views -> NeRF transforms -> config.

A numpy copy of `lidar4d_tpu/data/preprocess.py` (the port imports nothing
of the JAX package), the equivalent of the reference's `data/preprocess/`
package (`generate_rangeview.py`, `kitti360_loader.py`,
`kitti360_to_nerf.py`, `cal_seq_config.py`) driven by one CLI
(`lidar4d_tpu_torch.cli.preprocess`). Host only; it writes the same files
as the JAX package, quirks included (the drive `2013_05_28_drive_0000` is
fixed, as upstream), with one repair: the config's `offset` is written as
plain numbers. The JAX `cal_seq_config` writes the repr of a list of numpy
scalars, which under numpy 2 reads `[np.float64(...), ...]` and makes the
config unreadable by either package's config parser.

The reference's per-point Python projection loop becomes the vectorized
scatter in `ops.pano`; the KITTI-360 pose chain (IMU->world poses.txt,
calib_cam_to_pose, calib_cam_to_velo -> velo->world with forward-fill for
missing frames, kitti360_loader.py:63-127) is reproduced without the
camtools dependency.
"""

import json
import os
from pathlib import Path

import numpy as np

from lidar4d_tpu_torch.data.kitti360 import SEQUENCE_RANGES, VAL_FRAMES
from lidar4d_tpu_torch.ops.pano import lidar_to_pano_with_intensities, pano_to_lidar


def _pad_0001(mat):
    """Pad a 3x4 matrix to homogeneous 4x4 (camtools.convert.pad_0001)."""
    out = np.eye(4)
    out[:3, :4] = mat[:3, :4]
    return out


class KITTI360Loader:
    """Velodyne->world pose chain for KITTI-360 (kitti360_loader.py:6-127)."""

    def __init__(self, kitti_360_root):
        self.root = Path(kitti_360_root)
        self.calibration_dir = self.root / "calibration"
        self.data_poses_dir = self.root / "data_poses"
        self.data_3d_raw_dir = self.root / "data_3d_raw"
        for d in (self.calibration_dir, self.data_poses_dir, self.data_3d_raw_dir):
            if not d.is_dir():
                raise FileNotFoundError(f"{d} not found.")

    @staticmethod
    def _read_variable(path, name, M, N):
        with open(path) as fid:
            for line in fid:
                if line.startswith(name):
                    vals = [float(x) for x in line.replace(f"{name}:", "").split()]
                    assert len(vals) == M * N
                    return np.array(vals).reshape(M, N)
        return None

    def _load_all_lidars(self, sequence_name):
        poses_path = self.data_poses_dir / f"{sequence_name}_sync" / "poses.txt"
        imu_to_world = {}
        frame_ids = []
        for line in np.loadtxt(poses_path):
            fid = int(line[0])
            frame_ids.append(fid)
            imu_to_world[fid] = line[1:].reshape(3, 4)

        cam00_to_imu = _pad_0001(
            self._read_variable(
                self.calibration_dir / "calib_cam_to_pose.txt", "image_00", 3, 4
            )
        )
        with open(self.calibration_dir / "calib_cam_to_velo.txt") as f:
            vals = [float(x) for x in f.readline().split()]
        cam00_to_velo = _pad_0001(np.array(vals).reshape(3, 4))

        velo_to_world = {}
        for fid in frame_ids:
            cam00_to_world = imu_to_world[fid] @ cam00_to_imu
            velo_to_world[fid] = _pad_0001(cam00_to_world @ np.linalg.inv(cam00_to_velo))
        return velo_to_world

    def load_lidars(self, sequence_name, frame_ids):
        d = self._load_all_lidars(sequence_name)
        out, last = [], None
        for fid in frame_ids:
            if fid in d:
                last = d[fid]
            out.append(last)  # forward-fill missing frames (loader.py:119-125)
        return np.stack(out)


def generate_rangeview(root_path, sequence_id, H=66, W=1030,
                       intrinsics=(2.0, 26.9), max_depth=80.0):
    """Raw .bin scans -> [H, W, 3] range-view npys (generate_rangeview.py)."""
    root = Path(root_path)
    kitti_root = root / "KITTI-360"
    out_dir = root / "train"
    out_dir.mkdir(parents=True, exist_ok=True)
    seq = "2013_05_28_drive_0000"
    s, e = SEQUENCE_RANGES[sequence_id]
    lidar_dir = kitti_root / "data_3d_raw" / f"{seq}_sync" / "velodyne_points" / "data"
    for fid in range(s, e + 1):
        pts = np.fromfile(lidar_dir / f"{fid:010d}.bin", dtype=np.float32)
        pts = pts.reshape(-1, 4)
        pano, intensities = lidar_to_pano_with_intensities(
            pts, H, W, intrinsics, max_depth
        )
        rv = np.zeros((H, W, 3), np.float32)
        rv[..., 1] = intensities
        rv[..., 2] = pano
        np.save(out_dir / f"{fid:010d}.npy", rv)


def kitti360_to_nerf(root_path, sequence_id):
    """Range views + poses -> transforms_{seq}_{split}.json (kitti360_to_nerf.py)."""
    root = Path(root_path)
    s, e = SEQUENCE_RANGES[sequence_id]
    val_ids = VAL_FRAMES[sequence_id]
    frame_ids = list(range(s, e + 1))

    k3 = KITTI360Loader(root / "KITTI-360")
    lidar2world = k3.load_lidars("2013_05_28_drive_0000", frame_ids)

    rv0 = np.load(root / "train" / f"{frame_ids[0]:010d}.npy")
    h, w = rv0.shape[:2]

    splits = {
        "train": [f for f in frame_ids if f not in val_ids],
        "val": list(val_ids),
        "test": list(val_ids),
    }
    for split, ids in splits.items():
        json_dict = {
            "w_lidar": w,
            "h_lidar": h,
            "num_frames": len(frame_ids),
            "num_frames_split": len(ids),
            "frames": [
                {
                    "frame_id": fid,
                    "lidar_file_path": f"train/{fid:010d}.npy",
                    "lidar2world": lidar2world[frame_ids.index(fid)].tolist(),
                }
                for fid in ids
            ],
        }
        path = root / f"transforms_{sequence_id}_{split}.json"
        with open(path, "w") as f:
            json.dump(json_dict, f, indent=2)
        print(f"Saved {path}.")


def cal_seq_config(root_path, sequence_id, dataset="kitti360",
                   fov_lidar=(2.0, 26.9), bound=1.0, configs_dir="configs"):
    """Compute center/scale fitting all world points in [-1,1]^3 and write the
    per-sequence config txt (cal_seq_config.py:28-111)."""
    root = Path(root_path)
    with open(root / f"transforms_{sequence_id}_train.json") as f:
        transform = json.load(f)
    num_frames = transform["num_frames"]

    pts_world = []
    near, far = 200.0, 0.0
    for fr in transform["frames"]:
        pano = np.load(root / fr["lidar_file_path"])
        pc = pano_to_lidar(pano[:, :, 2], fov_lidar)
        dis = np.linalg.norm(pc, axis=1)
        if len(dis):
            near = min(near, dis.min())
            far = max(far, dis.max())
        pc_h = np.concatenate([pc, np.ones((len(pc), 1))], -1)
        pose = np.array(fr["lidar2world"])
        pts_world.append((pc_h @ pose.T)[:, :3])
    pc_all = np.concatenate(pts_world)
    print("near, far:", near, far)

    # Python floats: numpy 2 prints a list of its scalars as
    # [np.float64(...), ...], which no config parser reads back
    center = [
        float((pc_all[:, k].max() + pc_all[:, k].min()) / 2.0) for k in range(3)
    ]
    print("centerpose: ", center)
    bound_ori = (np.abs(pc_all - center)).max(axis=0).max()
    scale = bound / bound_ori
    print("scale: ", scale)

    os.makedirs(configs_dir, exist_ok=True)
    config_path = os.path.join(configs_dir, f"{dataset}_{sequence_id}.txt")
    with open(config_path, "w") as f:
        f.write(f"dataloader = {dataset}\n")
        f.write(f"path = {root_path}\n")
        f.write(f"sequence_id = {sequence_id}\n")
        f.write(f"num_frames = {num_frames}\n")
        f.write(f"fov_lidar = {list(fov_lidar)}\n")
        f.write(f"scale = {scale}\n")
        f.write(f"offset = {center}\n")
    return scale, center
