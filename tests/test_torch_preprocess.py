"""The port's KITTI-360 preprocessing (`lidar4d_tpu_torch.data.preprocess`,
`lidar4d_tpu_torch.cli.preprocess`) against the JAX package's on the CPU.

A miniature raw KITTI-360 tree (tests/test_preprocess.py's layout: poses.txt
with two missing frames, the two calibration files, velodyne .bin scans) is
written twice, since generate_rangeview writes into the raw root; each
package preprocesses its own copy. The host code is numpy in both, so every
written file must be equal: the range-view npys bit for bit, the transforms
JSONs and the config text byte for byte, except the config's `offset`: the
JAX `cal_seq_config` writes the repr of a list of numpy scalars, which under
numpy 2 reads `[np.float64(...), ...]` and which no config parser reads back
(a test shows it); the port writes the same numbers plain.
"""

import os
import re

import numpy as np
import pytest

import lidar4d_tpu.cli.preprocess as jcli
import lidar4d_tpu.cli.config as jconfig
import lidar4d_tpu.data.preprocess as jpre
import lidar4d_tpu_torch.cli.config as tconfig
import lidar4d_tpu_torch.cli.preprocess as tcli
import lidar4d_tpu_torch.data.preprocess as tpre
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset

SEQ = "1538"                     # static sequence: frames 1538..1601, 4 val frames
DRIVE = "2013_05_28_drive_0000"
CONFIG = f"configs/kitti360_{SEQ}.txt"


def _plain(text):
    """Config text with numpy 2's scalar reprs unwrapped: np.float64(x) -> x."""
    return re.sub(r"np\.float64\(([^()]*)\)", r"\1", text)


def _write_raw_tree(root, points=3000, seed=0):
    """A fake raw KITTI-360 tree under root/KITTI-360 (no download)."""
    k3 = root / "KITTI-360"
    seq = f"{DRIVE}_sync"
    (k3 / "calibration").mkdir(parents=True)
    (k3 / "data_poses" / seq).mkdir(parents=True)
    lidar_dir = k3 / "data_3d_raw" / seq / "velodyne_points" / "data"
    lidar_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    cam_to_pose = np.hstack([np.eye(3), np.array([[0.8], [0.3], [-0.1]])])
    with open(k3 / "calibration" / "calib_cam_to_pose.txt", "w") as f:
        for cam in ("image_00", "image_01"):
            f.write(f"{cam}: " + " ".join(str(v) for v in cam_to_pose.reshape(-1)) + "\n")
    cam_to_velo = np.hstack([np.eye(3), np.array([[0.3], [0.0], [0.2]])])
    with open(k3 / "calibration" / "calib_cam_to_velo.txt", "w") as f:
        f.write(" ".join(str(v) for v in cam_to_velo.reshape(-1)) + "\n")
    start, end = 1538, 1601
    lines = []
    for fid in range(start, end + 1):
        if fid in (1550, 1551):                      # missing: forward-filled
            continue
        yaw = 0.01 * (fid - start)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                        [0, 0, 1]])
        pose = np.hstack([rot, np.array([[0.5 * (fid - start)], [0.1], [0.0]])])
        lines.append(np.concatenate([[fid], pose.reshape(-1)]))
    np.savetxt(k3 / "data_poses" / seq / "poses.txt", np.stack(lines))
    for fid in range(start, end + 1):
        az = rng.uniform(-np.pi, np.pi, points)
        el = rng.uniform(np.radians(-24.9), np.radians(2.0), points)
        r = rng.uniform(3, 90, points)               # some beyond the 80 m cut
        pts = np.zeros((points, 4), np.float32)
        pts[:, 0] = r * np.cos(el) * np.cos(az)
        pts[:, 1] = r * np.cos(el) * np.sin(az)
        pts[:, 2] = r * np.sin(el)
        pts[:, 3] = rng.uniform(0, 1, points)
        pts.tofile(lidar_dir / f"{fid:010d}.bin")


@pytest.fixture
def two_trees(tmp_path):
    """Two identical raw trees, each under `raw` in a directory of its own."""
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        _write_raw_tree(d / "raw")
    return dirs


def _written(root):
    """Every file preprocessing wrote under `root`: relative path -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        if "KITTI-360" in dirpath:
            continue
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_loader_pose_chain_matches_jax(two_trees):
    frame_ids = list(range(1538, 1602))
    got = tpre.KITTI360Loader(two_trees[0] / "raw" / "KITTI-360").load_lidars(DRIVE, frame_ids)
    want = jpre.KITTI360Loader(two_trees[1] / "raw" / "KITTI-360").load_lidars(DRIVE, frame_ids)
    assert got.shape == (64, 4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1550 - 1538], got[1549 - 1538])
    np.testing.assert_array_equal(got[1551 - 1538], got[1549 - 1538])
    with pytest.raises(FileNotFoundError):
        tpre.KITTI360Loader(two_trees[0] / "raw")


def test_preprocess_steps_match_jax(two_trees):
    """The three steps at the JAX test's 22x103 grid."""
    outs = []
    for d, pre in zip(two_trees, (tpre, jpre)):
        root = str(d / "raw")
        pre.generate_rangeview(root, SEQ, H=22, W=103)
        pre.kitti360_to_nerf(root, SEQ)
        outs.append(pre.cal_seq_config(root, SEQ, configs_dir=str(d / "configs")))
    assert outs[0] == outs[1]
    got, want = _written(two_trees[0] / "raw"), _written(two_trees[1] / "raw")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("train")]) == 64
    assert got == want
    cfg = [(d / CONFIG).read_text() for d in two_trees]
    assert cfg[0] == _plain(cfg[1]).replace(str(two_trees[1]), str(two_trees[0]))


def test_preprocess_cli_kitti360_matches_jax(two_trees, monkeypatch):
    """`cli.preprocess --dataset kitti360` (66x1030 range views), the same
    relative paths in both directories; then the port's dataset reads it."""
    for d, cli in zip(two_trees, (tcli, jcli)):
        monkeypatch.chdir(d)
        cli.main(["--dataset", "kitti360", "--sequence_id", SEQ, "--path", "raw",
                  "--configs_dir", "configs"])
    got, want = _written(two_trees[0]), _written(two_trees[1])
    assert CONFIG in got and "raw/train/0000001601.npy" in got
    assert got.pop(CONFIG).decode() == _plain(want.pop(CONFIG).decode())
    assert got == want

    # the port's config is read back by the port's CLIs, with the JAX values
    monkeypatch.chdir(two_trees[1])
    jscale, jcenter = jpre.cal_seq_config("raw", SEQ, configs_dir="configs")
    monkeypatch.chdir(two_trees[0])
    opt = tconfig.get_arg_parser().parse_args(["--config", CONFIG])
    assert (opt.scale, opt.offset, opt.path, opt.sequence_id) == (jscale, jcenter, "raw", SEQ)
    ds = KITTI360Dataset(split="train", root_path=opt.path, sequence_id=SEQ, scale=opt.scale,
                         offset=opt.offset)
    assert len(ds) == 60 and (ds.H_lidar, ds.W_lidar) == (66, 1030)
    assert np.isfinite(ds.images_lidar).all()
    assert np.abs(ds.poses_lidar[:, :3, 3]).max() <= 1.0 + 1e-6


def test_jax_config_offset_unreadable(two_trees, monkeypatch):
    """The JAX package's fault: under numpy 2 its config's offset line is
    `[np.float64(...), ...]`, which its own config parser cannot read."""
    monkeypatch.chdir(two_trees[1])
    jpre.generate_rangeview("raw", SEQ, H=8, W=32)
    jpre.kitti360_to_nerf("raw", SEQ)
    jpre.cal_seq_config("raw", SEQ, configs_dir="configs")
    text = open(CONFIG).read()
    if not np.__version__.startswith("1."):
        assert "offset = [np.float64(" in text
        with pytest.raises((ValueError, SyntaxError)):
            jconfig.get_arg_parser().parse_args(["--config", CONFIG])


def test_preprocess_cli_synthetic_matches_jax(tmp_path, monkeypatch):
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d, cli in zip(dirs, (tcli, jcli)):
        d.mkdir()
        monkeypatch.chdir(d)
        cli.main(["--dataset", "synthetic", "--sequence_id", "9100", "--path", "data/syn",
                  "--num_frames", "6", "--H", "8", "--W", "32", "--seed", "3"])
    got, want = _written(dirs[0]), _written(dirs[1])
    assert "configs/synthetic_9100.txt" in got
    assert got == want
