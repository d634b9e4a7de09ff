"""Simulation CLI: novel space-time LiDAR sweeps from a trained checkpoint.

Port of `lidar4d_tpu/cli/main_lidar4d_sim.py` (the reference's
`main_lidar4d_sim.py`): loads a checkpoint, builds full-frame rays for any
sensor (fov / H / W) along the sequence's trajectory, optionally shifted and
aligned to the motion, and renders point clouds, panels and a video with
`Simulator`; `--kitti2nus` is the reference's KITTI-360 -> nuScenes sensor
preset (main_lidar4d_sim.py:184-190). Everything renders on `--device`
(cuda unless told otherwise; asking for cuda without a card raises).

    python -m lidar4d_tpu_torch.cli.main_lidar4d_sim --config configs/kitti360_4950.txt \\
        --workspace workspace/torch_kitti360_4950 --shift_y 0.5 --align_axis

Flags are the JAX simulation parser's, less `--fp16` and `--preload` (the
train CLI dropped them too), plus `--device` and the two field flags
`--plane_hash_scales` / `--plane_hash_log2` at the train parser's defaults.
The JAX parser lacks those two and `--remat_density` / `--density_chunk`,
all four of which its `build_model_config` reads
(`lidar4d_tpu/cli/config.py:213-240`), so the JAX simulation CLI raises
AttributeError before it builds any field; its txt-config parser also drops
keys it does not define, so a field trained with `plane_hash_scales` could
not be rebuilt there. The port's `build_model_config` reads no remat or
chunk flag, so the two field flags are the whole repair.

`--ckpt` is `latest_model` (the newest epoch or refine checkpoint in
`<workspace>/checkpoints`), `latest`, `best`, `scratch` or a checkpoint file
the port wrote; a JAX orbax directory raises. With no checkpoint found the
seeded init renders, with a warning, as in the reference.
"""

import time
import warnings

import numpy as np

from lidar4d_tpu_torch.cli.config import ConfigArgumentParser, build_model_config
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
from lidar4d_tpu_torch.interop import tree_map
from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
from lidar4d_tpu_torch.ops import _cuda
from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays, shift_trajectory
from lidar4d_tpu_torch.train.checkpoints import CheckpointManager
from lidar4d_tpu_torch.utils.misc import set_seed


def get_sim_arg_parser():
    p = ConfigArgumentParser()
    p.add_argument("--config", type=str, default="configs/kitti360_4950.txt")
    p.add_argument("--workspace", type=str, default="simulation")
    p.add_argument("--ckpt", type=str, default="latest_model")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the field renders on (cuda unless told otherwise; "
                        "cpu runs the plain versions)")
    # dataset (keep the same as training)
    p.add_argument("--dataloader", type=str, default="kitti360")
    p.add_argument("--path", type=str, default="data/kitti360")
    p.add_argument("--sequence_id", type=str, default="4950")
    p.add_argument("--bound", type=float, default=1)
    p.add_argument("--scale", type=float, default=0.01)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--near_lidar", type=float, default=1.0)
    p.add_argument("--far_lidar", type=float, default=81.0)
    p.add_argument("--num_frames", type=int, default=51)
    p.add_argument("--active_sensor", action="store_true")
    p.add_argument("--density_scale", type=float, default=1)
    p.add_argument("--num_steps", type=int, default=768)
    # model (keep the same as training)
    p.add_argument("--min_resolution", type=int, default=32)
    p.add_argument("--base_resolution", type=int, default=512)
    p.add_argument("--max_resolution", type=int, default=32768)
    p.add_argument("--time_resolution", type=int, default=8)
    p.add_argument("--n_levels_plane", type=int, default=4)
    p.add_argument("--n_features_per_level_plane", type=int, default=8)
    p.add_argument("--plane_hash_scales", type=int, default=0)
    p.add_argument("--plane_hash_log2", type=int, default=11)
    p.add_argument("--n_levels_hash", type=int, default=8)
    p.add_argument("--n_features_per_level_hash", type=int, default=4)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--hash_size_dynamic", type=int, nargs=3, default=[15, 13, 13])
    p.add_argument("--flow_n_levels", type=int, default=8)
    p.add_argument("--flow_n_features", type=int, default=8)
    p.add_argument("--flow_log2_hashmap_size", type=int, default=18)
    p.add_argument("--flow_base_resolution", type=int, default=32)
    p.add_argument("--flow_max_resolution", type=int, default=8192)
    p.add_argument("--num_coarse", type=int, default=0)
    p.add_argument("--num_fine", type=int, default=0)
    p.add_argument("--num_layers_flow", type=int, default=3)
    p.add_argument("--hidden_dim_flow", type=int, default=64)
    p.add_argument("--num_layers_sigma", type=int, default=2)
    p.add_argument("--hidden_dim_sigma", type=int, default=64)
    p.add_argument("--geo_feat_dim", type=int, default=15)
    p.add_argument("--num_layers_lidar", type=int, default=3)
    p.add_argument("--hidden_dim_lidar", type=int, default=64)
    p.add_argument("--out_lidar_dim", type=int, default=2)
    p.add_argument("--use_refine", type=bool, default=True)
    # simulation
    p.add_argument("--fov_lidar", type=float, nargs="*", default=[2.0, 26.9])
    p.add_argument("--H_lidar", type=int, default=66)
    p.add_argument("--W_lidar", type=int, default=1030)
    p.add_argument("--shift_x", type=float, default=0.0)
    p.add_argument("--shift_y", type=float, default=0.0)
    p.add_argument("--shift_z", type=float, default=0.0)
    p.add_argument("--align_axis", action="store_true")
    p.add_argument("--kitti2nus", action="store_true")
    return p


def apply_kitti2nus_preset(opt):
    """KITTI-360 -> nuScenes sensor preset (main_lidar4d_sim.py:184-190):
    fov [10, 40], 32x1024 grid, far 70 m, sensor lifted 0.1 m, no U-Net
    refine (the refiner was trained on the 66x1030 KITTI grid)."""
    opt.fov_lidar = [10.0, 40.0]
    opt.H_lidar = 32
    opt.W_lidar = 1024
    opt.far_lidar = 70
    opt.shift_z += 0.1 * opt.scale
    opt.use_refine = False
    return opt


def _sequence_poses_times(opt):
    """Per-frame lidar2world + times for the sequence, from the preprocessed
    transforms JSONs of the train and val splits (the reference re-derives
    the same values from raw KITTI-360, main_lidar4d_sim.py:118-172)."""
    frames = {}
    for split in ("train", "val"):
        try:
            ds = KITTI360Dataset(
                split=split, root_path=opt.path, sequence_id=opt.sequence_id,
                scale=opt.scale, offset=opt.offset, fov_lidar=opt.fov_lidar,
            )
        except FileNotFoundError:
            continue
        for i in range(len(ds)):
            frames[int(ds.frame_ids[i])] = (np.asarray(ds.poses_lidar[i]), float(ds.times[i]))
    if not frames:
        raise FileNotFoundError("no transforms JSONs found for simulation")
    fids = sorted(frames)
    poses = np.stack([frames[f][0] for f in fids])
    times = np.asarray([frames[f][1] for f in fids], np.float32)
    return poses, times


def _load_params(opt, template, device):
    """The checkpoint's field parameters on `device`, or `template` (the
    seeded init) with a warning when there is none."""
    mgr = CheckpointManager(opt.workspace, name="lidar4d")
    path = mgr.resolve(opt.ckpt, include_refine=True)
    if path is None:
        warnings.warn("No checkpoint found, model randomly initialized.")
        return template
    print(f"[INFO] Loading {path} ...")
    tree = mgr.restore(path, device)
    # refine and best checkpoints hold the parameters, epoch checkpoints the
    # whole train state
    params = tree["params"] if "params" in tree else tree["state"]["params"]
    if tree_map(lambda t: tuple(t.shape), params) != tree_map(lambda t: tuple(t.shape), template):
        raise ValueError(f"checkpoint {path} params tree does not match the model config")
    return params


def main(argv=None):
    """Run the CLI on `argv` (sys.argv when None); returns the Simulator."""
    opt = get_sim_arg_parser().parse_args(argv)
    device = _cuda.resolve_device(opt.device)
    set_seed(opt.seed)

    if opt.kitti2nus:
        apply_kitti2nus_preset(opt)

    opt.near_lidar = opt.near_lidar * opt.scale
    opt.far_lidar = opt.far_lidar * opt.scale

    field = LiDAR4DField(build_model_config(opt), device=device)
    params = _load_params(opt, field.init(seed=0), device)

    sim = Simulator("lidar4d", opt, field, params, workspace=opt.workspace,
                    use_refine=opt.use_refine, H_lidar=opt.H_lidar, W_lidar=opt.W_lidar,
                    device=device)

    poses, times = _sequence_poses_times(opt)
    rays_o, rays_d = build_novel_rays(poses, opt.H_lidar, opt.W_lidar, opt.fov_lidar)
    rays_o = shift_trajectory(rays_o, opt.shift_x, opt.shift_y, opt.shift_z, opt.scale,
                              align_axis=opt.align_axis)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sim.render(rays_o, rays_d, times)
    seconds = time.perf_counter() - t0
    print(f"[INFO] rendered {len(times)} frames of {opt.H_lidar}x{opt.W_lidar} in "
          f"{seconds:.3f} s ({seconds / len(times):.4f} s/frame); kernel launches "
          f"{dict(_cuda.LAUNCHES)}")
    return sim


if __name__ == "__main__":
    main()
