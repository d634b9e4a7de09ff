"""txt config files, the CLI's flags, `build_model_config` and
`build_loss_config` (argparse + ast only).

Port of `lidar4d_tpu/cli/config.py`: the reference's `key = value` txt
config format supplies defaults, command-line flags override. Flag names,
defaults and meanings are the reference's; the port adds `--device`. It
leaves out the flags that would change nothing here: the TPU memory policies
(`--remat_density`, `--density_chunk`: the H100 holds even the reference
configuration's density calls whole, PERF.md), `--fp16` (the MLPs always run in
bfloat16) and `--preload`. `--num_devices`, `--mesh` and `--num_hosts` set
the ray-parallel layout (`train.trainer.mesh_from_options`), and
`ranks_to_start` how many local ranks the CLI starts for it.
"""

import argparse
import ast
import os


def _parse_config_txt(path):
    """Parse the reference's config txt format (configargparse subset)."""
    values = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            values[key.strip()] = val.strip()
    return values


def _coerce(action, raw):
    """Coerce a raw config-file string to the argparse action's type."""
    if isinstance(action.const, bool) or isinstance(action.default, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
    if raw.startswith("["):
        vals = ast.literal_eval(raw)
        if action.type:
            vals = [action.type(v) for v in vals]
        return vals
    if action.nargs in ("*", "+"):
        vals = raw.split()
        if action.type:
            vals = [action.type(v) for v in vals]
        return vals
    if action.type:
        return action.type(raw)
    return raw


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse + `--config file.txt` defaults, reference-compatible."""

    def parse_args(self, args=None, namespace=None):  # noqa: D102
        ns, _ = super().parse_known_args(args)
        config_path = getattr(ns, "config", None)
        if config_path and os.path.exists(config_path):
            file_values = _parse_config_txt(config_path)
            defaults = {}
            for action in self._actions:
                if action.dest in file_values:
                    defaults[action.dest] = _coerce(action, file_values[action.dest])
            self.set_defaults(**defaults)
        return super().parse_args(args, namespace)


def get_arg_parser(default_config="configs/kitti360_4950.txt"):
    """The training CLI's flags (reference `get_arg_parser`, flag for flag),
    the simulator's sensor size, and `--device`."""
    p = ConfigArgumentParser()
    p.add_argument("--config", type=str, default=default_config)
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--refine", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_eval", action="store_true")
    # stop after the training loop: no refine, evaluate or test
    p.add_argument("--train_only", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the field, the steps and the meters run on "
                        "(cuda unless told otherwise; cpu runs the plain versions)")

    # dataset
    p.add_argument("--dataloader", type=str,
                   choices=("kitti360", "nuscenes", "synthetic"), default="kitti360")
    p.add_argument("--path", type=str, default="data/kitti360")
    p.add_argument("--sequence_id", type=str, default="4950")
    p.add_argument("--bound", type=float, default=1)
    p.add_argument("--scale", type=float, default=0.01)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--near_lidar", type=float, default=1.0)
    p.add_argument("--far_lidar", type=float, default=81.0)
    p.add_argument("--fov_lidar", type=float, nargs="*", default=[2.0, 26.9])
    p.add_argument("--num_frames", type=int, default=51)

    # field
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
    p.add_argument("--num_layers_flow", type=int, default=3)
    p.add_argument("--hidden_dim_flow", type=int, default=64)
    p.add_argument("--num_layers_sigma", type=int, default=2)
    p.add_argument("--hidden_dim_sigma", type=int, default=64)
    p.add_argument("--geo_feat_dim", type=int, default=15)
    p.add_argument("--num_layers_lidar", type=int, default=3)
    p.add_argument("--hidden_dim_lidar", type=int, default=64)
    p.add_argument("--out_lidar_dim", type=int, default=2)

    # training and loss
    p.add_argument("--depth_loss", type=str, default="l1")
    p.add_argument("--depth_grad_loss", type=str, default="l1")
    p.add_argument("--intensity_loss", type=str, default="mse")
    p.add_argument("--raydrop_loss", type=str, default="mse")
    p.add_argument("--flow_loss", type=bool, default=True)
    p.add_argument("--grad_loss", type=bool, default=True)
    p.add_argument("--alpha_d", type=float, default=1)
    p.add_argument("--alpha_i", type=float, default=0.1)
    p.add_argument("--alpha_r", type=float, default=0.01)
    p.add_argument("--alpha_grad", type=float, default=0.1)
    p.add_argument("--alpha_grad_norm", type=float, default=0.1)
    p.add_argument("--alpha_spatial", type=float, default=0.1)
    p.add_argument("--alpha_tv", type=float, default=0.1)
    p.add_argument("--grad_norm_smooth", action="store_true")
    p.add_argument("--spatial_smooth", action="store_true")
    p.add_argument("--tv_loss", action="store_true")
    p.add_argument("--sobel_grad", action="store_true")
    p.add_argument("--urf_loss", action="store_true")
    p.add_argument("--active_sensor", action="store_true")
    p.add_argument("--density_scale", type=float, default=1)
    p.add_argument("--intensity_scale", type=float, default=1)
    p.add_argument("--raydrop_ratio", type=float, default=0.5)
    p.add_argument("--smooth_factor", type=float, default=0.2)
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--eval_interval", type=int, default=100)
    # the full-state epoch checkpoint every N epochs (always at the last one)
    p.add_argument("--ckpt_interval", type=int, default=1)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays_lidar", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=768)
    p.add_argument("--patch_size_lidar", type=int, default=1)
    p.add_argument("--change_patch_size_lidar", nargs="+", type=int, default=[2, 8])
    p.add_argument("--change_patch_size_epoch", type=int, default=2)
    p.add_argument("--ema_decay", type=float, default=0.95)

    # sampling, memory and run extras of the reference (not in the original CLI)
    p.add_argument("--num_coarse", type=int, default=0,
                   help="hierarchical sampling: uniform coarse samples a ray "
                        "(0 = num_steps uniform samples)")
    p.add_argument("--num_fine", type=int, default=0,
                   help="hierarchical sampling: importance samples a ray")
    p.add_argument("--flow_cloud_max_points", type=int, default=0,
                   help="subsample the flow loss's point clouds to this many points "
                        "a frame (0 = whole clouds)")
    p.add_argument("--hier_warmup_iters", type=int, default=500,
                   help="train with the uniform sampler (num_coarse + num_fine "
                        "samples) for this many steps before hierarchical sampling")
    p.add_argument("--num_devices", type=int, default=0,
                   help="shard ray batches over this many devices, one rank each (0 = "
                        "every rank of the process group, one without a group)")
    p.add_argument("--mesh", type=str, default="dp", choices=["dp", "dcn,ici"],
                   help="device layout: 'dp' = 1-D ray data parallelism; 'dcn,ici' = "
                        "hosts x each host's devices, gradients summed within each host "
                        "before across hosts")
    p.add_argument("--num_hosts", type=int, default=0,
                   help="rows of the dcn,ici mesh (0 = the hosts the ranks run on)")
    p.add_argument("--max_epochs", type=int, default=0,
                   help="stop after this many epochs, keeping the --iters lr "
                        "schedule (0 = the whole schedule)")
    p.add_argument("--profile", action="store_true",
                   help="trace epoch 2's steps with torch.profiler")
    # synthetic data (dataloader = synthetic)
    p.add_argument("--synthetic_H", type=int, default=66)
    p.add_argument("--synthetic_W", type=int, default=1030)
    p.add_argument("--synthetic_seed", type=int, default=0)
    # flow net
    p.add_argument("--flow_n_levels", type=int, default=8)
    p.add_argument("--flow_n_features", type=int, default=8)
    p.add_argument("--flow_log2_hashmap_size", type=int, default=18)
    p.add_argument("--flow_base_resolution", type=int, default=32)
    p.add_argument("--flow_max_resolution", type=int, default=8192)
    # the simulator's sensor
    p.add_argument("--H_lidar", type=int, default=66)
    p.add_argument("--W_lidar", type=int, default=1030)
    return p


def ranks_to_start(opt):
    """Local ranks the CLI starts when no process group exists: 1 for
    --num_devices 0 or 1 (one device), else N, one a device: on CUDA (NCCL)
    one card each, so N may not exceed this host's cards; on the CPU N
    processes."""
    import torch

    n = max(getattr(opt, "num_devices", 0) or 0, 1)
    device = torch.device(opt.device)
    if n > 1 and device.type == "cuda":
        if device.index is not None:
            raise ValueError(f"--num_devices {n} --device {opt.device}: each rank takes its own "
                             "card; give --device cuda")
        if n > torch.cuda.device_count():
            raise ValueError(f"--num_devices {n} on cuda: NCCL takes one card a rank, and this "
                             f"host has {torch.cuda.device_count()}")
    return n


def build_model_config(opt):
    """Map parsed options to LiDAR4DConfig (reference build_model_config)."""
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DConfig

    return LiDAR4DConfig(
        min_resolution=opt.min_resolution,
        base_resolution=opt.base_resolution,
        max_resolution=opt.max_resolution,
        time_resolution=opt.time_resolution,
        n_levels_plane=opt.n_levels_plane,
        n_features_per_level_plane=opt.n_features_per_level_plane,
        plane_hash_scales=opt.plane_hash_scales,
        plane_hash_log2=opt.plane_hash_log2,
        n_levels_hash=opt.n_levels_hash,
        n_features_per_level_hash=opt.n_features_per_level_hash,
        log2_hashmap_size=opt.log2_hashmap_size,
        hash_size_dynamic=tuple(opt.hash_size_dynamic),
        num_layers_flow=opt.num_layers_flow,
        hidden_dim_flow=opt.hidden_dim_flow,
        num_layers_sigma=opt.num_layers_sigma,
        hidden_dim_sigma=opt.hidden_dim_sigma,
        geo_feat_dim=opt.geo_feat_dim,
        num_layers_lidar=opt.num_layers_lidar,
        hidden_dim_lidar=opt.hidden_dim_lidar,
        out_lidar_dim=opt.out_lidar_dim,
        num_frames=opt.num_frames,
        bound=opt.bound,
        near_lidar=opt.near_lidar,  # callers pre-scale by opt.scale
        far_lidar=opt.far_lidar,
        density_scale=opt.density_scale,
        active_sensor=opt.active_sensor,
        flow_n_levels=opt.flow_n_levels,
        flow_n_features=opt.flow_n_features,
        flow_log2_hashmap_size=opt.flow_log2_hashmap_size,
        flow_base_resolution=opt.flow_base_resolution,
        flow_max_resolution=opt.flow_max_resolution,
    )


def build_loss_config(opt):
    """Map parsed options to the train step's LossConfig."""
    from lidar4d_tpu_torch.train.losses import LossConfig

    return LossConfig(
        depth_loss=opt.depth_loss,
        depth_grad_loss=opt.depth_grad_loss,
        intensity_loss=opt.intensity_loss,
        raydrop_loss=opt.raydrop_loss,
        flow_loss=opt.flow_loss,
        grad_loss=opt.grad_loss,
        urf_loss=opt.urf_loss,
        alpha_d=opt.alpha_d,
        alpha_i=opt.alpha_i,
        alpha_r=opt.alpha_r,
        alpha_grad=opt.alpha_grad,
        alpha_grad_norm=opt.alpha_grad_norm,
        alpha_spatial=opt.alpha_spatial,
        alpha_tv=opt.alpha_tv,
        grad_norm_smooth=opt.grad_norm_smooth,
        spatial_smooth=opt.spatial_smooth,
        tv_loss=opt.tv_loss,
        sobel_grad=opt.sobel_grad,
        smooth_factor=opt.smooth_factor,
        scale=opt.scale,
        num_frames=opt.num_frames,
        iters=opt.iters,
    )
