"""Training / evaluation / refinement CLI.

Port of `lidar4d_tpu/cli/main_lidar4d.py` (the reference's
`main_lidar4d.py`): the same flags and txt config files, the same workspace
layout (args dump, checkpoints, logs, metrics, validation panels, test
outputs), and the same dispatch: train (then refine, evaluate and test),
`--train_only`, `--test`, `--test_eval` and `--refine`. Everything runs on
`--device` (cuda unless told otherwise; asking for cuda without a card
raises).

    python -m lidar4d_tpu_torch.cli.main_lidar4d --config configs/kitti360_4950.txt \\
        --workspace workspace/torch_kitti360_4950
    python -m lidar4d_tpu_torch.cli.main_lidar4d --config configs/synthetic_smoke.txt \\
        --workspace workspace/torch_smoke --device cpu

A workspace that holds the JAX package's checkpoints (orbax directories
under the same names) is refused before anything is written there.

Ray parallelism: with LIDAR4D_COORDINATOR / LIDAR4D_NUM_PROCS /
LIDAR4D_PROC_ID set, this process is one rank of that process group (one
process a device, each started by the user, all with the same flags; on a
host with several cards rank r takes card r modulo their count). Without
them, `--num_devices N` (N > 1) starts N local ranks itself: this process
is rank 0 and N - 1 spawned processes are the others, one a card (NCCL)
or, under `--device cpu`, N processes on the CPU (gloo); `main` returns
rank 0's Trainer. A rank that fails ends the run.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from lidar4d_tpu_torch.cli.config import (
    build_loss_config,
    build_model_config,
    get_arg_parser,
    ranks_to_start,
)
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
from lidar4d_tpu_torch.eval.meters import DepthMeter, IntensityMeter, PointsMeter, RaydropMeter
from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
from lidar4d_tpu_torch.ops._cuda import resolve_device
from lidar4d_tpu_torch.parallel.launch import join_ranks, kill_ranks, start_ranks
from lidar4d_tpu_torch.parallel.mesh import default_backend, init_distributed, rank_device
from lidar4d_tpu_torch.train.checkpoints import check_workspace
from lidar4d_tpu_torch.train.trainer import Trainer
from lidar4d_tpu_torch.utils.misc import set_seed

RANK_EXIT_S = 120      # for the other ranks to end once rank 0 has


def main(argv=None):
    """Run the CLI on `argv` (sys.argv when None); returns the Trainer (rank
    0's where it starts ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = get_arg_parser().parse_args(argv)
    resolve_device(opt.device)
    if init_distributed(device=opt.device):
        return _run(opt)
    n = ranks_to_start(opt)
    return _run(opt) if n == 1 else _run_local_ranks(argv, opt, n)


def _rank_main(rank, argv):
    _run(get_arg_parser().parse_args(argv))


def _run_local_ranks(argv, opt, n):
    """Rank 0 here, ranks 1 .. n - 1 spawned; returns rank 0's Trainer."""
    backend = default_backend(opt.device)
    threads = max(1, torch.get_num_threads() // n) if backend == "gloo" else 0
    tmp = tempfile.mkdtemp(prefix="lidar4d_ranks_")
    init = f"file://{tmp}/rendezvous"
    procs = start_ranks(_rank_main, (argv,), n, init, backend, first=1, threads=threads)
    try:
        dist.init_process_group(backend, init_method=init, world_size=n, rank=0)
        try:
            trainer = _run(opt)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        join_ranks(procs, RANK_EXIT_S)
    finally:
        kill_ranks(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    return trainer


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _run(opt):
    """The CLI's work on this process's rank (the only one without a
    process group)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = rank_device(opt.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_seed(opt.seed)
    check_workspace(opt.workspace)

    # args dump (main_lidar4d.py:140-145)
    if rank == 0:
        os.makedirs(opt.workspace, exist_ok=True)
        with open(os.path.join(opt.workspace, "args.txt"), "w") as f:
            for arg in vars(opt):
                f.write(f"{arg} = {getattr(opt, arg)}\n")

    # near / far scaled into the unit box (main_lidar4d.py:152-153)
    opt.near_lidar = opt.near_lidar * opt.scale
    opt.far_lidar = opt.far_lidar * opt.scale

    # the reference's nuScenes branch is commented out (main_lidar4d.py:127-134)
    if opt.dataloader == "nuscenes":
        raise SystemExit("--dataloader nuscenes is not implemented (the reference ships "
                         "KITTI-360 only). Use kitti360 or synthetic.")

    # synthetic sequences are written on demand (deterministic given the seed,
    # so the config's scale and offset stay valid)
    if opt.dataloader == "synthetic":
        tf = os.path.join(opt.path, f"transforms_{opt.sequence_id}_train.json")
        if rank == 0 and not os.path.exists(tf):
            from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence

            scale, _ = generate_synthetic_sequence(
                opt.path, sequence_id=opt.sequence_id, num_frames=opt.num_frames,
                H=opt.synthetic_H, W=opt.synthetic_W, fov_lidar=tuple(opt.fov_lidar),
                seed=opt.synthetic_seed)
            if abs(scale - opt.scale) > 1e-6 * max(abs(scale), 1e-9):
                print(f"[WARN] generated scale {scale} != config scale {opt.scale}; "
                      "config values win")
        _barrier()

    field = LiDAR4DField(build_model_config(opt), device=device)
    loss_cfg = build_loss_config(opt)

    def make_ds(split):
        return KITTI360Dataset(split=split, root_path=opt.path, sequence_id=opt.sequence_id,
                               scale=opt.scale, offset=opt.offset, fov_lidar=opt.fov_lidar,
                               num_rays_lidar=opt.num_rays_lidar,
                               patch_size_lidar=opt.patch_size_lidar)

    lidar_metrics = [
        RaydropMeter(ratio=opt.raydrop_ratio),
        IntensityMeter(scale=opt.intensity_scale, device=device),
        DepthMeter(scale=opt.scale, device=device),
        PointsMeter(scale=opt.scale, intrinsics=opt.fov_lidar, device=device),
    ]
    trainer = Trainer("lidar4d", opt, field, loss_cfg, workspace=opt.workspace,
                      lidar_metrics=lidar_metrics, use_checkpoint=opt.ckpt,
                      ema_decay=opt.ema_decay, eval_interval=opt.eval_interval, seed=opt.seed)

    if opt.test or opt.test_eval or opt.refine:
        if opt.refine:
            trainer.refine(make_ds("refine"))
        test_ds = make_ds("test")
        if not opt.test:
            trainer.evaluate(test_ds)
        trainer.test(test_ds)
        return trainer

    train_ds = make_ds("train")
    max_epoch = int(np.ceil(opt.iters / len(train_ds)))
    if opt.max_epochs:
        max_epoch = min(max_epoch, opt.max_epochs)
    if rank == 0:
        print(f"max_epoch: {max_epoch}")
    trainer.train(train_ds, make_ds("val"), make_ds("refine"), max_epoch,
                  run_refine=not opt.train_only)
    if opt.train_only:
        return trainer

    test_ds = make_ds("test")
    trainer.evaluate(test_ds)
    trainer.test(test_ds)
    return trainer


if __name__ == "__main__":
    main()
