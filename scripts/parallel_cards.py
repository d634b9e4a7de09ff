#!/usr/bin/env python3
"""Ray parallelism across the cards of one host: NCCL, one rank a card.

    python3 scripts/parallel_cards.py

Needs two or more CUDA cards; uses every card. Two parts, each printing its
numbers, and a JSON line {"parallel_cards": {...}} at the end:
  1. chip_smoke.py's parallel ranks (`run_parallel_ranks`) on NCCL, one a
     card: 3 sharded flagship steps at patch 1 and 3 at patch (2, 8) on the
     synthetic 66x1030x51 scene (float32 MLPs), each step's loss and
     gradients on rank 0 held against the one-process step from the same
     parameters and draws (the metrics to `RTOL`, the gradients to
     `GRAD_RTOL`), each
     rank's kernel launches per step against one process's step, the
     ranks' parameters bitwise equal after the steps, each rank's ms/step;
     one 66x1030 frame rendered over the ranks against one process.
  2. The training CLI, `cli.main_lidar4d.main`, with the flagship config
     on that scene (one epoch of the 41 train frames, the uniform warm-up
     sampler, evaluation of the 10 val frames, --train_only), once with
     --num_devices set to the card count (the CLI starts its ranks, one a
     card) and once on one card, float32 MLPs in both (the ranks started by
     the CLI too): rank 0 alone wrote the checkpoint, the epoch losses and
     the evaluation meters are finite, and the gaps between the two runs
     (last step loss, evaluation meters, parameters after the epoch; 41
     Adam steps apart, each from float32 sums in another order) are
     printed.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke as cs  # noqa: E402

# Gaps of N ranks against one process beyond chip_smoke.py's 2-rank limits.
# A rank's GEMMs over a quarter of the rays may take another cuBLAS kernel,
# so each ray's depth differs at float32 rounding, and the patch gradient
# loss, built from differences of neighbouring depths, magnifies that: 4
# H100s gave 1.02e-6 on it (chip_smoke.py's limit 1e-6); the gradients:
# float32 summation order with cancellation, 2.2e-6 of a ray-drop leaf's
# largest entry with 4 ranks on the CPU; the flow net's as chip_smoke.py's
RTOL = 1e-5
GRAD_RTOL = {"flow": 8e-4, "hash": 1e-5, "planes": 2e-5, "sigma": 1e-5, "intensity": 1e-5,
             "raydrop": 1e-5}


def float32_rank_main(rank, argv):
    """The CLI's spawned ranks, with float32 MLPs."""
    from lidar4d_tpu_torch.cli import main_lidar4d

    with cs.mlp_dtype(torch.float32):
        main_lidar4d._rank_main(rank, argv)


def cli_runs(root, scale, offset, n_cards):
    from lidar4d_tpu_torch.cli import main_lidar4d
    from lidar4d_tpu_torch.interop import tree_leaves

    n_train = sum(1 for f in range(cs.SCENE["num_frames"]) if f % 5 != 4)
    argv = ["--config", cs.CONFIG, "--dataloader", "synthetic", "--path", f"{root}/scene",
            "--sequence_id", cs.SCENE["sequence_id"], "--num_frames", str(cs.SCENE["num_frames"]),
            "--synthetic_H", str(cs.SCENE["H"]), "--synthetic_W", str(cs.SCENE["W"]),
            "--synthetic_seed", str(cs.SCENE["seed"]), "--scale", repr(scale),
            "--offset", *map(repr, offset), "--iters", str(n_train), "--eval_interval", "1",
            "--seed", str(cs.SEED), "--ckpt", "scratch", "--train_only"]
    main_lidar4d._rank_main = float32_rank_main
    runs = {}
    for n in (n_cards, 1):
        t0 = time.perf_counter()
        with cs.mlp_dtype(torch.float32):
            trainer = main_lidar4d.main(argv + ["--workspace", f"{root}/ws{n}",
                                                "--num_devices", str(n)])
        seconds = time.perf_counter() - t0
        records = cs.read_jsonl(trainer.metrics_path)
        epoch = next(r for r in records if "rays_per_sec" in r)
        evaluation = next(r for r in records if "valid_loss" in r)
        names = sorted(os.listdir(trainer.ckpt.ckpt_dir))
        print(f"  CLI --num_devices {n}: {seconds:.1f} s; epoch loss {epoch['loss']:.6f}, "
              f"{epoch['rays_per_sec']:,.0f} rays/s; eval {json.dumps(evaluation)}; "
              f"checkpoints {names}", flush=True)
        if "lidar4d_ep0001" not in names or not set(names) <= {"lidar4d_best", "lidar4d_ep0001"} \
                or not np.isfinite(epoch["loss"]):
            raise AssertionError(f"--num_devices {n}: checkpoints {names}, loss {epoch['loss']}")
        runs[n] = dict(seconds=seconds, epoch=epoch, eval=evaluation,
                       params=[p.detach().cpu() for p in tree_leaves(trainer.state.params)])
    many, one = runs[n_cards], runs[1]
    gaps = {
        "loss_rel": abs(many["epoch"]["loss"] - one["epoch"]["loss"]) / abs(one["epoch"]["loss"]),
        "params_max_abs": max((a - b).abs().max().item()
                              for a, b in zip(many["params"], one["params"])),
        "eval_rel": {k: float(np.max(np.abs(np.subtract(many["eval"][k], one["eval"][k]))
                                     / np.maximum(np.abs(one["eval"][k]), 1e-30)))
                     for k in one["eval"] if k not in ("epoch",) and not isinstance(
                         one["eval"][k], bool)}}
    print(f"  CLI {n_cards} cards vs one: {json.dumps(gaps)}", flush=True)
    return {"seconds": {n: r["seconds"] for n, r in runs.items()},
            "rays_per_sec": {n: r["epoch"]["rays_per_sec"] for n, r in runs.items()},
            "gaps": gaps}


def main():
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"parallel_cards: {n_cards} CUDA card(s); needs two or more", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout, flush=True)
    from lidar4d_tpu_torch.ops import _cuda

    _cuda.library()
    with tempfile.TemporaryDirectory() as root:
        cs.phase("scene")
        ds, cache, scale, offset = cs.make_scene(f"{root}/steps")
        cs.phase("ranks")
        seconds, ranks = cs.run_parallel_ranks(ds, cache, n_cards, "nccl", RTOL, GRAD_RTOL)
        cs.phase("cli")
        cli = cli_runs(root, scale, offset, n_cards)
    print(json.dumps({"parallel_cards": {"cards": n_cards, "backend": "nccl",
                                         "ranks_s": seconds, "by_rank": ranks, "cli": cli}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
