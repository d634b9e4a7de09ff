#!/usr/bin/env python3
"""Peak device memory of one process of a training run's evaluation, and
what holds it: the bfloat16-twin witness (`converge_torch.py
--tpu-numerics`) by default, or the kernels (`--variant exact`).

    python3 scripts/twin_memory.py                       # the twins, this tree
    python3 scripts/twin_memory.py --sources DIR         # the port and chip_smoke.py of DIR
    python3 scripts/twin_memory.py --variant exact

Runs the training CLI in this process on conf_phash111's config (on
converge_torch's bench scene, written into `--scene` unless it is there)
for one epoch and the evaluation after it (`--max_epochs 1
--eval_interval 1 --train_only`): that evaluation renders the validation
frames as the record's epoch-27 evaluation does, at the same ray chunks and
sample counts. Records, per stage (epoch, evaluate), the peak of
`torch.cuda.max_memory_allocated`, and per swapped function (each twin, or
each kernel wrapper under `--variant exact`) its calls, the largest rise of
allocated memory over one call and that call's argument shapes. Prints
them as one JSON line. `--sources DIR` imports `lidar4d_tpu_torch` and
`chip_smoke` from DIR (e.g. an earlier commit unpacked with `git archive`),
so that one script measures two versions in one call. Needs a CUDA card.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GIB = float(1 << 30)
CONFIG = "configs/bench_conf_phash111.txt"


def shapes(args):
    return [list(a.shape) if hasattr(a, "shape") else a for a in args
            if hasattr(a, "shape") or isinstance(a, (int, float))]


class Tracker:
    """Peak allocated memory by stage and by watched function. A watched
    call resets the allocator's peak to measure its own rise, so the stage
    peak is kept here as the largest peak seen before each reset."""

    def __init__(self, torch):
        self.torch = torch
        self.peak = 0
        self.stages = {}
        self.calls = {}

    def seen(self):
        self.peak = max(self.peak, self.torch.cuda.max_memory_allocated())

    def stage(self, name, fn):
        def run(*args, **kwargs):
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
            self.peak = 0
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seen()
            self.stages[name] = {"peak_gib": self.peak / GIB,
                                 "seconds": time.perf_counter() - t0}
            return out
        return run

    def watch(self, name, fn):
        def run(*args, **kwargs):
            self.seen()
            base = self.torch.cuda.memory_allocated()
            self.torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            rise = self.torch.cuda.max_memory_allocated() - base
            self.seen()
            rec = self.calls.setdefault(name, {"calls": 0, "max_rise_gib": 0.0, "shapes": None})
            rec["calls"] += 1
            if rise / GIB >= rec["max_rise_gib"]:
                rec["max_rise_gib"] = rise / GIB
                rec["shapes"] = shapes(args)
            return out
        return run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sources", default=None,
                   help="a directory holding lidar4d_tpu_torch/ and chip_smoke.py to measure")
    p.add_argument("--variant", default="tpu", choices=("tpu", "exact"))
    p.add_argument("--scene", default="data/bench_synth_torch")
    args = p.parse_args(argv)
    sources = Path(args.sources or ROOT).resolve()
    sys.path.insert(0, str(sources))
    os.chdir(ROOT)

    import torch

    import chip_smoke
    from lidar4d_tpu_torch.cli import main_lidar4d
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.train import trainer as trainer_mod

    if not torch.cuda.is_available():
        raise SystemExit("twin_memory.py needs a CUDA card")
    if not (Path(args.scene) / "meta.json").exists():
        scale, offset = generate_synthetic_sequence(args.scene, **chip_smoke.SCENE)
        (Path(args.scene) / "meta.json").write_text(json.dumps(
            {"scale": scale, "offset": offset, "scene": chip_smoke.SCENE}))
    _cuda.build()

    tracker = Tracker(torch)
    names = (chip_smoke.TPU_VERSIONS.values() if args.variant == "tpu"
             else chip_smoke.PLAIN_VERSIONS.keys())
    saved = {n: getattr(chip_smoke.kernel_module(n), n) for n in names}
    for n, fn in saved.items():
        setattr(chip_smoke.kernel_module(n), n, tracker.watch(n, fn))
    T = trainer_mod.Trainer
    stages = {"train_one_epoch": T.train_one_epoch, "evaluate_one_epoch": T.evaluate_one_epoch}
    for n, fn in stages.items():
        setattr(T, n, tracker.stage(n, fn))
    ws = tempfile.mkdtemp(prefix="twin_memory_")
    argv = ["--config", CONFIG, "--dataloader", "synthetic", "--path", args.scene,
            "--workspace", ws, "--max_epochs", "1", "--eval_interval", "1", "--train_only"]
    try:
        if args.variant == "tpu":
            with chip_smoke.tpu_numerics():
                main_lidar4d.main(argv)
        else:
            main_lidar4d.main(argv)
    finally:
        for n, fn in saved.items():
            setattr(chip_smoke.kernel_module(n), n, fn)
        for n, fn in stages.items():
            setattr(T, n, fn)
        shutil.rmtree(ws, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "variant": args.variant, "sources": str(sources),
                      "config": CONFIG, "stages": tracker.stages,
                      "calls": tracker.calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
