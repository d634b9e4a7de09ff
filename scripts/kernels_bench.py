#!/usr/bin/env python3
"""Time hash_grid_fwd and plane_bilinear_bwd against their earlier design,
at the flagship train step's and the render's per-call sizes, on one NVIDIA
GPU.

    python3 scripts/kernels_bench.py BASELINE_CSRC [--cases train,render]
                                     [--set MODULE.NAME=VALUE ...]

From the repository root. BASELINE_CSRC holds the kernel sources of commit
9cc4bbd, the last with the earlier design of both kernels:

    git archive 9cc4bbd lidar4d_tpu_torch/csrc | tar -x --strip-components=2 -C DIR

They are built with the package's nvcc flags into a library of their own and
called through that commit's C entry points (hash_grid_fwd without a launch
plan, plane_bilinear_bwd without a channel slice or run). The cases are
chip_smoke.py's cases of the two kernels:
  train   1,024 training rays of the synthetic scene (seed 0) x 128 and x 256
          samples (131,072 and 262,144 points per density call) with the
          flagship field's specs, and the flow loss's cloud and ground
          points; under "fact" the train step's own route, under "classic"
          the classic one-hot route's F = 8 hash encodes;
  render  one 16,384-ray chunk of a rendered frame x 128 and x 256 samples
          (2,097,152 and 4,194,304 points per density call), hash_grid_fwd.
Each case is held against its plain version (relative error of the largest
magnitude: forward 1e-6, backward 1e-4) and timed with CUDA events in turns:
earlier design, current, current, earlier design.

--set changes a launch constant of the current design before the run, for
the design variants PERF.md records: `ho.` is ops/hash_onehot.py, `po.`
ops/plane_onehot.py (e.g. --set ho.HASH_FWD_STAGE=False, --set
po.PLANE_BWD_SLICE_BYTES=232448).

Prints one line per case with both means, then one JSON line with the sums
over a train step's calls per kernel and route and over a render chunk's
calls. Imports nothing of JAX.
"""

import argparse
import ast
import contextlib
import ctypes
import hashlib
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lidar4d_tpu_torch.ops import _cuda  # noqa: E402
from lidar4d_tpu_torch.ops import hash_onehot as ho  # noqa: E402
from lidar4d_tpu_torch.ops import plane_onehot as po  # noqa: E402

KERNELS = ("hash_grid_fwd", "plane_bilinear_bwd")
ITERS = 20
RTOL = {"hash_grid_fwd": cs.KERNEL_RTOL, "plane_bilinear_bwd": cs.GRAD_RTOL}


def build_baseline(csrc):
    """Compile the .cu files of `csrc` with the package's nvcc flags into a
    library of their own; returns the ctypes handle with commit 9cc4bbd's
    entry points' signatures."""
    sources = sorted(Path(csrc).glob("*.cu"))
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    so = _cuda.BUILD_DIR / f"baseline_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline nvcc failed: {proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lidar4d_hash_grid_fwd.argtypes = (p, p, p, p, i, i, i, i, i, ctypes.c_longlong, p)
    lib.lidar4d_plane_bilinear_bwd.argtypes = (p, p, p, i, i, i, i, i, p)
    for fn in (lib.lidar4d_hash_grid_fwd, lib.lidar4d_plane_bilinear_bwd):
        fn.restype = i
    return lib


def baseline_wrappers(lib):
    """hash_grid_fwd / plane_bilinear_bwd through the baseline library, with
    commit 9cc4bbd's wrappers' arguments."""

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def hash_grid_fwd(spec, tables, xs):
        v, n, _ = xs.shape
        tables = _cuda.aligned(tables)
        out = torch.empty((v, n, spec.n_output_dims), device=xs.device)
        levels = ho._level_table(spec, xs.device)
        rc = lib.lidar4d_hash_grid_fwd(xs.data_ptr(), tables.data_ptr(), levels.data_ptr(),
                                       out.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                                       spec.n_features, spec.n_rows, stream(xs.device))
        if rc:
            raise RuntimeError(f"baseline hash_grid_fwd: cudaError {rc}")
        return out

    def plane_bilinear_bwd(pts, cot, hw):
        p, c, n = cot.shape
        pts = _cuda.aligned(pts, 8)
        dgrid = torch.zeros((p, c, *hw), device=pts.device)
        rc = lib.lidar4d_plane_bilinear_bwd(pts.data_ptr(), cot.data_ptr(), dgrid.data_ptr(),
                                            p, n, c, hw[0], hw[1], stream(pts.device))
        if rc:
            raise RuntimeError(f"baseline plane_bilinear_bwd: cudaError {rc}")
        return dgrid

    return {"hash_grid_fwd": hash_grid_fwd, "plane_bilinear_bwd": plane_bilinear_bwd}


@contextlib.contextmanager
def patched(obj, **attrs):
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


@contextlib.contextmanager
def baseline(wrappers):
    with patched(ho, hash_grid_fwd=wrappers["hash_grid_fwd"]), \
            patched(po, plane_bilinear_bwd=wrappers["plane_bilinear_bwd"]):
        yield


def rel_err(run, plain):
    got, want = run(), plain()
    torch.cuda.synchronize()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def train_cases(field, params, ds, cache, opt, dev, classic):
    """(kernel, label, run, plain) of the two kernels at the train step's
    per-call sizes, as chip_smoke.check_train_kernels builds them."""
    from lidar4d_tpu_torch.ops.rays import get_lidar_rays

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    frame = ds.frame(0)
    rays = get_lidar_rays(torch.as_tensor(frame["pose"], device=dev), cs.FOV, ds.H_lidar,
                          ds.W_lidar, N=cs.TRAIN_RAYS, generator=gen)
    cfg = field.cfg
    fi = int(round(float(frame["time"]) * (cfg.num_frames - 1)))
    cases = []
    for samples in (opt.num_coarse, opt.num_fine):
        pts = cs.chunk_points(rays["rays_o"], rays["rays_d"], cfg.near_lidar, cfg.far_lidar,
                              cfg.bound, samples)
        both = cs.kernel_cases(field, params, gen, pts, classic) + cs.backward_cases(
            field, params, gen, pts, classic)
        cases += [(k, f"{pts.shape[0]} pts {label}", run, plain)
                  for k, label, run, plain, *_ in both]
    for backward in (False, True):
        flow = cs.flow_loss_cases(field, params, gen,
                                  torch.as_tensor(cache["points"][fi], device=dev),
                                  torch.as_tensor(cache["ground"][fi], device=dev), backward,
                                  classic)
        cases += [(k, label, run, plain) for k, label, run, plain, *_ in flow]
    return [c for c in cases if c[0] in KERNELS]


def render_cases(field, params, opt, dev, n_points, chunk):
    """(kernel, label, run, plain) of hash_grid_fwd at one render chunk's
    density call of n_points points along the chunk's rays, as
    chip_smoke.check_kernels builds them."""
    from lidar4d_tpu_torch.sim.simulator import build_novel_rays

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[:, 0, 3] = -0.05
    rays_o, rays_d = build_novel_rays(pose, opt.H_lidar, opt.W_lidar, opt.fov_lidar)
    rays = [torch.as_tensor(r[0, :chunk], device=dev) for r in (rays_o, rays_d)]
    pts = cs.chunk_points(*rays, field.cfg.near_lidar, field.cfg.far_lidar, field.cfg.bound,
                          n_points // chunk)
    return [(k, f"{n_points} pts {label}", run, plain)
            for k, label, run, plain, *_ in cs.kernel_cases(field, params, gen, pts)
            if k == "hash_grid_fwd"]


def run_cases(route, cases, base, sums):
    for name, label, run, plain in cases:
        err = rel_err(run, plain)
        line = {"route": route, "kernel": name, "case": label, "max_rel": err}
        if not err <= RTOL[name]:
            raise AssertionError(f"{name} {label}: max_rel {err} > {RTOL[name]}")
        with baseline(base):
            line["baseline_max_rel"] = rel_err(run, plain)
            b1 = cs.cuda_ms(run, ITERS)
        c1, c2 = cs.cuda_ms(run, ITERS), cs.cuda_ms(run, ITERS)
        with baseline(base):
            b2 = cs.cuda_ms(run, ITERS)
        line.update(ms=(c1 + c2) / 2, baseline_ms=(b1 + b2) / 2, turns=[b1, c1, c2, b2])
        print(json.dumps(line), flush=True)
        s = sums.setdefault(f"{route} {name}", {"ms": 0.0, "baseline_ms": 0.0})
        s["ms"] += line["ms"]
        s["baseline_ms"] += line["baseline_ms"]
        torch.cuda.empty_cache()


def apply_settings(settings):
    mods = {"ho": ho, "po": po}
    for item in settings:
        key, value = item.split("=", 1)
        mod, name = key.split(".", 1)
        if mod not in mods or not hasattr(mods[mod], name):
            raise SystemExit(f"--set {item}: no such launch constant")
        setattr(mods[mod], name, ast.literal_eval(value))
        print(f"set {key} = {getattr(mods[mod], name)!r}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline_csrc")
    ap.add_argument("--cases", default="train,render")
    ap.add_argument("--set", action="append", default=[], dest="settings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernels_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    apply_settings(args.settings)

    _, log = _cuda.build()
    _cuda.library()
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    base = baseline_wrappers(build_baseline(args.baseline_csrc))

    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.models.renderer import render_frames_staged

    opt = get_arg_parser().parse_args(["--config", str(ROOT / cs.CONFIG)])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=cs.SEED)
    sums = {}
    kinds = args.cases.split(",")
    with torch.no_grad():
        if "render" in kinds:
            chunk = inspect.signature(render_frames_staged).parameters["chunk"].default
            for samples in (opt.num_coarse, opt.num_fine):
                run_cases("render chunk",
                          render_cases(field, params, opt, dev, chunk * samples, chunk), base, sums)
        if "train" in kinds:
            with tempfile.TemporaryDirectory() as root:
                ds, cache, scale = cs.make_scene(root)
            tfield = cs.train_field(field, scale)
            for route in ("fact", "classic"):
                with cs.onehot_variant(route):
                    run_cases(route, train_cases(tfield, params, ds, cache, opt, dev,
                                                 route == "classic"), base, sums)
    print(smi)
    print(json.dumps({"settings": args.settings, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
