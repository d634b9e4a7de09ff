#!/usr/bin/env python3
"""Time a redesigned kernel against its earlier design at the flagship
field's per-call sizes, on one NVIDIA GPU: hash_grid_fwd and
plane_bilinear_bwd at the train step's and the render's, plane_bilinear_vjp
at Planes4D.__call__'s.

    python3 scripts/kernels_bench.py BASELINE_CSRC [--cases encoders]
                                     [--set MODULE.NAME=VALUE ...]

From the repository root. BASELINE_CSRC holds the kernel sources of the
commit to compare with: for plane_bilinear_vjp (`--cases encoders`, the
default) commit 477f7df, the last with its first design; for hash_grid_fwd
and plane_bilinear_bwd (`--cases train,render`) commit 9cc4bbd, the last
with theirs:

    git archive 477f7df lidar4d_tpu_torch/csrc | tar -x --strip-components=2 -C DIR

They are built with the package's nvcc flags into a library of their own and
called through that commit's C entry points (without a launch plan). The
cases are chip_smoke.py's:
  encoders  plane_bilinear_vjp's four calls of one Planes4D.__call__
            backward: the time planes [3, 8, 8, S] of the four scales on
            the encoders phase's 262,144 flow-warped points (1,024 rays of
            the synthetic scene, seed 0, x 256 samples, a per-ray time),
            warped by the flow net as initialised, or with --trained after
            chip_smoke.py's 7 flagship train steps, as its encoders phase
            warps them;
  train     1,024 training rays x 128 and x 256 samples (131,072 and
            262,144 points per density call) with the flagship field's
            specs, and the flow loss's cloud and ground points; under "fact"
            the train step's own route, under "classic" the classic one-hot
            route's F = 8 hash encodes;
  render    one 16,384-ray chunk of a rendered frame x 128 and x 256 samples
            (2,097,152 and 4,194,304 points per density call), hash_grid_fwd.
Each case is held against its plain version (relative error of the largest
magnitude: forward 1e-6, backward 1e-4) and timed with CUDA events in turns:
earlier design, current, current, earlier design; an encoders case also
times the PyTorch call with the same function (aten::grid_sampler_2d_backward)
and gives its byte bound.

--set changes a launch constant of the current design before the run, for
the design variants PERF.md records: `ho.` is ops/hash_onehot.py, `po.`
ops/plane_onehot.py (e.g. --set po.PLANE_VJP_STAGE=False, --set
po.PLANE_VJP_STAGE_BLOCKS=1, --set po.PLANE_VJP_WAVES=2, --set
po.PLANE_VJP_THREADS=256).

Prints one line per case with both means, then one JSON line with the sums
over a train step's calls per kernel and route, over a render chunk's calls
and over a Planes4D.__call__ backward's. Imports nothing of JAX.
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

ITERS = 20
RTOL = {"hash_grid_fwd": cs.KERNEL_RTOL, "plane_bilinear_bwd": cs.GRAD_RTOL,
        "plane_bilinear_vjp": cs.GRAD_RTOL}
_P, _I = ctypes.c_void_p, ctypes.c_int
# The earlier designs' C entry points: hash_grid_fwd and plane_bilinear_bwd
# as at commit 9cc4bbd, plane_bilinear_vjp as at commit 477f7df.
BASELINE_SIGNATURES = {
    "hash_grid_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _P),
    "plane_bilinear_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "plane_bilinear_vjp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
CASE_KERNELS = {"encoders": ("plane_bilinear_vjp",),
                "train": ("hash_grid_fwd", "plane_bilinear_bwd"),
                "render": ("hash_grid_fwd",)}


def build_baseline(csrc, kernels):
    """Compile the .cu files of `csrc` with the package's nvcc flags into a
    library of their own; returns the ctypes handle with the earlier
    designs' signatures of `kernels`' entry points."""
    sources = sorted(Path(csrc).glob("*.cu"))
    h = hashlib.sha256()
    for src in sources + sorted(Path(csrc).glob("*.cuh")):
        h.update(src.read_bytes())
    so = _cuda.BUILD_DIR / f"baseline_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline nvcc failed: {proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in kernels:
        fn = getattr(lib, f"lidar4d_{name}")
        fn.argtypes = BASELINE_SIGNATURES[name]
        fn.restype = _I
    return lib


def baseline_wrappers(lib, kernels):
    """`kernels` through the baseline library, with the earlier wrappers'
    arguments: hash_grid_fwd and plane_bilinear_bwd as at commit 9cc4bbd,
    plane_bilinear_vjp as at commit 477f7df."""

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

    def plane_bilinear_vjp(grid, pts, cot):
        p, c, h, w = grid.shape
        n = pts.shape[1]
        pts = _cuda.aligned(pts, 8)
        dgrid = torch.zeros((p, c, h, w), device=pts.device)
        dpts = torch.empty((p, n, 2), device=pts.device)
        rc = lib.lidar4d_plane_bilinear_vjp(grid.data_ptr(), pts.data_ptr(), cot.data_ptr(),
                                            dgrid.data_ptr(), dpts.data_ptr(), p, n, c, h, w,
                                            stream(pts.device))
        if rc:
            raise RuntimeError(f"baseline plane_bilinear_vjp: cudaError {rc}")
        return dgrid, dpts

    wrappers = {"hash_grid_fwd": hash_grid_fwd, "plane_bilinear_bwd": plane_bilinear_bwd,
                "plane_bilinear_vjp": plane_bilinear_vjp}
    return {name: wrappers[name] for name in kernels}


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
    with contextlib.ExitStack() as stack:
        for name, fn in wrappers.items():
            stack.enter_context(patched(ho if name == "hash_grid_fwd" else po, **{name: fn}))
        yield


def rel_err(run, plain, zero_check=None):
    """Largest relative error over the outputs (each against its own largest
    magnitude), and what `zero_check` (chip_smoke.vjp_zeros) returns on the
    last outputs: the float32 cancellations, or None without one."""
    got, want = run(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
              for g, w in zip(got, want))
    return err, zero_check(got[-1], want[-1]) if zero_check else None


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
        cases += [(k, f"{pts.shape[0]} pts {label}", run, plain, None, None)
                  for k, label, run, plain, *_ in both]
    for backward in (False, True):
        flow = cs.flow_loss_cases(field, params, gen,
                                  torch.as_tensor(cache["points"][fi], device=dev),
                                  torch.as_tensor(cache["ground"][fi], device=dev), backward,
                                  classic)
        cases += [(k, label, run, plain, None, None) for k, label, run, plain, *_ in flow]
    return [c for c in cases if c[0] in CASE_KERNELS["train"]]


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
    return [(k, f"{n_points} pts {label}", run, plain, None, None)
            for k, label, run, plain, *_ in cs.kernel_cases(field, params, gen, pts)
            if k == "hash_grid_fwd"]


def encoder_cases(field, params, ds, opt, dev):
    """(kernel, label, run, plain, library, bound ms) of plane_bilinear_vjp
    at one Planes4D.__call__ backward on the encoders phase's warped points,
    as chip_smoke.check_encoders builds them from `params`. Prints, per
    scale, the share of consecutive points whose time-plane cell changes."""
    from lidar4d_tpu_torch.interop import tree_to_torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 1)
    x01, t = cs.encoder_samples(field, ds, opt, dev, gen)
    with cs.mlp_dtype(torch.float32):
        xyz = cs.warp(field, tree_to_torch(cs.signal_params(params)["flow"], dev), x01)
    shift = (xyz - x01).abs()
    changes = {}
    for planes_s in params["planes"]:
        t_res, s = planes_s[2].shape[1:]
        y = torch.floor(torch.clamp(t[:, 0], 0, 1) * (t_res - 1))
        cell = y[:, None] * s + torch.floor(torch.clamp(xyz, 0, 1) * (s - 1))     # [N, 3]
        changes[s] = [round((cell[1:, c] != cell[:-1, c]).float().mean().item(), 4)
                      for c in range(3)]
    print(json.dumps({"flow_shift_mean": shift.mean().item(), "flow_shift_max": shift.max().item(),
                      "cell_change_share": changes}), flush=True)
    return [(k, f"{x01.shape[0]} pts {label}", run, plain, library, cs.bound_ms(nb, flops)[0],
             zeros)
            for k, label, run, plain, library, nb, flops, zeros
            in cs.vjp_cases(params, gen, xyz, t)]


def run_cases(route, cases, base, sums):
    for name, label, run, plain, library, bound, *zero_check in cases:
        err, cancelled = rel_err(run, plain, *zero_check)
        line = {"route": route, "kernel": name, "case": label, "max_rel": err}
        if cancelled is not None:
            line["float32_cancellations"] = cancelled
        if not err <= RTOL[name]:
            raise AssertionError(f"{name} {label}: max_rel {err} > {RTOL[name]}")
        with baseline(base):
            line["baseline_max_rel"] = rel_err(run, plain)[0]
            b1 = cs.cuda_ms(run, ITERS)
        c1, c2 = cs.cuda_ms(run, ITERS), cs.cuda_ms(run, ITERS)
        with baseline(base):
            b2 = cs.cuda_ms(run, ITERS)
        line.update(ms=(c1 + c2) / 2, baseline_ms=(b1 + b2) / 2, turns=[b1, c1, c2, b2])
        if library is not None:
            line.update(library_ms=cs.cuda_ms(library, ITERS), bound_ms=bound)
        print(json.dumps(line), flush=True)
        s = sums.setdefault(f"{route} {name}", {"ms": 0.0, "baseline_ms": 0.0})
        for k in ("ms", "baseline_ms", "library_ms", "bound_ms"):
            if k in line:
                s[k] = s.get(k, 0.0) + line[k]
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
    ap.add_argument("--cases", default="encoders")
    ap.add_argument("--set", action="append", default=[], dest="settings")
    ap.add_argument("--trained", action="store_true",
                    help="encoders cases after chip_smoke.py's flagship train steps, whose "
                         "flow net its encoders phase warps with")
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
    kinds = args.cases.split(",")
    if not set(kinds) <= set(CASE_KERNELS):
        raise SystemExit(f"--cases {args.cases}: not among {sorted(CASE_KERNELS)}")
    kernels = sorted({k for kind in kinds for k in CASE_KERNELS[kind]})
    base = baseline_wrappers(build_baseline(args.baseline_csrc, kernels), kernels)

    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.models.renderer import render_frames_staged

    opt = get_arg_parser().parse_args(["--config", str(ROOT / cs.CONFIG)])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=cs.SEED)
    sums = {}
    with torch.no_grad():
        if "render" in kinds:
            chunk = inspect.signature(render_frames_staged).parameters["chunk"].default
            for samples in (opt.num_coarse, opt.num_fine):
                run_cases("render chunk",
                          render_cases(field, params, opt, dev, chunk * samples, chunk), base, sums)
        if "train" in kinds or "encoders" in kinds:
            with tempfile.TemporaryDirectory() as root:
                ds, cache, scale = cs.make_scene(root)
            tfield = cs.train_field(field, scale)
        if "encoders" in kinds:
            if args.trained:
                with torch.enable_grad():
                    cs.train(tfield, params, ds, cache, opt, dev)
            run_cases("encoders", encoder_cases(tfield, params, ds, opt, dev), base, sums)
        if "train" in kinds:
            for route in ("fact", "classic"):
                with cs.onehot_variant(route):
                    run_cases(route, train_cases(tfield, params, ds, cache, opt, dev,
                                                 route == "classic"), base, sums)
    print(smi)
    print(json.dumps({"settings": args.settings, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
