#!/usr/bin/env python3
"""Time a redesigned kernel against its earlier design at the per-call
sizes of the flagship field and of the reference configuration, on one
NVIDIA GPU: hash_grid_fwd and plane_bilinear_bwd at the train step's and
the render's, plane_bilinear_vjp at Planes4D.__call__'s, hash_grid_fwd and
hash_grid_bwd at the reference step's and the reference frame's.

    python3 scripts/kernels_bench.py BASELINE_CSRC [--cases encoders]
                                     [--commit COMMIT]
                                     [--set MODULE.NAME=VALUE ...]
                                     [--variant LABEL=MODULE.NAME=VALUE[;...] ...]

From the repository root. BASELINE_CSRC holds the kernel sources of the
commit to compare with, and --commit names it (by default the commit the
first case kind was redesigned against): for plane_bilinear_vjp (`--cases
encoders`, the default) commit 477f7df, the last with its first design; for
hash_grid_fwd and plane_bilinear_bwd (`--cases train,render`) commit
9cc4bbd, the last with theirs; for the large-table routes of hash_grid_fwd
and hash_grid_bwd (`--cases reference,reference-step`) commit 1e411c8, the
last without them, which `--commit 1e411c8` also sets for `train,render`
(both hash kernels then, to show the flagship calls unmoved):

    git archive 1e411c8 lidar4d_tpu_torch/csrc | tar -x --strip-components=2 -C DIR

They are built with the package's nvcc flags into a library of their own and
called through that commit's C entry points: 477f7df's and 9cc4bbd's
without a launch plan, 1e411c8's with its launch plans (hash_grid_fwd's
tile path with HASH_FWD_L1_KEEP of L1 whatever the table; hash_grid_bwd's
lane route, every level of these specs in global memory, over two resident
waves of all levels). The cases are chip_smoke.py's:
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
            (2,097,152 and 4,194,304 points per density call), hash_grid_fwd;
  reference every hash kernel call of one step of configs/kitti360_4950.txt
            at the CLI defaults (chip_smoke.record_reference_step: 1,024 rays
            x 768 uniform samples on the synthetic scene, the flow loss, the
            seeded init's signal parameters), 13 hash_grid_fwd and 7
            hash_grid_bwd, then the 11 hash_grid_fwd calls of the middle
            4,096-ray chunk of a rendered 66 x 1030 frame (3,145,728 points
            each; 17 chunks a frame); before them, each backward call's
            corner-row changes (`row_updates`);
  reference-step  the reference step and frame end to end on either
            design's hash kernels, in turns (`reference_end_to_end`):
            ms/step, device busy ms and idle share of a profiled step,
            s/frame of Simulator.render with the U-Net refine.
Each case is held against its plain version (relative error of the largest
magnitude: forward 1e-6, backward 1e-4; a reference backward against its
plain version with tables and cotangents in float64, as chip_smoke's
reference phase holds it) and timed with CUDA events in turns: earlier
design, current, current, earlier design; an encoders case also times the
PyTorch call with the same function (aten::grid_sampler_2d_backward) and
gives its byte bound; a reference case gives its byte bound and the route
the current design took (`path`, by the wrappers' route counters).

--set changes a launch constant of the current design before the run, for
the design variants PERF.md records: `ho.` is ops/hash_onehot.py, `po.`
ops/plane_onehot.py (e.g. --set po.PLANE_VJP_STAGE=False, --set
po.PLANE_VJP_STAGE_BLOCKS=1, --set po.PLANE_VJP_WAVES=2, --set
po.PLANE_VJP_THREADS=256). --variant times the current design under such
settings beside it, in the same turns (current, each variant, current, each
variant in reverse), e.g. --variant "scalar=ho.HASH_BWD_VECTOR=False"
--variant "allwaves=ho.HASH_BWD_LEVEL_MAJOR=False" --variant
"nofloor=ho.HASH_FWD_L2_RESIDENT=0"; each variant is held to the plain
version too.

Prints one line per case with the means, then one JSON line with the sums
over a train step's calls per kernel and route, over a render chunk's calls,
over a Planes4D.__call__ backward's, over a reference step's and a
reference frame chunk's calls, and the reference step and frame's means by
design. Imports nothing of JAX.
"""

import argparse
import ast
import collections
import contextlib
import copy
import ctypes
import hashlib
import inspect
import json
import subprocess
import sys
import tempfile
import time
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
RTOL = {"hash_grid_fwd": cs.KERNEL_RTOL, "hash_grid_bwd": cs.GRAD_RTOL,
        "plane_bilinear_bwd": cs.GRAD_RTOL, "plane_bilinear_vjp": cs.GRAD_RTOL}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The earlier designs' C entry points and occupancy queries, by commit.
BASELINE_SIGNATURES = {
    "9cc4bbd": {"hash_grid_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _P),
                "plane_bilinear_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P)},
    "477f7df": {"plane_bilinear_vjp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)},
    "1e411c8": {"hash_grid_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I,
                                  _P),
                "hash_grid_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _P),
                "hash_grid_fwd_blocks_per_sm": (_I,) * 7,
                "hash_grid_bwd_blocks_per_sm": (_I,) * 3},
}
# The kernels each case kind compares, by baseline commit.
CASE_KERNELS = {
    "477f7df": {"encoders": ("plane_bilinear_vjp",)},
    "9cc4bbd": {"train": ("hash_grid_fwd", "plane_bilinear_bwd"), "render": ("hash_grid_fwd",)},
    "1e411c8": {"train": ("hash_grid_fwd", "hash_grid_bwd"), "render": ("hash_grid_fwd",),
                "reference": ("hash_grid_fwd", "hash_grid_bwd"),
                "reference-step": ("hash_grid_fwd", "hash_grid_bwd")},
}
DEFAULT_COMMIT = {"encoders": "477f7df", "train": "9cc4bbd", "render": "9cc4bbd",
                  "reference": "1e411c8", "reference-step": "1e411c8"}


def build_baseline(csrc, commit):
    """Compile the .cu files of `csrc` with the package's nvcc flags into a
    library of their own; returns the ctypes handle with `commit`'s
    signatures of its entry points."""
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
    for name, argtypes in BASELINE_SIGNATURES[commit].items():
        fn = getattr(lib, f"lidar4d_{name}")
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name, rc):
    if rc:
        raise RuntimeError(f"baseline {name}: cudaError {rc}")


def baseline_wrappers(lib, commit):
    """The kernels of `commit` through the baseline library, with that
    commit's wrappers' arguments: hash_grid_fwd and plane_bilinear_bwd as at
    commit 9cc4bbd, plane_bilinear_vjp as at commit 477f7df."""
    if commit == "1e411c8":
        return parent_wrappers(lib)

    def hash_grid_fwd(spec, tables, xs):
        v, n, _ = xs.shape
        tables = _cuda.aligned(tables)
        out = torch.empty((v, n, spec.n_output_dims), device=xs.device)
        levels = ho._level_table(spec, xs.device)
        _check("hash_grid_fwd", lib.lidar4d_hash_grid_fwd(
            xs.data_ptr(), tables.data_ptr(), levels.data_ptr(), out.data_ptr(), v, n,
            spec.n_levels, spec.n_dims, spec.n_features, spec.n_rows, _stream(xs.device)))
        return out

    def plane_bilinear_bwd(pts, cot, hw):
        p, c, n = cot.shape
        pts = _cuda.aligned(pts, 8)
        dgrid = torch.zeros((p, c, *hw), device=pts.device)
        _check("plane_bilinear_bwd", lib.lidar4d_plane_bilinear_bwd(
            pts.data_ptr(), cot.data_ptr(), dgrid.data_ptr(), p, n, c, hw[0], hw[1],
            _stream(pts.device)))
        return dgrid

    def plane_bilinear_vjp(grid, pts, cot):
        p, c, h, w = grid.shape
        n = pts.shape[1]
        pts = _cuda.aligned(pts, 8)
        dgrid = torch.zeros((p, c, h, w), device=pts.device)
        dpts = torch.empty((p, n, 2), device=pts.device)
        _check("plane_bilinear_vjp", lib.lidar4d_plane_bilinear_vjp(
            grid.data_ptr(), pts.data_ptr(), cot.data_ptr(), dgrid.data_ptr(), dpts.data_ptr(),
            p, n, c, h, w, _stream(pts.device)))
        return dgrid, dpts

    wrappers = {"hash_grid_fwd": hash_grid_fwd, "plane_bilinear_bwd": plane_bilinear_bwd,
                "plane_bilinear_vjp": plane_bilinear_vjp}
    return {name: wrappers[name] for name in BASELINE_SIGNATURES[commit]}


def parent_wrappers(lib):
    """hash_grid_fwd and hash_grid_bwd as at commit 1e411c8: its C entry
    points with its launch plans, which had no level route (every table
    over the L2 went by the L1 tile route) and no vector route (the
    lane-per-feature kernel over HASH_BWD_WAVES resident waves of all
    levels). Each adds to the package's launch count as the wrappers do, so
    that chip_smoke.train's launch check holds on either design."""
    bps_cache = {}

    def bps(query, *args):
        if (query, args) not in bps_cache:
            blocks = getattr(lib, f"lidar4d_{query}")(*args)
            if blocks < 1:
                raise RuntimeError(f"baseline {query}{args}: {blocks}")
            bps_cache[query, args] = blocks
        return bps_cache[query, args]

    def hash_grid_fwd(spec, tables, xs):
        v, n, _ = xs.shape
        tables = _cuda.aligned(tables)
        out = torch.empty((v, n, spec.n_output_dims), device=xs.device)
        if n == 0:
            return out
        levels = ho._level_table(spec, xs.device)
        plan = ho.hash_fwd_launch(spec, n * v)
        run = 1
        if plan.min_run is not None:
            blocks = bps("hash_grid_fwd_blocks_per_sm", spec.n_dims, spec.n_levels,
                         spec.n_features, plan.table_floats, plan.threads, int(plan.tile),
                         plan.carveout)
            run = _cuda.persistent_run(n, plan.threads, v, plan.min_run,
                                       _cuda.sm_count(xs.device), blocks)
        _check("hash_grid_fwd", lib.lidar4d_hash_grid_fwd(
            xs.data_ptr(), tables.data_ptr(), levels.data_ptr(), out.data_ptr(), v, n,
            spec.n_levels, spec.n_dims, spec.n_features, spec.n_rows, plan.table_floats,
            plan.threads, int(plan.tile), plan.carveout, run, _stream(xs.device)))
        _cuda.LAUNCHES["hash_grid_fwd"] += 1
        return out

    def hash_grid_bwd(spec, xs, cot, n_tables=None):
        v, n, _ = xs.shape
        n_tables = v if n_tables is None else n_tables
        dtab = torch.zeros((n_tables, spec.n_rows, spec.n_features), device=xs.device)
        if n == 0:
            return dtab
        levels = ho._level_table(spec, xs.device)
        smem = ho._smem_floats(spec)
        blocks = bps("hash_grid_bwd_blocks_per_sm", spec.n_dims, spec.n_features, smem)
        run = _cuda.persistent_run(n, ho.HASH_BWD_THREADS // spec.n_features,
                                   spec.n_levels * v, ho.HASH_BWD_MIN_RUN,
                                   _cuda.sm_count(xs.device), blocks, ho.HASH_BWD_WAVES)
        _check("hash_grid_bwd", lib.lidar4d_hash_grid_bwd(
            xs.data_ptr(), cot.data_ptr(), levels.data_ptr(), dtab.data_ptr(), v, n,
            spec.n_levels, spec.n_dims, spec.n_features, spec.n_rows, run, smem,
            _stream(xs.device)))
        _cuda.LAUNCHES["hash_grid_bwd"] += 1
        return dtab

    return {"hash_grid_fwd": hash_grid_fwd, "hash_grid_bwd": hash_grid_bwd}


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
            stack.enter_context(patched(ho if name.startswith("hash_") else po, **{name: fn}))
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


def train_cases(field, params, ds, cache, opt, dev, classic, kernels):
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
    return [c for c in cases if c[0] in kernels]


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


def reference_setup(dev):
    """The reference configuration (chip_smoke.REFERENCE_CONFIG at the CLI
    defaults) on the synthetic scene, as chip_smoke's reference phase builds
    it: (opt, field, seeded init params, train dataset, flow cache)."""
    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    opt = get_arg_parser().parse_args(["--config", str(ROOT / cs.REFERENCE_CONFIG)])
    with tempfile.TemporaryDirectory() as root:
        scale, offset = generate_synthetic_sequence(f"{root}/scene", **cs.SCENE)
        opt.near_lidar *= scale
        opt.far_lidar *= scale
        field = LiDAR4DField(build_model_config(opt), device=dev)
        params = field.init(seed=cs.SEED)
        ds, cache = cs.scene_steps(f"{root}/scene", scale, offset, opt.flow_cloud_max_points)
    return opt, field, params, ds, cache


def reference_cases(setup, kernels, dev):
    """(kind, kernel, label, run, plain, library, bound ms) of every call of
    `kernels` in one reference step (chip_smoke.record_reference_step, the
    seeded init's signal parameters) and in the middle 4,096-ray chunk of a
    rendered 66 x 1030 frame (render_rays at the frame time chip_smoke's
    reference phase renders), each on its own recorded arguments; a
    backward call's plain version is the one with tables and cotangents in
    float64 (chip_smoke.recorded_cases)."""
    from lidar4d_tpu_torch.interop import tree_to_torch
    from lidar4d_tpu_torch.models.renderer import frame_chunk, render_rays
    from lidar4d_tpu_torch.sim.simulator import build_novel_rays

    opt, field, params, ds, cache = setup
    signal_t = tree_to_torch(cs.signal_params(params), dev)
    step_calls, _ = cs.record_reference_step(field, signal_t, ds, cache, opt, dev)
    rays_o, rays_d = build_novel_rays(np.eye(4, dtype=np.float32)[None], opt.H_lidar,
                                      opt.W_lidar, opt.fov_lidar)
    chunk = frame_chunk(field)
    mid = -(-opt.H_lidar * opt.W_lidar // chunk) // 2
    o, d = (torch.as_tensor(r[0, mid * chunk:(mid + 1) * chunk], device=dev)
            for r in (rays_o, rays_d))
    frame_calls = []
    with cs.recording_kernel_calls(frame_calls), torch.no_grad():
        render_rays(field, signal_t, o, d, np.float32(cs.REFERENCE_FRAME_T),
                    num_steps=opt.num_steps, with_aux=False)
    cases = []
    for kind, calls in (("reference step", step_calls), ("reference frame chunk", frame_calls)):
        calls = [c for c in calls if c[0] in kernels]
        for name, args, _ in calls:
            if name == "hash_grid_bwd":
                print(json.dumps({"kernel": name, "case": cs.call_label(cs.encoder_names(field),
                                                                        name, args),
                                  "row_updates": row_updates(args[0], args[1])}), flush=True)
        for case, exact, _ in cs.recorded_cases(field, calls):
            name, label, run, plain, _, nb, flops = case[:7]
            cases.append((kind, name, label, run, exact or plain, None,
                          cs.bound_ms(nb, flops)[0]))
    return cases


def row_updates(spec, xs):
    """Corner-row changes along the points of each variant, level and
    corner: the global reductions a backward kernel that keeps a corner's
    sum while its row stays the same must issue at least (its lane groups
    break the runs a little more often)."""
    total = 0
    for x in xs:
        idx, _ = ho._all_indices(spec, x)                # [L, 2^d, N]
        total += idx.shape[0] * idx.shape[1] + int((idx[..., 1:] != idx[..., :-1]).sum())
        del idx
    return total


def reference_end_to_end(setup, base, dev):
    """The reference step and frame on the earlier design's hash kernels and
    on the current ones, in turns (earlier, current, current, earlier):
    REFERENCE_WARMUP + REFERENCE_TIMED train steps from the seeded init and
    a profiled one (chip_smoke.train: ms/step, device busy ms, idle share),
    then one 66 x 1030 frame through Simulator.render with the U-Net refine
    (s/frame of the second of two renders, as chip_smoke's reference phase
    renders it). One JSON line a turn; returns the means by design."""
    from lidar4d_tpu_torch.interop import tree_to_torch
    from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays

    opt, field, params, ds, cache = setup
    rays_o, rays_d = build_novel_rays(np.eye(4, dtype=np.float32)[None], opt.H_lidar,
                                      opt.W_lidar, opt.fov_lidar)
    times = np.array([cs.REFERENCE_FRAME_T], np.float32)
    turns = {"baseline": [], "current": []}
    for design in ("baseline", "current", "current", "baseline"):
        with baseline(base if design == "baseline" else {}), \
                tempfile.TemporaryDirectory() as ws:
            run = cs.train(field, copy.deepcopy(params), ds, cache, opt, dev,
                           cs.REFERENCE_WARMUP, cs.REFERENCE_TIMED, what=f"reference ({design})")
            sim = Simulator("lidar4d", opt, field, tree_to_torch(cs.signal_params(params), dev),
                            workspace=ws, use_refine=True, H_lidar=opt.H_lidar,
                            W_lidar=opt.W_lidar, device=dev)
            seconds = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    sim.render(rays_o, rays_d, times, save_pc=False, save_img=False,
                               save_video=False)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        line = {"design": design, "ms_per_step": run["ms_per_step"],
                "busy_ms": run["profile"]["busy_ms"], "idle_share": run["profile"]["idle_share"],
                "wall_ms_profiled": run["profile"]["wall_ms"],
                "hash_device_ms": {k: run["profile"]["device_ms"][k]
                                   for k in ("hash_grid_fwd", "hash_grid_bwd")},
                "s_per_frame": seconds[1], "s_first_frame": seconds[0]}
        print(json.dumps(line), flush=True)
        turns[design].append(line)
        torch.cuda.empty_cache()
    return {design: {k: sum(t[k] for t in lines) / len(lines)
                     for k in ("ms_per_step", "busy_ms", "idle_share", "s_per_frame")}
            for design, lines in turns.items()}


def timed_turns(run, base, variants):
    """Device ms of run() in turns: the earlier design, the current one,
    each variant, the current one, each variant in reverse, the earlier
    design. Returns (current ms, earlier ms, {variant: ms}, the turns)."""
    turns = []
    with baseline(base):
        turns.append(cs.cuda_ms(run, ITERS))
    order = [None, *variants, None, *reversed(variants)]
    times = {}
    for label in order:
        with variant(variants.get(label, {})):
            t = cs.cuda_ms(run, ITERS)
        times.setdefault(label, []).append(t)
        turns.append(t)
    with baseline(base):
        turns.append(cs.cuda_ms(run, ITERS))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    return mean.pop(None), (turns[0] + turns[-1]) / 2, mean, turns


def run_cases(kind, cases, base, sums, variants):
    for name, label, run, plain, library, bound, *zero_check in cases:
        before = collections.Counter(_cuda.ROUTE_LAUNCHES)
        err, cancelled = rel_err(run, plain, *zero_check)
        paths = sorted({r for (k, r) in _cuda.ROUTE_LAUNCHES - before if k == name})
        line = {"route": kind, "kernel": name, "case": label, "max_rel": err}
        if paths:
            line["path"] = "+".join(paths)
        if cancelled is not None:
            line["float32_cancellations"] = cancelled
        if not err <= RTOL[name]:
            raise AssertionError(f"{name} {label}: max_rel {err} > {RTOL[name]}")
        with baseline(base):
            line["baseline_max_rel"] = rel_err(run, plain)[0]
        for v, settings in variants.items():
            with variant(settings):
                before = collections.Counter(_cuda.ROUTE_LAUNCHES)
                v_err = rel_err(run, plain)[0]
                v_paths = sorted({r for (k, r) in _cuda.ROUTE_LAUNCHES - before if k == name})
            if not v_err <= RTOL[name]:
                raise AssertionError(f"{name} {label} under {v}: max_rel {v_err} > {RTOL[name]}")
            line[f"{v}_max_rel"] = v_err
            line[f"{v}_path"] = "+".join(v_paths)
        ms, base_ms, v_ms, turns = timed_turns(run, base, variants)
        line.update(ms=ms, baseline_ms=base_ms, turns=turns)
        line.update({f"{v}_ms": t for v, t in v_ms.items()})
        if library is not None:
            line["library_ms"] = cs.cuda_ms(library, ITERS)
        if bound is not None:
            line["bound_ms"] = bound
        print(json.dumps(line), flush=True)
        s = sums.setdefault(f"{kind} {name}", {"calls": 0, "ms": 0.0, "baseline_ms": 0.0})
        s["calls"] += 1
        for k, val in line.items():
            if k.endswith("_ms") or k == "ms":
                s[k] = s.get(k, 0.0) + val
        torch.cuda.empty_cache()


MODULES = {"ho": ho, "po": po}


def parse_setting(item):
    """`MODULE.NAME=VALUE` -> (module, name, value), for a launch constant
    that exists."""
    key, value = item.split("=", 1)
    mod, name = key.split(".", 1)
    if mod not in MODULES or not hasattr(MODULES[mod], name):
        raise SystemExit(f"{item}: no such launch constant")
    return MODULES[mod], name, ast.literal_eval(value)


def parse_variants(items):
    """`LABEL=MODULE.NAME=VALUE[;...]` -> {label: [(module, name, value)]}."""
    variants = {}
    for item in items:
        label, settings = item.split("=", 1)
        variants[label] = [parse_setting(x) for x in settings.split(";")]
    return variants


@contextlib.contextmanager
def variant(settings):
    with contextlib.ExitStack() as stack:
        for mod, name, value in settings:
            stack.enter_context(patched(mod, **{name: value}))
        yield


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline_csrc")
    ap.add_argument("--cases", default="encoders")
    ap.add_argument("--commit", default=None,
                    help="the commit BASELINE_CSRC holds (default: the one the first case "
                         "kind was redesigned against)")
    ap.add_argument("--set", action="append", default=[], dest="settings")
    ap.add_argument("--variant", action="append", default=[], dest="variants")
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
    for item in args.settings:
        mod, name, value = parse_setting(item)
        setattr(mod, name, value)
        print(f"set {item.split('=', 1)[0]} = {value!r}", flush=True)
    variants = parse_variants(args.variants)
    _, log = _cuda.build()
    _cuda.library()
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    kinds = args.cases.split(",")
    commit = args.commit or DEFAULT_COMMIT[kinds[0]]
    if commit not in CASE_KERNELS or not set(kinds) <= set(CASE_KERNELS[commit]):
        raise SystemExit(f"--cases {args.cases} --commit {commit}: not among "
                         f"{ {c: sorted(k) for c, k in CASE_KERNELS.items()} }")
    kernels = CASE_KERNELS[commit]
    base = baseline_wrappers(build_baseline(args.baseline_csrc, commit), commit)
    print(f"baseline: commit {commit} ({args.baseline_csrc}); variants "
          f"{ {k: [f'{m.__name__}.{n}={v!r}' for m, n, v in s] for k, s in variants.items()} }",
          flush=True)

    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.models.renderer import render_frames_staged

    sums = {}
    if "reference" in kinds or "reference-step" in kinds:
        setup = reference_setup(dev)
        if "reference" in kinds:
            for kind, *case in reference_cases(setup, kernels["reference"], dev):
                with torch.no_grad():
                    run_cases(kind, [case], base, sums, variants)
            torch.cuda.empty_cache()
        if "reference-step" in kinds:
            sums["reference step and frame"] = reference_end_to_end(setup, base, dev)
        del setup
        torch.cuda.empty_cache()
    opt = get_arg_parser().parse_args(["--config", str(ROOT / cs.CONFIG)])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=cs.SEED)
    with torch.no_grad():
        if "render" in kinds:
            chunk = inspect.signature(render_frames_staged).parameters["chunk"].default
            for samples in (opt.num_coarse, opt.num_fine):
                run_cases("render chunk",
                          render_cases(field, params, opt, dev, chunk * samples, chunk), base,
                          sums, variants)
        if "train" in kinds or "encoders" in kinds:
            with tempfile.TemporaryDirectory() as root:
                ds, cache, scale, _ = cs.make_scene(root)
            tfield = cs.train_field(field, scale)
        if "encoders" in kinds:
            if args.trained:
                with torch.enable_grad():
                    cs.train(tfield, params, ds, cache, opt, dev)
            run_cases("encoders", encoder_cases(tfield, params, ds, opt, dev), base, sums,
                      variants)
        if "train" in kinds:
            for route in ("fact", "classic"):
                with cs.onehot_variant(route):
                    run_cases(route, train_cases(tfield, params, ds, cache, opt, dev,
                                                 route == "classic", kernels["train"]),
                              base, sums, variants)
    print(smi)
    print(json.dumps({"commit": commit, "settings": args.settings, "variants": args.variants,
                      "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
