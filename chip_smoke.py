#!/usr/bin/env python3
"""Drive lidar4d_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints a start line):
  env      torch / CUDA versions and the card's name and power limit;
  build    compile the CUDA kernels (one nvcc call, first use builds
           lidar4d_tpu_torch/_build/);
  kernels  hold every forward kernel against its plain PyTorch version on
           the card at every flagship shape, at the point counts of the
           render's density calls (one 16,384-ray chunk: 128 coarse and 256
           fine samples per ray) and on 65,536 points, and time both;
  slice    build the flagship field (configs/kitti360_4950_tpu.txt) with the
           port's seeded init; check a 256-ray render with O(0.1-1) tables
           against the plain versions on the CPU, with bfloat16 and with
           float32 MLPs, and show that a one-row / one-pixel read fault in any
           kernel would move it well past the tolerance; then render 2 novel
           frames at 66x1030 through Simulator.render with the U-Net refine,
           counting kernel launches, and profile one frame;
  scene    write the synthetic 66x1030x51 scene (seed 0) to a temporary
           directory and build the flow-loss cache (at most 65,536 points a
           frame) for the frames the train steps touch and their +-2
           neighbours;
  train-kernels  hold every forward and backward kernel against its plain
           version at the train step's per-call sizes (131,072 and 262,144
           points along the step's 1,024 training rays, the flow loss's
           cloud and ground points), and plane_bilinear_vjp at the sizes of
           Planes4D.__call__ on the fine call's 262,144 points (the four
           scales' time planes [3, 8, 8, S], a per-ray time); time kernel,
           plain version and the PyTorch call with the same function;
  train    one flagship train step on the card against the same step on the
           CPU (O(0.1-1) tables, float32 MLPs, fewer rays): loss, every
           gradient leaf, post-step parameters, once with hierarchical
           sampling and once with uniform sampling (no sample_pdf, so the
           gap is the kernels' and the card's float32 rounding alone); then
           2 warm-up and 5 timed flagship steps (1,024 rays, 128 + 256
           samples, flow loss) with their losses, ms/step, train rays/s,
           peak memory and kernel launches per step; and one step under
           torch.profiler;
  encoders Planes4D.__call__ of the flagship field on 262,144 points warped
           by the flagship flow net, at a per-ray time that includes the
           frame times 0 and 1: forward, then backward into every plane and
           every flow-net parameter, on the kernels and again on the plain
           versions on the card, compared;
  classic  under hash_onehot.ONEHOT_VARIANT = "classic" (the reference's
           A/B switch): the classic route's hash_grid cases at the train
           step's per-call sizes, one classic step against one fact step on
           the card (uniform sampling, float32 MLPs, the classic step on the
           fact step's ReLU masks), then 1 warm-up and 3 timed flagship
           steps with ms/step, losses and launches per step, and one step
           under torch.profiler.

The kernels line (the line before the device's name) is a JSON object with
each kernel's numbers. For the six kernels of the train step they are taken
at its per-call sizes: ms, plain_ms, library_ms and bound_ms are sums over
the calls of one flagship train step, and launches the count over the 7
train steps. For plane_bilinear_vjp they are sums over the four launches of
one Planes4D.__call__ backward, and launches the encoders phase's count.
The classic phase's own line gives rows 1-2 (the classic one-hot route):
hash_grid_fwd and hash_grid_bwd summed over one classic step, and their
launches over the classic steps. The last line is {"ok": true, "device":
{...}}. Any failure exits non-zero before either is printed. Imports
nothing of JAX.
"""

import contextlib
import copy
import dataclasses
import functools
import inspect
import json
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = "configs/kitti360_4950_tpu.txt"
EXTRA_POINTS = 65536           # a small extra case besides the render's point counts
SEED = 0
SIGNAL_SEED = 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
KERNEL_RTOL = 1e-6             # same gathers, same order: only FMA rounding differs
GRAD_RTOL = 1e-4               # atomics add in another order than the plain scatter
# small render, card vs CPU, by MLP precision: about 10x the gaps measured
# on the H100 (PERF.md). With bfloat16 MLPs the two devices round differently;
# with float32 MLPs only the order of float32 sums differs.
SLICE_ATOL = {
    "bfloat16": {"depth_lidar": 3e-4, "image_lidar": 1.5e-3},
    "float32": {"depth_lidar": 1e-5, "image_lidar": 6e-4},
}
FAULT_MARGIN = 10              # a one-row / one-pixel read fault must move a
                               # float32 render by this many times its tolerance
SMALL_RAYS = 256
# train phase: the bench's synthetic scene and flagship step (bench.py)
SCENE = dict(sequence_id="9000", num_frames=51, H=66, W=1030, seed=0)
FOV = (2.0, 26.9)
TRAIN_RAYS = 1024
LR, ITERS = 1e-2, 30000
FLOW_MAX_POINTS = 65536
STEP_FRAMES = 3                # the steps cycle over the first 3 train frames
WARMUP, TIMED = 2, 5
CHECK_RAYS = 256               # card vs CPU step
# card vs CPU step, float32 MLPs, O(0.1-1) tables: relative tolerance of the
# loss and of each gradient leaf by top-level group, about 10x the gaps
# measured on an H100 (PERF.md): loss 4.4e-7; gradients flow 1.0e-3,
# hash 1.7e-3, planes 2.6e-3, sigma 3.7e-4, intensity 3.6e-4, raydrop 8.6e-5.
# The atomics and the card's float32 rounding move the coarse weights, so
# the fine samples sit a little elsewhere on the two devices.
STEP_RTOL = 5e-6
STEP_GRAD_RTOL = {"flow": 1e-2, "hash": 2e-2, "planes": 3e-2, "sigma": 4e-3,
                  "intensity": 4e-3, "raydrop": 1e-3}
SIGN_FLOOR = 10                # post-step params compared where |g| > this x tol x max|g|
UNIFORM_STEPS = 128            # uniform sampling of the checks below
# The checks below use uniform sampling and float32 MLPs; tolerances are
# relative, of the loss and of each gradient leaf by group, about 10x the
# gaps measured on an H100 (PERF.md). Card vs CPU, uniform sampling: loss
# 2.8e-7; gradients flow 1.4e-3, hash 3.8e-3, planes 1.8e-2, sigma 1.1e-3,
# intensity 9.0e-4, raydrop 3.8e-4. The same gap with every kernel swapped
# for its plain version on the card, so it is the two devices' float32
# arithmetic, not the kernels: it appears across the MLPs' backward, whose
# ReLU gates can open on one device and not on the other where a
# pre-activation sits within float32 rounding of 0.
UNIFORM_STEP_RTOL = 3e-6
UNIFORM_STEP_GRAD_RTOL = {"flow": 1.5e-2, "hash": 4e-2, "planes": 0.2, "sigma": 1.2e-2,
                          "intensity": 1e-2, "raydrop": 4e-3}
# the card's kernels vs the card's plain versions over one step: loss 9.3e-8;
# gradients flow 7.2e-5, hash 6.6e-7, planes 1.9e-6, sigma 2.1e-7,
# intensity 3.2e-7, raydrop 1.5e-7. This is the check that holds the
# kernels, the backward ones included, inside a whole step.
KERNEL_STEP_RTOL = 1e-6
KERNEL_STEP_GRAD_RTOL = {"flow": 8e-4, "hash": 8e-6, "planes": 2e-5, "sigma": 3e-6,
                         "intensity": 4e-6, "raydrop": 2e-6}
# classic vs fact on the card: loss 0; gradients at most 3.3e-7 over two
# runs (flow 1.9e-7 then 3.3e-7, every other group <= 2.3e-7): the order of
# float32 sums alone (the fold, and atomics that add in another order). The
# classic step runs on the fact step's ReLU masks: one hidden pre-activation
# within rounding of 0 whose sign differs between the two moves a gradient
# leaf by up to 1.3e-4 (float32_mlps_sharing_relu_masks)
CLASSIC_STEP_RTOL = 1e-6
CLASSIC_GRAD_RTOL = {"flow": 4e-6, "hash": 4e-6, "planes": 4e-6, "sigma": 4e-6,
                     "intensity": 4e-6, "raydrop": 4e-6}
CLASSIC_WARMUP, CLASSIC_TIMED = 1, 3
FRAME_TIMES = 16               # rays whose time is a frame time k / (num_frames - 1)
ENCODER_FLOW_T = 0.3           # the flow net's time in the encoders phase


def phase(name):
    print(f"[phase] {name} start {time.strftime('%H:%M:%S')}", flush=True)


def cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over `iters` runs, by CUDA events,
    after a warm-up. The runs are queued behind a device-side sleep so that
    the host's launch overhead does not open gaps between them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def chunk_points(rays_o, rays_d, near, far, bound, n_samples):
    """A density call's points of one ray chunk, as the field sees them:
    n_samples evenly spaced in [near, far] along each ray, clamped to the
    scene box and mapped to [0, 1]^3. [rays * n_samples, 3]."""
    z = torch.linspace(near, far, n_samples, device=rays_o.device)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[:, None]
    return ((torch.clamp(xyz, -bound, bound) + bound) / (2 * bound)).reshape(-1, 3)


def kernel_cases(field, params, gen, pts, classic=False):
    """(kernel, label, run, plain, library, bytes, flops) at every flagship
    shape, with the variant / plane counts of one density call on pts [N, 3].

    The hash encodes take pts clamped to [0, 1], as the field clamps them; the
    planes take pts as they are. The hash tables are the field's; the 1-D
    dynamic planes are drawn at random, since the init's time planes are ones
    and would hide an index fault. classic=True gives the hash encodes of the
    classic route alone (ONEHOT_VARIANT "classic": the flow grid and the
    dynamic planes at F = 8, one launch per dynamic variant)."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho
    from lidar4d_tpu_torch.ops import plane_onehot as po
    from lidar4d_tpu_torch.ops.hash_enc import lagrange_weights

    dev = pts.device
    x01 = torch.clamp(pts, 0.0, 1.0)
    pairs = ((0, 1), (0, 2), (1, 2))
    cases = []

    def hash_case(label, spec, tables, xs):
        xs = xs.contiguous()
        out = ho.hash_grid_fwd(spec, tables, xs)
        levels = ho._level_table(spec, dev)
        flops = 2 * xs.shape[0] * xs.shape[1] * spec.n_levels * (1 << spec.n_dims) \
            * spec.n_features
        cases.append(("hash_grid_fwd", label, lambda: ho.hash_grid_fwd(spec, tables, xs),
                      lambda: ho.hash_grid_fwd_plain(spec, tables, xs), None,
                      nbytes(tables, xs, levels, out), flops))

    enc = field.hash_encoder
    hash_case("static hash 3D L=6 F=8", enc.static_spec, params["hash"]["static"][None],
              x01[None])
    planes = field.planes_encoder
    si = len(planes.multiscale_res) - 1
    reso = planes._scale_reso(planes.multiscale_res[si])[0]
    hash_case(f"hashed static plane {reso}^2 x3", planes._hash_spec(reso),
              torch.stack([params["planes"][si][ci] for ci in (0, 1, 3)]),
              torch.stack([x01[:, list(c)] for c in pairs]))
    flow = field.flow_net
    w = torch.from_numpy(lagrange_weights(0.3, flow.num_basis)).to(dev)
    fp = flow.n_features_per_level // flow.num_basis
    if classic:
        hash_case("flow grid 3D L=4 F=8", flow.grid_spec, params["flow"]["grid"][None],
                  x01[None])
    else:
        hash_case("flow grid 3D L=4 F'=2 (folded)",
                  ho._folded_spec(flow.grid_spec, flow.num_basis),
                  ho._fold_table(params["flow"]["grid"], w, fp)[None], x01[None])
    for p in range(3):
        spec = enc.dynamic_spec(p)
        tabs = torch.stack([enc._blended_table(params["hash"], p, t) for t in (0.3, 0.32, 0.28)])
        if classic:
            for v in range(3):
                hash_case(f"dynamic plane {p} 2D L=6 F=8 rows {spec.table_sizes[0]} variant {v}",
                          spec, tabs[v:v + 1], x01[None, :, list(pairs[p])])
            continue
        folded = torch.stack([ho._fold_table(t, w, spec.n_features // enc.num_basis)
                              for t in tabs])
        hash_case(f"dynamic plane {p} 2D L=6 F'=2 rows {spec.table_sizes[0]} V=3 (folded)",
                  ho._folded_spec(spec, enc.num_basis), folded,
                  x01[:, list(pairs[p])].expand(3, -1, -1))
    if classic:
        return cases

    for si, planes_s in enumerate(params["planes"]):
        group = [planes_s[ci] for ci in (0, 1, 3)]
        if group[0].ndim != 3:
            continue
        grid = torch.stack(group).contiguous()
        q2 = torch.stack([pts[:, list(c)] for c in pairs])         # [P, N, 2]
        out = po.plane_bilinear(grid, q2)
        lib_grid = (2.0 * q2 - 1.0)[:, None]                       # [P, 1, N, 2]
        cases.append((
            "plane_bilinear_fwd", f"dense static planes {tuple(grid.shape)}",
            lambda g=grid, q=q2: po.plane_bilinear(g, q),
            lambda g=grid, q=q2: po.plane_bilinear_plain(g, q),
            lambda g=grid, q=lib_grid: torch.nn.functional.grid_sample(
                g, q, mode="bilinear", padding_mode="border", align_corners=True),
            nbytes(grid, q2, out), 2 * 4 * out.numel()))

    x = pts.T.repeat(3, 1).contiguous()                             # [V * 3, N]
    for si, planes_s in enumerate(params["planes"]):
        c, s = planes_s[2].shape[0], planes_s[2].shape[2]
        grid = 0.1 + 0.9 * torch.rand(9, c, s, generator=gen, device=dev)
        out = po.plane_linear(grid, x)
        lib_in = grid[:, :, None, :]                                # [P, C, 1, S]
        lib_grid = torch.stack([2.0 * x - 1.0, torch.zeros_like(x)], -1)[:, None]
        cases.append((
            "plane_linear_fwd", f"dynamic planes [9, {c}, {s}]",
            lambda g=grid, q=x: po.plane_linear(g, q),
            lambda g=grid, q=x: po.plane_linear_plain(g, q),
            lambda g=lib_in, q=lib_grid: torch.nn.functional.grid_sample(
                g, q, mode="bilinear", padding_mode="border", align_corners=True),
            nbytes(grid, x, out), 2 * 2 * out.numel()))
    return cases


def signal_params(params):
    """A numpy copy of `params` whose hash and flow tables and time planes carry
    O(0.1-1) values. The seeded init draws hash and flow tables from
    U(-1e-4, 1e-4) and sets the time planes to ones, so with it a faulty kernel
    would barely move a render."""
    from lidar4d_tpu_torch.interop import tree_to_numpy

    rng = np.random.default_rng(SIGNAL_SEED)
    p = tree_to_numpy(params)

    def uni(a, lo, hi):
        return rng.uniform(lo, hi, a.shape).astype(np.float32)

    for k in p["hash"]:
        p["hash"][k] = uni(p["hash"][k], -0.5, 0.5)
    p["flow"]["grid"] = uni(p["flow"]["grid"], -0.5, 0.5)
    for planes in p["planes"]:
        for ci in (2, 4, 5):
            planes[ci] = uni(planes[ci], 0.5, 1.5)
    return p


FAULTS = ("hash_grid_fwd static hash", "hash_grid_fwd dynamic hash",
          "hash_grid_fwd flow grid", "hash_grid_fwd hashed plane",
          "plane_bilinear_fwd dense planes", "plane_linear_fwd time planes")


def faulted(p, fault):
    """A copy of numpy params `p` that makes the plain versions read as a kernel
    with the given fault would: one row over in a hash table, one pixel over in
    a plane (the inputs of that kernel rolled by one)."""
    q = copy.deepcopy(p)
    if fault == "hash_grid_fwd static hash":
        q["hash"]["static"] = np.roll(q["hash"]["static"], 1, 0)
    elif fault == "hash_grid_fwd dynamic hash":
        for k in ("dynamic_0", "dynamic_1", "dynamic_2"):
            q["hash"][k] = np.roll(q["hash"][k], 1, 0)
    elif fault == "hash_grid_fwd flow grid":
        q["flow"]["grid"] = np.roll(q["flow"]["grid"], 1, 0)
    for planes in q["planes"]:
        for ci in (0, 1, 3):
            if fault == "hash_grid_fwd hashed plane" and planes[ci].ndim == 2:
                planes[ci] = np.roll(planes[ci], 1, 0)
            if fault == "plane_bilinear_fwd dense planes" and planes[ci].ndim == 3:
                planes[ci] = np.roll(planes[ci], 1, -1)
        if fault == "plane_linear_fwd time planes":
            for ci in (2, 4, 5):
                planes[ci] = np.roll(planes[ci], 1, -1)
    return q


def check_kernels(field, params, rays_o, rays_d, opt, dev):
    """Hold every kernel against its plain version and time kernel, plain
    version and library call, at one ray chunk's density calls (rays_o /
    rays_d: one frame's rays) and on EXTRA_POINTS random points. Returns, per
    kernel, the max error over all cases and the sums of times and of the
    bound over the ray chunk's cases."""
    from lidar4d_tpu_torch.models.renderer import render_frames_staged

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # the render's density calls: one chunk of rays x coarse, then x fine samples
    ray_chunk = inspect.signature(render_frames_staged).parameters["chunk"].default
    main_points = (ray_chunk * opt.num_coarse, ray_chunk * opt.num_fine)
    rays = [torch.as_tensor(r[:ray_chunk], device=dev) for r in (rays_o, rays_d)]
    summary = {}
    with torch.no_grad():
        for n in (EXTRA_POINTS, *main_points):
            main = n in main_points
            if main:
                pts = chunk_points(*rays, field.cfg.near_lidar, field.cfg.far_lidar,
                                   field.cfg.bound, n // ray_chunk)
            else:
                pts = -0.05 + 1.1 * torch.rand(n, 3, generator=gen, device=dev)
            print(f"  {n} points, " + ("one ray chunk's density call" if main
                                       else "uniform in [-0.05, 1.05]^3"), flush=True)
            for case in kernel_cases(field, params, gen, pts):
                check_case(case, summary, main, 10 if main else 20, 2 if main else 5)
            torch.cuda.empty_cache()
    return finish(summary)


def finish(summary):
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound_ms(s.pop("bytes"), s.pop("flops"))
    return summary


def check_case(case, summary, main, iters, plain_iters):
    """Hold one kernel case against its plain version (each output within
    KERNEL_RTOL, GRAD_RTOL for a backward kernel, of the plain output's
    largest magnitude), time kernel, plain version and library call, and add
    the case to `summary` (times and bound only when `main`)."""
    name, label, run, plain, library, nb, flops = case
    rtol = GRAD_RTOL if name.endswith(("_bwd", "_vjp")) else KERNEL_RTOL
    got, want = run(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    rel = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
              for g, w in zip(got, want))
    del got, want
    ms = cuda_ms(run, iters)
    plain_ms = cuda_ms(plain, plain_iters)
    lib_ms = cuda_ms(library, iters) if library is not None else None
    b_ms, b_by = bound_ms(nb, flops)
    print(f"  {name:18s} {label:55s} max_abs {err:.3e} max_rel {rel:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'} "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    if not rel <= rtol:
        raise AssertionError(f"{name} {label}: max_rel {rel} > {rtol}")
    s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      bytes=0, flops=0, library_ms=None))
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if main:
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bytes"] += nb
        s["flops"] += flops
        if lib_ms is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + lib_ms


def backward_cases(field, params, gen, pts, classic=False):
    """(kernel, label, run, plain, library, bytes, flops) of every backward
    kernel at every flagship shape, with the variant / plane counts of one
    density call on pts [N, 3] of a train step and random cotangents;
    classic=True gives the classic route's hash encodes alone."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho
    from lidar4d_tpu_torch.ops import plane_onehot as po

    dev = pts.device
    n = pts.shape[0]
    x01 = torch.clamp(pts, 0.0, 1.0)
    pairs = ((0, 1), (0, 2), (1, 2))
    cases = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def hash_case(label, spec, xs, n_tables):
        xs = xs.contiguous()
        cot = randn(xs.shape[0], n, spec.n_output_dims)
        levels = ho._level_table(spec, dev)
        out = torch.empty(n_tables, spec.n_rows, spec.n_features, device=dev)
        flops = 2 * xs.shape[0] * n * spec.n_levels * (1 << spec.n_dims) * spec.n_features
        cases.append(("hash_grid_bwd", label,
                      lambda: ho.hash_grid_bwd(spec, xs, cot, n_tables),
                      lambda: ho.hash_grid_bwd_plain(spec, xs, cot, n_tables), None,
                      nbytes(xs, cot, levels, out), flops))

    enc = field.hash_encoder
    hash_case("static hash 3D L=6 F=8", enc.static_spec, x01[None], 1)
    planes = field.planes_encoder
    si = len(planes.multiscale_res) - 1
    reso = planes._scale_reso(planes.multiscale_res[si])[0]
    hash_case(f"hashed static plane {reso}^2 x3", planes._hash_spec(reso),
              torch.stack([x01[:, list(c)] for c in pairs]), 3)
    flow = field.flow_net
    if classic:
        hash_case("flow grid 3D L=4 F=8", flow.grid_spec, x01[None], 1)
    else:
        hash_case("flow grid 3D L=4 F'=2 (folded)",
                  ho._folded_spec(flow.grid_spec, flow.num_basis), x01[None], 1)
    for p in range(3):
        spec = enc.dynamic_spec(p)
        if classic:
            hash_case(f"dynamic plane {p} 2D L=6 F=8 rows {spec.table_sizes[0]} variant 0",
                      spec, x01[None, :, list(pairs[p])], 1)
        else:
            hash_case(f"dynamic plane {p} 2D L=6 F'=2 rows {spec.table_sizes[0]} variant 0 of 3",
                      ho._folded_spec(spec, enc.num_basis), x01[None, :, list(pairs[p])], 3)
    if classic:
        return cases

    aten_gs_bwd = torch.ops.aten.grid_sampler_2d_backward
    for planes_s in params["planes"]:
        group = [planes_s[ci] for ci in (0, 1, 3)]
        if group[0].ndim != 3:
            continue
        grid = torch.stack(group).contiguous()
        hw = tuple(grid.shape[2:])
        q2 = torch.stack([pts[:, list(c)] for c in pairs]).contiguous()   # [P, N, 2]
        cot = randn(3, grid.shape[1], n)
        lib_cot = cot[:, :, None, :]                                      # [P, C, 1, N]
        lib_grid = (2.0 * q2 - 1.0)[:, None]                              # [P, 1, N, 2]
        cases.append((
            "plane_bilinear_bwd", f"dense static planes {tuple(grid.shape)}",
            lambda q=q2, c=cot, hw=hw: po.plane_bilinear_bwd(q, c, hw),
            lambda q=q2, c=cot, hw=hw: po.plane_bilinear_bwd_plain(q, c, hw),
            lambda g=grid, q=lib_grid, c=lib_cot: aten_gs_bwd(
                c, g, q, 0, 1, True, [True, False]),
            nbytes(q2, cot, grid), 2 * 4 * cot.numel()))

    x = pts.T.repeat(3, 1).contiguous()                                   # [V * 3, N]
    for planes_s in params["planes"]:
        c, s = planes_s[2].shape[0], planes_s[2].shape[2]
        grid = 0.1 + 0.9 * torch.rand(9, c, s, generator=gen, device=dev)
        cot = randn(9, n, c)
        lib_in = grid[:, :, None, :]                                      # [P, C, 1, S]
        lib_grid = torch.stack([2.0 * x - 1.0, torch.zeros_like(x)], -1)[:, None]
        lib_cot = cot.transpose(1, 2)[:, :, None, :].contiguous()         # [P, C, 1, N]
        cases.append((
            "plane_linear_bwd", f"dynamic planes [9, {c}, {s}] lead 3",
            lambda g=grid, q=x, cc=cot: po.plane_linear_bwd(g, q, cc, 3),
            lambda g=grid, q=x, cc=cot: po.plane_linear_bwd_plain(g, q, cc, 3),
            lambda g=lib_in, q=lib_grid, cc=lib_cot: aten_gs_bwd(
                cc, g, q, 0, 1, True, [True, True]),
            nbytes(grid, x, cot, grid, x), 4 * cot.numel() + 3 * cot.numel() * 6 // 9))
    return cases


def per_ray_times(n_rays, samples, num_frames, gen, dev):
    """[n_rays * samples, 1] per-sample times, one per ray (the samples of a
    ray share their time): U(0, 1), and the first FRAME_TIMES rays at frame
    times k / (num_frames - 1), 0 and 1 among them, where the time planes'
    v = t * (T - 1) can be an exact integer."""
    t = torch.rand(n_rays, generator=gen, device=dev)
    k = torch.linspace(0, num_frames - 1, FRAME_TIMES, device=dev).round()
    t[:FRAME_TIMES] = k / (num_frames - 1)
    return t.repeat_interleave(samples)[:, None]


def vjp_cases(params, gen, pts, t):
    """plane_bilinear_vjp cases of one Planes4D.__call__ backward on pts
    [N, 3] in [0, 1] at per-sample times t [N, 1]: per scale one launch over
    the three time planes [3, C, T, S] (drawn from U(0.5, 1.5): the init's
    ones would give a zero coordinate gradient)."""
    from lidar4d_tpu_torch.ops import plane_onehot as po

    dev = pts.device
    n = pts.shape[0]
    q = torch.stack([torch.cat([pts[:, [c]], t], -1) for c in range(3)]).contiguous()
    lib_grid = (2.0 * q - 1.0)[:, None]                                   # [P, 1, N, 2]
    aten_gs_bwd = torch.ops.aten.grid_sampler_2d_backward
    cases = []
    for planes_s in params["planes"]:
        c, t_res, s = planes_s[2].shape
        grid = 0.5 + torch.rand(3, c, t_res, s, generator=gen, device=dev)
        cot = torch.randn(3, c, n, generator=gen, device=dev)
        cases.append((
            "plane_bilinear_vjp", f"time planes {tuple(grid.shape)}, per-ray t",
            lambda g=grid, cc=cot: po.plane_bilinear_vjp(g, q, cc),
            lambda g=grid, cc=cot: po.plane_bilinear_vjp_plain(g, q, cc),
            lambda g=grid, cc=cot[:, :, None, :]: aten_gs_bwd(
                cc, g, lib_grid, 0, 1, True, [True, True]),
            nbytes(grid, q, cot, grid, q), 24 * cot.numel()))
    return cases


def flow_loss_cases(field, params, gen, flow_pts, ground_pts, backward, classic=False):
    """The flow loss's two flow-net encodes (a frame's cloud and its ground
    points, each [N, 3] in world units): forward or backward cases, folded
    or (classic) at F = 8."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho
    from lidar4d_tpu_torch.ops.hash_enc import lagrange_weights

    flow = field.flow_net
    if classic:
        spec, tables = flow.grid_spec, params["flow"]["grid"][None]
    else:
        spec = ho._folded_spec(flow.grid_spec, flow.num_basis)
        w = torch.from_numpy(lagrange_weights(0.3, flow.num_basis)).to(flow_pts.device)
        tables = ho._fold_table(params["flow"]["grid"], w, spec.n_features)[None].contiguous()
    levels = ho._level_table(spec, flow_pts.device)
    cases = []
    for label, pts in (("flow loss cloud", flow_pts), ("flow loss ground", ground_pts)):
        bound = field.cfg.bound
        xs = torch.clamp((pts + bound) / (2 * bound), 0.0, 1.0)[None].contiguous()
        n = xs.shape[1]
        flops = 2 * n * spec.n_levels * 8 * spec.n_features
        label = f"{label}: flow grid 3D L=4 " + ("F=8" if classic else "F'=2 (folded)")
        if backward:
            cot = torch.randn(1, n, spec.n_output_dims, generator=gen, device=xs.device)
            cases.append(("hash_grid_bwd", label,
                          lambda xs=xs, c=cot: ho.hash_grid_bwd(spec, xs, c),
                          lambda xs=xs, c=cot: ho.hash_grid_bwd_plain(spec, xs, c), None,
                          nbytes(xs, cot, levels, tables), flops))
        else:
            out = torch.empty(1, n, spec.n_output_dims, device=xs.device)
            cases.append(("hash_grid_fwd", label,
                          lambda xs=xs: ho.hash_grid_fwd(spec, tables, xs),
                          lambda xs=xs: ho.hash_grid_fwd_plain(spec, tables, xs), None,
                          nbytes(tables, xs, levels, out), flops))
    return cases


@contextlib.contextmanager
def mlp_dtype(dtype):
    """Run the field's MLPs in `dtype` (the port's own is bfloat16)."""
    from lidar4d_tpu_torch.models import flow_field, lidar4d
    from lidar4d_tpu_torch.ops.mlp import apply_mlp

    saved = lidar4d.apply_mlp, flow_field.apply_mlp
    lidar4d.apply_mlp = flow_field.apply_mlp = functools.partial(apply_mlp, dtype=dtype)
    try:
        yield
    finally:
        lidar4d.apply_mlp, flow_field.apply_mlp = saved


@contextlib.contextmanager
def float32_mlps_sharing_relu_masks(masks, record):
    """Run the field's MLPs in float32 (as mlp_dtype(torch.float32)), with
    `record` appending every call's hidden ReLU masks (pre-activation > 0) to
    `masks`, else applying masks[i] to the i-th call in place of its own (the
    same calls in the same order). Two steps whose pre-activations differ by
    float32 rounding alone then differentiate the same piecewise-linear MLPs:
    a pre-activation within rounding of 0 that changes sign between them
    would move its sample's whole share of the MLP gradients (on the H100 one
    such sign moved a leaf by up to 1.3e-4 of its largest entry,
    scripts/classic_vs_fact_ties.py). Yields a
    dict whose "flipped" counts the replayed pre-activations whose own sign
    differs from the recorded mask."""
    from lidar4d_tpu_torch.models import flow_field, lidar4d

    calls = iter(masks)
    stats = {"flipped": 0, "masked": 0}

    def apply(params, x):
        layer_masks = [] if record else next(calls)
        if record:
            masks.append(layer_masks)
        h = x.float()
        for li, w in enumerate(params):
            h = h @ w.float()
            if li == len(params) - 1:
                break
            own = h.detach() > 0
            if record:
                layer_masks.append(own)
            elif layer_masks[li].shape != own.shape:
                raise AssertionError(f"MLP call shapes differ: {tuple(own.shape)} after "
                                     f"{tuple(layer_masks[li].shape)}")
            stats["flipped"] += int((own != layer_masks[li]).sum())
            stats["masked"] += own.numel()
            h = h * layer_masks[li]
        return h

    saved = lidar4d.apply_mlp, flow_field.apply_mlp
    lidar4d.apply_mlp = flow_field.apply_mlp = apply
    try:
        yield stats
    finally:
        lidar4d.apply_mlp, flow_field.apply_mlp = saved
    if not record and next(calls, None) is not None:
        raise AssertionError("the replaying step made fewer MLP calls than the recorded one")


def profile_render(sim, rays_o, rays_d, times):
    """Device time by kernel over one frame's render (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False,
                   frame_batch=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows)
    groups = {"hash_grid_fwd": 0.0, "plane_bilinear_fwd": 0.0, "plane_linear_fwd": 0.0,
              "matmul": 0.0, "sort": 0.0, "conv": 0.0, "other": 0.0}
    for key, _, ms in rows:
        low = key.lower()
        group = next((g for g in ("hash_grid_fwd", "plane_bilinear_fwd", "plane_linear_fwd")
                      if g in low), None)
        if group is None:
            group = ("matmul" if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet"))
                     else "sort" if "sort" in low
                     else "conv" if "conv" in low
                     else "other")
        groups[group] += ms
    print(f"  profile 1 frame: wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    print("  device ms by group " + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)


def make_scene(root):
    """The bench's synthetic scene under `root`, its train and refine
    datasets, and the flow cache for the frames the steps touch and their
    +-2 neighbours (every other frame valid = 0). Returns (train dataset,
    cache, scale, seconds by part)."""
    from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
    from lidar4d_tpu_torch.train.flow_cache import build_flow_cache

    t0 = time.perf_counter()
    scale, offset = generate_synthetic_sequence(root, **SCENE)
    t_gen = time.perf_counter() - t0
    kw = dict(root_path=root, sequence_id=SCENE["sequence_id"], scale=scale, offset=offset)
    ds = KITTI360Dataset(split="train", num_rays_lidar=TRAIN_RAYS, **kw)
    refine = KITTI360Dataset(split="refine", **kw)
    n_frames = SCENE["num_frames"]
    touched = {int(round(float(ds.times[i]) * (n_frames - 1))) for i in range(STEP_FRAMES)}
    frames = {f + d for f in touched for d in range(-2, 3) if 0 <= f + d < n_frames}
    random.seed(SEED)
    t0 = time.perf_counter()
    cache = build_flow_cache(refine, scale, n_frames, max_points=FLOW_MAX_POINTS,
                             seed=SEED, frames=frames)
    t_cache = time.perf_counter() - t0
    built = sorted(int(i) for i in np.flatnonzero(cache["valid"]))
    print(f"  scene {SCENE}: scale {scale:.6g}, written in {t_gen:.1f} s; flow cache for "
          f"frames {built} in {t_cache:.1f} s: points {cache['points'].shape}, "
          f"ground {cache['ground'].shape}", flush=True)
    return ds, cache, scale


def train_field(field, scale):
    """The render field's widths with the synthetic scene's near / far
    (bench.py): near = 1 * scale, far = 81 * scale."""
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    cfg = dataclasses.replace(field.cfg, near_lidar=1.0 * scale, far_lidar=81.0 * scale)
    return LiDAR4DField(cfg, device=field.device)


def check_train_kernels(field, params, ds, cache, opt, dev, classic=False):
    """Every forward and backward kernel against its plain version at the
    train step's per-call sizes: the coarse and fine density calls
    (TRAIN_RAYS rays of a train frame x num_coarse / num_fine samples) and
    the flow loss's two flow-net calls; and plane_bilinear_vjp at the fine
    call's points with a per-ray time. Returns the per-kernel summary, sums
    over the calls of one train step (of Planes4D.__call__'s backward for
    plane_bilinear_vjp). classic=True: the classic route's hash encodes
    alone."""
    from lidar4d_tpu_torch.ops.rays import get_lidar_rays

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    frame = ds.frame(0)
    rays = get_lidar_rays(torch.as_tensor(frame["pose"], device=dev), FOV, ds.H_lidar,
                          ds.W_lidar, N=TRAIN_RAYS, generator=gen)
    cfg = field.cfg
    fi = int(round(float(frame["time"]) * (cfg.num_frames - 1)))
    flow_pts = torch.as_tensor(cache["points"][fi], device=dev)
    ground_pts = torch.as_tensor(cache["ground"][fi], device=dev)
    summary = {}
    with torch.no_grad():
        for samples in (opt.num_coarse, opt.num_fine):
            pts = chunk_points(rays["rays_o"], rays["rays_d"], cfg.near_lidar, cfg.far_lidar,
                               cfg.bound, samples)
            print(f"  {pts.shape[0]} points: {TRAIN_RAYS} training rays x {samples} samples",
                  flush=True)
            cases = kernel_cases(field, params, gen, pts, classic) + backward_cases(
                field, params, gen, pts, classic)
            if samples == opt.num_fine and not classic:
                t = per_ray_times(TRAIN_RAYS, samples, cfg.num_frames, gen, dev)
                cases += vjp_cases(params, gen, pts, t)
            for case in cases:
                check_case(case, summary, True, 10, 2)
            torch.cuda.empty_cache()
        print(f"  flow loss: {flow_pts.shape[0]} cloud and {ground_pts.shape[0]} ground points "
              f"(frame {fi})", flush=True)
        for backward in (False, True):
            for case in flow_loss_cases(field, params, gen, flow_pts, ground_pts, backward,
                                        classic):
                check_case(case, summary, True, 10, 2)
    return finish(summary)


def launches_per_step(field, classic=False):
    """Kernel launches of one flagship train step, from the field's shape:
    per density call (two per step) the static hash, the hashed static
    planes (one launch for the three), the flow grid and the dynamic hash
    planes on hash_grid_* (fact: one launch for the three variants of a
    plane; classic: one per variant forward, variant 0 alone backward), each
    dense static scale on plane_bilinear_*, each scale's time planes on
    plane_linear_*; plus the flow loss's two flow-grid encodes, and no
    plane_bilinear_vjp."""
    planes = field.planes_encoder
    n_scales = len(planes.multiscale_res)
    hashed = sum(planes._static_hashed(si, planes._scale_reso(sc))
                 for si, sc in enumerate(planes.multiscale_res))
    per_call = {"hash_grid_fwd": 2 + hashed + (9 if classic else 3),
                "hash_grid_bwd": 2 + hashed + 3,
                "plane_bilinear_fwd": n_scales - hashed, "plane_bilinear_bwd": n_scales - hashed,
                "plane_linear_fwd": n_scales, "plane_linear_bwd": n_scales,
                "plane_bilinear_vjp": 0}
    extra = {"hash_grid_fwd": 2, "hash_grid_bwd": 2}
    return {k: 2 * v + extra.get(k, 0) for k, v in per_call.items()}


def leaf_groups(params):
    """Top-level group of each leaf, in tree order."""
    from lidar4d_tpu_torch.interop import tree_leaves

    return [k for k in sorted(params) for _ in tree_leaves(params[k])]


@contextlib.contextmanager
def onehot_variant(variant):
    """Run under hash_onehot.ONEHOT_VARIANT = variant, restored after."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho

    saved = ho.ONEHOT_VARIANT
    ho.ONEHOT_VARIANT = variant
    try:
        yield
    finally:
        ho.ONEHOT_VARIANT = saved


def step_grads(field, signal, ds, cache, sampling, draws=None):
    """One step's metrics, gradient leaves and post-step leaves (on the host)
    from the numpy params `signal` on the field's device, with `draws` (the
    step's own when None). Returns (metrics, grads, params, draws)."""
    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS)
    state, optim = init_train_state(field, lr=LR, iters=ITERS,
                                    params=tree_to_torch(signal, field.device))
    step = make_train_step(field, optim, loss_cfg, H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV,
                           num_rays=CHECK_RAYS, patch_size=1, seed=SEED, **sampling)
    draws = step.draw() if draws is None else draws
    dd = {k: v.to(field.device) if torch.is_tensor(v) else v for k, v in draws.items()}
    grads, metrics = step.grads(state.params, ds.frame(0), flow_cache_to_device(cache, field.device),
                                dd, 0)
    optim.step(state.params, grads, state.opt_state)
    return ({k: float(v) for k, v in metrics.items()},
            [None if g is None else g.cpu() for g in grads],
            [p.detach().cpu() for p in tree_leaves(state.params)], draws)


def compare_steps(what, field, signal, run_a, run_b, rtol, grad_rtol, post_step):
    """Hold step run_a against run_b (each from `step_grads`): every metric
    within rtol, every gradient leaf within grad_rtol[group] of its largest
    magnitude and, with post_step, the post-step parameters where |g| is
    clear of that tolerance (Adam's first step is lr x sign(g))."""
    from lidar4d_tpu_torch.interop import tree_leaves

    (m_a, g_a, p_a, _), (m_b, g_b, p_b, _) = run_a, run_b
    failures = []
    for k in m_b:
        rel = abs(m_a[k] - m_b[k]) / max(abs(m_b[k]), 1e-30)
        print(f"  {what} {k}: {m_a[k]:.6f} vs {m_b[k]:.6f}, rel {rel:.3e} (tolerance {rtol:g})",
              flush=True)
        if not (np.isfinite(m_a[k]) and rel <= rtol):
            failures.append(f"{what} {k}: {rel} > {rtol}")
    worst, worst_step = {}, 0.0
    labels = tree_leaves(field.param_group_labels(signal))
    for i, (group, lb, a, b, pa, pb, init) in enumerate(zip(
            leaf_groups(signal), labels, g_a, g_b, p_a, p_b, tree_leaves(signal))):
        if b is None or lb == "unet":
            if a is not None and a.abs().max() > 0:
                failures.append(f"{what} leaf {i} ({group}): a gradient on one side alone")
            continue
        scale = b.abs().max().item()
        if scale == 0:
            continue
        rel = (a - b).abs().max().item() / scale
        tol = grad_rtol[group]
        worst[group] = max(worst.get(group, 0.0), rel)
        if not (torch.isfinite(a).all() and rel <= tol):
            failures.append(f"{what} grad leaf {i} ({group}): {rel} > {tol}")
        if not post_step:
            continue
        step_size = LR * (0.1 if lb == "head" else 1.0)
        sure = b.abs() > SIGN_FLOOR * tol * scale
        moved = (pa - pb)[sure].abs().max().item() if sure.any() else 0.0
        worst_step = max(worst_step, moved / step_size)
        if moved > 1e-3 * step_size:
            failures.append(f"{what} post-step leaf {i} ({group}) differs by {moved}")
        if (pa - torch.as_tensor(init)).abs().max().item() > step_size * (1 + 1e-3):
            failures.append(f"{what} post-step leaf {i} ({group}) moved more than lr")
    print(f"  {what} gradients, max relative gap by group: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})
          + f" (tolerances {grad_rtol})" + (
              f"; post-step params where |g| > {SIGN_FLOOR} x tolerance x max|g|: max gap "
              f"{worst_step:.3e} of lr x group multiplier (tolerance 1e-3)" if post_step else ""),
          flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def check_step_card_vs_cpu(field, params, ds, cache, opt, dev):
    """One step of the flagship field on CHECK_RAYS rays from the same
    O(0.1-1) parameters, float32 MLPs and the same draws: the loss, every
    gradient leaf and the post-step parameters of the card's step against
    the CPU's, with the flagship's hierarchical sampling and with
    UNIFORM_STEPS uniform samples (no sample_pdf); then, uniform, the card's
    step on its plain versions against the CPU's (printed: the same gap
    means the kernels take no part in it) and the card's step on its kernels
    against the same step on its plain versions."""
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    signal = signal_params(params)
    cpu_field = LiDAR4DField(field.cfg, device="cpu")
    hierarchical = dict(num_coarse=opt.num_coarse, num_fine=opt.num_fine)
    uniform = dict(num_steps=UNIFORM_STEPS)
    with mlp_dtype(torch.float32):
        cpu = step_grads(cpu_field, signal, ds, cache, hierarchical)
        card = step_grads(field, signal, ds, cache, hierarchical, draws=cpu[3])
        compare_steps("card vs cpu", field, signal, card, cpu, STEP_RTOL, STEP_GRAD_RTOL,
                      post_step=True)
        cpu = step_grads(cpu_field, signal, ds, cache, uniform)
        card = step_grads(field, signal, ds, cache, uniform, draws=cpu[3])
        compare_steps("card vs cpu, uniform sampling", field, signal, card, cpu,
                      UNIFORM_STEP_RTOL, UNIFORM_STEP_GRAD_RTOL, post_step=True)
        with plain_kernels():
            plain = step_grads(field, signal, ds, cache, uniform, draws=cpu[3])
        compare_steps("card plain versions vs cpu, uniform sampling", field, signal, plain, cpu,
                      UNIFORM_STEP_RTOL, UNIFORM_STEP_GRAD_RTOL, post_step=True)
        compare_steps("card kernels vs card plain versions, uniform sampling", field, signal,
                      card, plain, KERNEL_STEP_RTOL, KERNEL_STEP_GRAD_RTOL, post_step=True)


def profile_step(step, state, frame, cache):
    """Device time by kernel over one train step (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("hash_grid_fwd", "hash_grid_bwd", "plane_bilinear_fwd", "plane_bilinear_bwd",
             "plane_linear_fwd", "plane_linear_bwd")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, frame, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows)
    groups = {k: 0.0 for k in (*names, "matmul", "sort", "scatter/gather", "reduce", "cat",
                               "other")}
    for key, _, ms in rows:
        low = key.lower()
        group = next((g for g in names if g in low), None)
        if group is None:
            group = ("matmul" if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet"))
                     else "sort" if "sort" in low
                     else "scatter/gather" if any(k in low for k in ("scatter", "gather",
                                                                     "index"))
                     else "reduce" if "reduce" in low
                     else "cat" if "cat" in low
                     else "other")
        groups[group] += ms
    print(f"  profile 1 train step: wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    print("  device ms by group " + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)


def train(field, params, ds, cache, opt, dev, warmup=WARMUP, timed=TIMED, classic=False):
    """warmup + timed flagship train steps from `params` (updated in place),
    bfloat16 MLPs, the flow loss on, each step's kernel launches checked
    against `launches_per_step`; then one step under the profiler. Returns
    (launch counts of all steps, mean ms/step of the timed steps, their
    losses)."""
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS)
    state, optim = init_train_state(field, lr=LR, iters=ITERS, params=params)
    step = make_train_step(field, optim, loss_cfg, H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV,
                           num_rays=TRAIN_RAYS, patch_size=1, num_coarse=opt.num_coarse,
                           num_fine=opt.num_fine, seed=SEED)
    fc = flow_cache_to_device(cache, dev)
    frames = [{k: torch.as_tensor(v, device=dev) if k != "time" else v
               for k, v in ds.frame(i).items()} for i in range(STEP_FRAMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        state, metrics = step(state, frames[i % STEP_FRAMES], fc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (m, t) in enumerate(zip(losses, times)):
        print(f"  step {i} ({'warm-up' if i < warmup else 'timed'}): {t * 1e3:.1f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in m.items()), flush=True)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i}: a loss is not finite: {m}")
    step_s = float(np.mean(times[warmup:]))
    print(f"  flagship train step{' (classic)' if classic else ''}: {step_s * 1e3:.2f} ms/step "
          f"(mean of {timed}, min {min(times[warmup:]) * 1e3:.2f}), "
          f"{TRAIN_RAYS / step_s:.1f} train rays/s per GPU, peak memory {peak:.2f} GiB",
          flush=True)
    want = launches_per_step(field, classic)
    n_steps = warmup + timed
    print(f"  launches per step {json.dumps({k: v / n_steps for k, v in launches.items()})} "
          f"(expected {json.dumps(want)})", flush=True)
    for name, per_step in want.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {n_steps} steps, "
                                 f"expected {per_step} per step")
    profile_step(step, state, frames[0], fc)
    return launches, step_s * 1e3, losses[warmup:]


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper swapped for its plain PyTorch version, on the
    card's tensors too: the autograd.Functions then run the plain halves."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho
    from lidar4d_tpu_torch.ops import plane_onehot as po

    swaps = {(ho, "hash_grid_fwd"): ho.hash_grid_fwd_plain,
             (ho, "hash_grid_bwd"): ho.hash_grid_bwd_plain,
             (po, "plane_bilinear_fwd"): po.plane_bilinear_plain,
             (po, "plane_bilinear_bwd"): po.plane_bilinear_bwd_plain,
             (po, "plane_bilinear_vjp"): po.plane_bilinear_vjp_plain,
             (po, "plane_linear_fwd"): po.plane_linear_plain,
             (po, "plane_linear_bwd"): po.plane_linear_bwd_plain}
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def check_encoders(field, params, ds, opt, dev):
    """Planes4D.__call__ of the flagship field on one train frame's
    TRAIN_RAYS x num_fine points, warped by the flagship flow net (xyz =
    x01 + flow(x01, ENCODER_FLOW_T)[:, :3]), at a per-ray time that
    includes the frame times 0 and 1; O(0.1-1) tables and time planes
    (`signal_params`: time planes of ones give a zero coordinate gradient),
    float32 MLPs. Forward, then two backward passes with fixed cotangents:
    into every plane from both outputs, and into every flow-net parameter
    from the dynamic output (the static lookups' points are ray positions by
    contract: no coordinate gradient, and a NaN from the hashed planes).
    The planes run on the kernels and again on the plain versions on the
    card, from one flow-net forward (so that both look the planes up at the
    same points: trained planes turn an ulp of a warped coordinate into
    1e-5 of a value); the flow net's backward runs on each side's own.
    Values within KERNEL_RTOL, gradients within GRAD_RTOL. Returns the
    kernel run's launches."""
    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.ops.rays import get_lidar_rays

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    cfg = field.cfg
    rays = get_lidar_rays(torch.as_tensor(ds.frame(0)["pose"], device=dev), FOV, ds.H_lidar,
                          ds.W_lidar, N=TRAIN_RAYS, generator=gen)
    x01 = chunk_points(rays["rays_o"], rays["rays_d"], cfg.near_lidar, cfg.far_lidar,
                       cfg.bound, opt.num_fine)
    t = per_ray_times(TRAIN_RAYS, opt.num_fine, cfg.num_frames, gen, dev)
    planes, flow = field.planes_encoder, field.flow_net
    signal = signal_params(params)
    n, n_out = x01.shape[0], planes.n_output_dims // 2
    cs = torch.randn(n, n_out, generator=gen, device=dev)
    cd = torch.randn(n, n_out, generator=gen, device=dev)
    print(f"  Planes4D.__call__ on {n} points ({TRAIN_RAYS} rays x {opt.num_fine} samples), "
          f"{int((t == 0).sum() + (t == 1).sum())} of them at t = 0 or 1", flush=True)
    runs = {}
    flow_params = tree_to_torch(signal["flow"], dev)
    flow_leaves = tree_leaves(flow_params)
    for leaf in flow_leaves:
        leaf.requires_grad_(True)
    _cuda.reset_launch_counts()
    with mlp_dtype(torch.float32):
        pts = torch.cat([x01 + flow(flow_params, x01, ENCODER_FLOW_T)[:, :3], t], -1)
        for label in ("kernels", "plain"):
            p = tree_to_torch(signal["planes"], dev)
            plane_leaves = tree_leaves(p)
            for leaf in plane_leaves:
                leaf.requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plain_kernels() if label == "plain" else contextlib.nullcontext():
                static, dynamic = planes(p, pts)
                g_planes = torch.autograd.grad((static * cs).sum() + (dynamic * cd).sum(),
                                               plane_leaves, retain_graph=True)
                g_flow = torch.autograd.grad((dynamic * cd).sum(), flow_leaves,
                                             retain_graph=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs[label] = ([static.detach(), dynamic.detach()], list(g_planes) + list(g_flow),
                           dict(_cuda.LAUNCHES))
            print(f"  {label}: forward + backward {ms:.1f} ms (host clock), launches "
                  f"{json.dumps(runs[label][2])}", flush=True)
            _cuda.reset_launch_counts()
    (vals, grads, launches), (p_vals, p_grads, p_launches) = runs["kernels"], runs["plain"]
    worst = {}
    for kind, got, want, tol in (("values", vals, p_vals, KERNEL_RTOL),
                                 ("gradients", grads, p_grads, GRAD_RTOL)):
        for a, b in zip(got, want):
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            worst[kind] = max(worst.get(kind, 0.0), rel)
            if not (torch.isfinite(a).all() and scale > 0 and rel <= tol):
                raise AssertionError(f"encoders {kind}: kernels vs plain {rel} > {tol} "
                                     f"(scale {scale})")
    g_flow = grads[len(tree_leaves(signal["planes"])):]
    print(f"  kernels vs plain on the card: max relative gap {json.dumps(worst)} (tolerances "
          f"values {KERNEL_RTOL:g}, gradients {GRAD_RTOL:g}); flow-net gradient magnitudes "
          f"{[float(f'{g.abs().max().item():.3e}') for g in g_flow]}", flush=True)
    # one launch per scale in each of the two backward passes
    want = 2 * len(planes.multiscale_res)
    if launches["plane_bilinear_vjp"] != want or any(p_launches.values()):
        raise AssertionError(f"encoders: {launches['plane_bilinear_vjp']} plane_bilinear_vjp "
                             f"launches (expected {want}); plain run launched {p_launches}")
    return launches


def check_classic(field, params, ds, cache, opt, dev):
    """The classic route (ONEHOT_VARIANT "classic"): its hash_grid cases at
    the train step's per-call sizes; one classic step against one fact step
    on the card (uniform sampling, float32 MLPs, the same params and draws);
    CLASSIC_WARMUP + CLASSIC_TIMED flagship steps from a fresh seeded init.
    Returns (the cases' summary, launches, ms/step, timed losses)."""
    with onehot_variant("classic"):
        summary = check_train_kernels(field, params, ds, cache, opt, dev, classic=True)
    signal = signal_params(params)
    sampling = dict(num_steps=UNIFORM_STEPS)
    masks = []
    with onehot_variant("fact"), float32_mlps_sharing_relu_masks(masks, record=True):
        fact = step_grads(field, signal, ds, cache, sampling)
    with (onehot_variant("classic"),
          float32_mlps_sharing_relu_masks(masks, record=False) as relu):
        classic = step_grads(field, signal, ds, cache, sampling, draws=fact[3])
    print(f"  classic vs fact: the classic step ran on the fact step's ReLU masks; "
          f"{relu['flipped']} of its {relu['masked']} hidden pre-activations had the other "
          f"sign", flush=True)
    compare_steps("classic vs fact", field, signal, classic, fact, CLASSIC_STEP_RTOL,
                  CLASSIC_GRAD_RTOL, post_step=False)
    with onehot_variant("classic"):
        launches, ms, losses = train(field, field.init(seed=SEED), ds, cache, opt, dev,
                                     CLASSIC_WARMUP, CLASSIC_TIMED, classic=True)
    return summary, launches, ms, losses


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2

    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.interop import tree_to_torch
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.models.renderer import render_rays
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays

    t_start = time.perf_counter()
    seconds = {}

    phase("env")
    t0 = time.perf_counter()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    seconds["env"] = time.perf_counter() - t0

    phase("build")
    t0 = time.perf_counter()
    so, log = _cuda.build()
    _cuda.library()
    seconds["build"] = time.perf_counter() - t0
    print(f"built {so.name} in {seconds['build']:.1f} s", flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    opt = get_arg_parser().parse_args(["--config", CONFIG])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=SEED)
    H, W = opt.H_lidar, opt.W_lidar
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 0, 3] = [-0.05, 0.05]            # straight line along x
    times = np.array([0.3, 0.7], np.float32)
    rays_o, rays_d = build_novel_rays(poses, H, W, opt.fov_lidar)

    phase("kernels")
    t0 = time.perf_counter()
    summary = check_kernels(field, params, rays_o[0], rays_d[0], opt, dev)
    seconds["kernels"] = time.perf_counter() - t0

    phase("slice")
    t0 = time.perf_counter()

    # small render with O(0.1-1) tables: kernels on the card vs plain versions
    # on the CPU, and how far a one-row / one-pixel read fault moves the CPU's
    sel = np.linspace(0, H * W - 1, SMALL_RAYS).astype(np.int64)
    cpu_field = LiDAR4DField(field.cfg, device="cpu")
    signal = signal_params(params)

    def small_render(f, p, d):
        return render_rays(
            f, tree_to_torch(p, d), torch.as_tensor(rays_o[0, sel], device=d),
            torch.as_tensor(rays_d[0, sel], device=d), times[0],
            num_steps=opt.num_steps, num_coarse=opt.num_coarse, num_fine=opt.num_fine,
            with_aux=False)

    for mlp, atols in SLICE_ATOL.items():
        with mlp_dtype(getattr(torch, mlp)):
            gpu, cpu = small_render(field, signal, dev), small_render(cpu_field, signal, "cpu")
            for key, atol in atols.items():
                a, b = gpu[key].cpu(), cpu[key]
                err = (a - b).abs().max().item()
                print(f"  small render, {mlp} MLPs, {key}: max_abs gpu vs cpu {err:.3e} "
                      f"(tolerance {atol:g}; range {b.min().item():.4f}.."
                      f"{b.max().item():.4f})", flush=True)
                if not (torch.isfinite(a).all() and err <= atol):
                    raise AssertionError(f"small render {mlp} {key} disagrees: {err} > {atol}")
            if mlp != "float32":
                continue
            for fault in FAULTS:
                r = small_render(cpu_field, faulted(signal, fault), "cpu")
                moved = {k: (r[k] - cpu[k]).abs().max().item() for k in atols}
                print(f"  read fault {fault:32s} moves the CPU render by "
                      + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()), flush=True)
                if not any(moved[k] >= FAULT_MARGIN * atol for k, atol in atols.items()):
                    raise AssertionError(f"the small render cannot see a {fault} fault")

    class CheckedSimulator(Simulator):
        """Keeps each frame's depth, intensity and refined ray-drop (device
        tensors) as the U-Net refine sees them."""

        frames = []

        def _refine(self, raydrop, intensity, depth):
            out = super()._refine(raydrop, intensity, depth)
            self.frames.append((depth, intensity, out))
            return out

    sim = CheckedSimulator("lidar4d", opt, field, params, use_refine=True, H_lidar=H,
                           W_lidar=W, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t_render = time.perf_counter()
    pred = sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False,
                      frame_batch=2)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t_render
    launches = dict(_cuda.LAUNCHES)
    print(f"  render 2 frames {H}x{W}: {render_s:.3f} s, {render_s / 2:.3f} s/frame; "
          f"launches {launches}", flush=True)
    if len(sim.frames) != 2:
        raise AssertionError(f"{len(sim.frames)} frames refined, not 2")
    for i, frame in enumerate(sim.frames):
        for k, v in zip(("depth", "intensity", "raydrop"), frame):
            print(f"  frame {i} {k}: shape {tuple(v.shape)} mean {v.mean().item():.5f} "
                  f"min {v.min().item():.5f} max {v.max().item():.5f}", flush=True)
            if tuple(v.shape) != (H, W) or not torch.isfinite(v).all():
                raise AssertionError(f"frame {i} {k} is not finite of shape ({H}, {W})")
    sim.frames.clear()
    if pred is None or pred.ndim != 2 or pred.shape[1] != 4 or not np.isfinite(pred).all():
        raise AssertionError("point cloud is not a finite [M, 4] array")
    for name, count in launches.items():
        if (count <= 0) if name.endswith("_fwd") else (count != 0):
            raise AssertionError(f"kernel {name}: {count} launches during the render")

    torch.cuda.synchronize()
    t_steady = time.perf_counter()
    sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False,
               frame_batch=2)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    print(f"  second render: {steady_s:.3f} s, {steady_s / 2:.3f} s/frame; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_render(sim, rays_o[:1], rays_d[:1], times[:1])
    seconds["slice"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as root:
        phase("scene")
        t0 = time.perf_counter()
        ds, cache, scale = make_scene(root)
        seconds["scene"] = time.perf_counter() - t0
    tfield = train_field(field, scale)

    phase("train-kernels")
    t0 = time.perf_counter()
    train_summary = check_train_kernels(tfield, params, ds, cache, opt, dev)
    seconds["train-kernels"] = time.perf_counter() - t0

    phase("train")
    t0 = time.perf_counter()
    check_step_card_vs_cpu(tfield, params, ds, cache, opt, dev)
    seconds["train-check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_launches, _, _ = train(tfield, params, ds, cache, opt, dev)
    seconds["train"] = time.perf_counter() - t0

    phase("encoders")
    t0 = time.perf_counter()
    encoder_launches = check_encoders(tfield, params, ds, opt, dev)
    seconds["encoders"] = time.perf_counter() - t0

    phase("classic")
    t0 = time.perf_counter()
    classic_summary, classic_launches, classic_ms, classic_losses = check_classic(
        tfield, params, ds, cache, opt, dev)
    seconds["classic"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    print("seconds " + json.dumps({k: round(v, 2) for k, v in seconds.items()}), flush=True)

    print("  render-size forward kernels (one 16,384-ray chunk): " + json.dumps(
        {k: {f: round(v, 4) if isinstance(v, float) else v for f, v in s.items()}
         for k, s in summary.items()}), flush=True)
    onehot = "lidar4d_tpu/ops/hash_onehot.py"
    planes_py = "lidar4d_tpu/ops/plane_onehot.py"
    sources = {
        "hash_grid_fwd": ("lidar4d_tpu_torch/csrc/hash_grid_fwd.cu",
                          f"{onehot}:139, {onehot}:377, {onehot}:763", train_launches),
        "plane_bilinear_fwd": ("lidar4d_tpu_torch/csrc/plane_bilinear_fwd.cu",
                               f"{planes_py}:206", train_launches),
        "plane_linear_fwd": ("lidar4d_tpu_torch/csrc/plane_linear_fwd.cu",
                             f"{planes_py}:459", train_launches),
        "hash_grid_bwd": ("lidar4d_tpu_torch/csrc/hash_grid_bwd.cu",
                          f"{onehot}:172, {onehot}:420, {onehot}:901", train_launches),
        "plane_bilinear_bwd": ("lidar4d_tpu_torch/csrc/plane_bilinear_bwd.cu",
                               f"{planes_py}:300", train_launches),
        "plane_linear_bwd": ("lidar4d_tpu_torch/csrc/plane_linear_bwd.cu",
                             f"{planes_py}:492", train_launches),
        "plane_bilinear_vjp": ("lidar4d_tpu_torch/csrc/plane_bilinear_vjp.cu",
                               f"{planes_py}:247", encoder_launches),
    }
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        s = train_summary[name]
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": s["max_abs_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    n_classic = CLASSIC_WARMUP + CLASSIC_TIMED
    print(json.dumps({"classic": {
        "ms_per_step": classic_ms, "train_rays_per_s": TRAIN_RAYS / classic_ms * 1e3,
        "loss": [m["loss"] for m in classic_losses],
        "launches_per_step": {k: v / n_classic for k, v in classic_launches.items()},
        "kernels": {name: dict(classic_summary[name], launches=classic_launches[name],
                               replaces=f"{onehot}:{line}")
                    for name, line in (("hash_grid_fwd", 139), ("hash_grid_bwd", 172))}}}),
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
