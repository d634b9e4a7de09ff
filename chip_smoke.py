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
           counting kernel launches, and profile one frame (device ms by
           kernel group, hash_grid_fwd's per 16,384-ray chunk);
  scene    write the synthetic 66x1030x51 scene (seed 0) to a temporary
           directory and build the flow-loss cache (at most 65,536 points a
           frame) for the frames the train steps touch and their +-2
           neighbours;
  train-kernels  hold every forward and backward kernel against its plain
           version at the train step's per-call sizes (131,072 and 262,144
           points along the step's 1,024 training rays, the flow loss's
           cloud and ground points); time kernel, plain version and the
           PyTorch call with the same function;
  train    one flagship train step on the card against the same step on the
           CPU (O(0.1-1) tables, float32 MLPs, fewer rays): loss, every
           gradient leaf, post-step parameters, once with hierarchical
           sampling, once with hierarchical sampling and the line-of-sight
           (URF) loss at a step where its band has narrowed (URF_STEP), and
           once with uniform sampling (no sample_pdf, so the
           gap is the kernels' and the card's float32 rounding alone); then
           2 warm-up and 5 timed flagship steps (1,024 rays, 128 + 256
           samples, flow loss) with their losses, ms/step, train rays/s,
           peak memory and kernel launches per step; and one step under
           torch.profiler;
  parallel two gloo ranks on the one card (NCCL takes one card a rank),
           each a process of its own started by parallel.launch and joined
           within a time limit: 3 sharded flagship steps at patch 1 and 3
           at patch (2, 8) (float32 MLPs), each step's loss and gradients on
           rank 0 held against the single-process step from the same
           parameters and draws at the KERNEL_STEP tolerances, each rank's
           kernel launches per step against one process's step, the ranks'
           parameters bitwise equal after the steps, each rank's ms/step;
           one 66x1030 frame rendered over the ranks against one process;
           then an NCCL process group of one rank in this process and one
           sharded step through it against the single-process step;
  encoders Planes4D.__call__ of the flagship field on 262,144 points warped
           by the flagship flow net, at a per-ray time that includes the
           frame times 0 and 1: forward, then backward into every plane and
           every flow-net parameter, on the kernels and again on the plain
           versions on the card, compared; then plane_bilinear_vjp's four
           calls of one backward on those points (the four scales' time
           planes [3, 8, 8, S]) held against the plain version, each timed
           beside its bound and the PyTorch call with the same function;
  classic  under hash_onehot.ONEHOT_VARIANT = "classic" (the reference's
           A/B switch): the classic route's hash_grid cases at the train
           step's per-call sizes, one classic step against one fact step on
           the card (uniform sampling, float32 MLPs, the classic step on the
           fact step's ReLU masks), then 1 warm-up and 3 timed flagship
           steps with ms/step, losses and launches per step, and one step
           under torch.profiler;
  trainer  the port's training entry point, cli.main_lidar4d.main, with the
           flagship config on the synthetic scene (the CLI writes it into a
           temporary directory and builds the whole flow cache): 3 epochs,
           the first with the uniform sampler at patch 1, the second
           hierarchical at patch (2, 8), the third hierarchical at patch 1,
           evaluation at epoch 2, the U-Net refine (1000 steps on the 41
           train frames), evaluate and test; then --test_eval --ckpt latest
           in the same workspace, whose eval record must equal the first
           run's; then one val frame's meters on the card against the CPU.
           Checks: each train kernel launched in the epochs and only the
           forward kernels in evaluation, finite losses, the U-Net's BCE
           falling, finite CD and F-score, the checkpoint names. Prints
           rays/s by epoch, eval s/frame by part, refine ms/step and peak
           memory, test s/frame and checkpoint seconds, and a JSON line
           {"trainer": {...}}.
  simulate the simulation CLI, `python -m lidar4d_tpu_torch.cli.main_lidar4d_sim`,
           in a fresh process on the trainer phase's workspace (--ckpt
           latest_model must resolve to its refine checkpoint): the scene's
           51 frames at 66x1030 with the U-Net refine, points and panels
           written; the same frames rendered in this process by
           Simulator.render with the TF32 switches of a fresh process, each
           point cloud bitwise equal to the CLI's (a fresh process's first
           card render against a warm process's); then --kitti2nus
           --shift_y 0.5 --align_axis (32x1024, no refine) in a fresh
           process and by cli.main_lidar4d_sim.main in this one, bitwise
           equal again. Checks: finite [M, 4] clouds, the forward kernels
           launched and no backward kernel, by the CLI's printed counts and
           this process's. Prints s/frame of both shapes and a JSON line
           {"simulate": {...}}.
  preprocess (host) the preprocessing CLI, cli.preprocess --dataset kitti360,
           on a raw KITTI-360 tree written here (sequence 1538, 64 scans of
           100,000 points), read back through the config it writes and
           KITTI360Dataset, with seconds per step; the native extension
           built with this machine's g++ and its pano held against numpy's
           (1e-6); the outlier removal on the synthetic scene's first 8
           refine frames (point_removal's input) by cKDTree on one worker,
           by the port's default (cKDTree on every core) and by the native
           kNN, with seconds a frame and the points whose keeping differs
           from the one-worker cKDTree's. A JSON line {"preprocess": {...}}.
  reference the paper's configuration, configs/kitti360_4950.txt at the CLI
           defaults (2^19-row hash tables, dense 32^2..256^2 planes, 768
           uniform samples, 53.1 M parameters), off every flagship route:
           one step (1,024 rays, the flow loss on whole clouds) on O(0.1-1)
           parameters with every kernel call and hash-encode route
           recorded, each call held against its plain version on its own
           inputs (a backward kernel against the plain version with tables
           and cotangents in float64) and timed beside its bound; 1 warm-up
           and 3 timed steps with a profiled one; one card step against the
           CPU's (256 rays, float32 MLPs); one 66x1030 frame through
           Simulator.render in the field's 4,096-ray chunks, and its first
           chunk against the plain versions; then the training CLI (one
           epoch of 41 steps, one evaluation, no refine) and the simulation
           CLI (--kitti2nus, a fresh process) on the scene of the trainer
           phase, each kernel's launches checked per step and per chunk. A
           JSON line {"reference": {...}}.

The kernels line (the line before the device's name) is a JSON object with
each kernel's numbers. For the six kernels of the train step they are taken
at its per-call sizes: ms, plain_ms, library_ms and bound_ms are sums over
the calls of one flagship train step, and launches the count over the 7
train steps. For plane_bilinear_vjp they are sums over the four launches of
one Planes4D.__call__ backward, and launches the encoders phase's count.
The parallel phase's JSON line {"parallel": {...}} has each rank's ms/step
and launches per step. The classic phase's own line gives rows 1-2 (the classic one-hot route):
hash_grid_fwd and hash_grid_bwd summed over one classic step, and their
launches over the classic steps. The last line is {"ok": true, "device":
{...}}. Any failure exits non-zero before either is printed. Imports
nothing of JAX.
"""

import collections
import contextlib
import copy
import dataclasses
import functools
import inspect
import json
import os
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
URF_STEP = 13500               # step / ITERS = 0.45: the URF band's eps decayed, as at
                               # step 4,469 of the 10k URF run that went non-finite
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
# trainer phase: 3 epochs of the flagship config on the synthetic scene, the
# first with the uniform sampler (hier_warmup_iters = one epoch's steps), the
# second at patch (2, 8), evaluation at epoch 2, then refine, evaluate, test
TRAINER_EPOCHS = 3
METER_RTOL = 1e-6              # the meters on the card vs on the CPU, relative
# preprocess phase: scans of a real KITTI-360 scan's size, and the outlier
# removal's three paths on the synthetic scene's first refine frames
RAW_SCAN_POINTS = 100_000
OUTLIER_FRAMES = 8
# parallel phase: 2 gloo ranks on the one card, 3 sharded flagship steps at
# patch 1 and 3 at patch (2, 8), float32 MLPs, each step held against the
# single-process step at the KERNEL_STEP tolerances; one 66x1030 frame
# rendered over the ranks against one process
PARALLEL_RANKS = 2
PARALLEL_STEPS = 3
PARALLEL_TIMEOUT = 240         # s for the ranks, their start included
PARALLEL_RENDER_RTOL = 1e-5
TRAIN_KERNELS = ("hash_grid_fwd", "hash_grid_bwd", "plane_bilinear_fwd", "plane_bilinear_bwd",
                 "plane_linear_fwd", "plane_linear_bwd")


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


def max_rel(got, want):
    """Largest gap over the outputs, each of its reference's largest magnitude."""
    return max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def check_case(case, summary, main, iters, plain_iters, exact=None):
    """Hold one kernel case against its plain version (each output within
    KERNEL_RTOL, GRAD_RTOL for a backward kernel, of the plain output's
    largest magnitude; where the case carries a zero check, as
    plane_bilinear_vjp's do (`vjp_zeros`), the last outputs held to it),
    time kernel, plain
    version and library call, and add the case to `summary` (times and bound
    only when `main`). With `exact`, the plain version with tables and
    cotangents in float64, the outputs are held against that instead, and the float32
    plain version's own gap to it is printed beside: an output that sums
    tens of thousands of float32 terms comes out of any two orders of
    addition about 1e-4 apart. Returns the case's numbers."""
    name, label, run, plain, library, nb, flops, *zero_check = case
    rtol = GRAD_RTOL if name.endswith(("_bwd", "_vjp")) else KERNEL_RTOL
    got, want = run(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    plain_rel = None
    if exact is not None:
        ref = exact()
        ref = ref if isinstance(ref, tuple) else (ref,)
        plain_rel = max_rel(want, ref)
        want = ref
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    rel = max_rel(got, want)
    cancelled = zero_check[0](got[-1], want[-1]) if zero_check else None
    del got, want
    ms = cuda_ms(run, iters)
    plain_ms = cuda_ms(plain, plain_iters)
    lib_ms = cuda_ms(library, iters) if library is not None else None
    b_ms, b_by = bound_ms(nb, flops)
    oracle = "" if plain_rel is None else f" (float64; float32 plain {plain_rel:.3e})"
    if cancelled is not None:
        oracle += f" (tent zeros equal; {cancelled} float32 cancellations)"
    print(f"  {name:18s} {label:55s} max_abs {err:.3e} max_rel {rel:.3e}{oracle} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'} "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    if not rel <= rtol:
        raise AssertionError(f"{name} {label}: max_rel {rel} > {rtol}")
    row = {"kernel": name, "call": label, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
           "plain_float32_rel_err": plain_rel, "float32_cancellations": cancelled}
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
    return row


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


def vjp_zeros(grid, pts, cot, got, want):
    """Hold plane_bilinear_vjp's point gradients got, want [P, N, 2] (at
    grid [P, C, H, W], pts [P, N, 2], cot [P, C, N]) to the tent's
    subgradient: both exactly zero wherever it is zero (the pixel coordinate
    an exact integer, as the plain version rounds it, or the point outside
    [0, 1]). Elsewhere a point's gradient is a sum of C products, which
    float32 can cancel to an exact zero in one order of addition and not in
    another; a zero on one side alone is taken there only where the other
    side lies within both sums' rounding bound, 4 (C + 3) 2^-24 (size - 1)
    max|G| sum_c |cot|. Returns the number of such cancellations."""
    p, c, h, w = grid.shape
    dead = []
    for j, size in ((0, w), (1, h)):
        u = torch.clamp(pts[..., j], 0.0, 1.0) * (size - 1)
        dead.append((u == torch.floor(u)) | ~((pts[..., j] >= 0.0) & (pts[..., j] <= 1.0)))
    dead = torch.stack(dead, -1)
    if not (torch.all(got[dead] == 0) and torch.all(want[dead] == 0)):
        raise AssertionError("plane_bilinear_vjp: a point gradient is not zero where the "
                             "tent's subgradient is")
    one_side = ~dead & ((got == 0) != (want == 0))
    size = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=grid.device)
    bound = (4 * (c + 3) * 2.0 ** -24 * grid.abs().max() * size
             * cot.abs().sum(1)[..., None])
    gap = (got.double() - want.double()).abs()
    if not torch.all(gap[one_side] <= bound[one_side]):
        raise AssertionError("plane_bilinear_vjp: the point gradient's zeros differ from the "
                             "plain version's beyond float32 cancellation")
    return int(one_side.sum())


def vjp_cases(params, gen, pts, t):
    """plane_bilinear_vjp cases of one Planes4D.__call__ backward on pts
    [N, 3] at per-sample times t [N, 1]: per scale one launch over the three
    time planes [3, C, T, S] (drawn from U(0.5, 1.5): the init's ones would
    give a zero coordinate gradient), with random cotangents, and the
    point gradients' zero check (`vjp_zeros`)."""
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
            nbytes(grid, q, cot, grid, q), 24 * cot.numel(),
            functools.partial(vjp_zeros, grid, q, cot)))
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
    """Device time by kernel over one frame's render (torch.profiler).
    Returns the device ms by group and hash_grid_fwd's launches."""
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
    return groups, sum(count for key, count, _ in rows if "hash_grid_fwd" in key.lower())


def make_scene(root):
    """The bench's synthetic scene under `root`, its train and refine
    datasets, and the flow cache for the frames the steps touch and their
    +-2 neighbours (every other frame valid = 0). Returns (train dataset,
    cache, scale, offset)."""
    from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence

    t0 = time.perf_counter()
    scale, offset = generate_synthetic_sequence(root, **SCENE)
    t_gen = time.perf_counter() - t0
    print(f"  scene {SCENE}: scale {scale:.6g}, written in {t_gen:.1f} s", flush=True)
    ds, cache = scene_steps(root, scale, offset, FLOW_MAX_POINTS)
    return ds, cache, scale, offset


def scene_steps(root, scale, offset, max_points):
    """The train dataset of the synthetic scene under `root` and the flow
    cache (at most max_points a cloud; 0: whole clouds) for the frames the
    steps touch and their +-2 neighbours (every other frame valid = 0)."""
    from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
    from lidar4d_tpu_torch.train.flow_cache import build_flow_cache

    kw = dict(root_path=root, sequence_id=SCENE["sequence_id"], scale=scale, offset=offset)
    ds = KITTI360Dataset(split="train", num_rays_lidar=TRAIN_RAYS, **kw)
    refine = KITTI360Dataset(split="refine", **kw)
    n_frames = SCENE["num_frames"]
    touched = {int(round(float(ds.times[i]) * (n_frames - 1))) for i in range(STEP_FRAMES)}
    frames = {f + d for f in touched for d in range(-2, 3) if 0 <= f + d < n_frames}
    random.seed(SEED)
    t0 = time.perf_counter()
    cache = build_flow_cache(refine, scale, n_frames, max_points=max_points, seed=SEED,
                             frames=frames)
    built = sorted(int(i) for i in np.flatnonzero(cache["valid"]))
    print(f"  flow cache (at most {max_points or 'all'} points a cloud) for frames {built} in "
          f"{time.perf_counter() - t0:.1f} s: points {cache['points'].shape}, "
          f"ground {cache['ground'].shape}", flush=True)
    return ds, cache


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
    the flow loss's two flow-net calls. Returns the per-kernel summary, sums
    over the calls of one train step. classic=True: the classic route's
    hash encodes alone."""
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


def launches_per_step(field, classic=False, density_calls=2):
    """Kernel launches of one train step, from the field's shape: per
    density call (two per hierarchical step, one per uniform step) the
    static hash, the hashed static planes (one launch for the three), the
    flow grid and the dynamic hash planes on hash_grid_* (fused: one launch
    for the three variants of a plane; classic, or a dynamic spec the folded
    encode does not take: one per variant forward, variant 0 alone
    backward), each dense static scale on plane_bilinear_*, each scale's
    time planes on plane_linear_*; plus the flow loss's two flow-grid
    encodes, and no plane_bilinear_vjp."""
    from lidar4d_tpu_torch.ops.hash_onehot import folded_eligible

    enc = field.hash_encoder
    unfused = classic or not all(folded_eligible(enc.dynamic_spec(p), enc.num_basis)
                                 for p in range(3))
    planes = field.planes_encoder
    n_scales = len(planes.multiscale_res)
    hashed = sum(planes._static_hashed(si, planes._scale_reso(sc))
                 for si, sc in enumerate(planes.multiscale_res))
    per_call = {"hash_grid_fwd": 2 + hashed + (9 if unfused else 3),
                "hash_grid_bwd": 2 + hashed + 3,
                "plane_bilinear_fwd": n_scales - hashed, "plane_bilinear_bwd": n_scales - hashed,
                "plane_linear_fwd": n_scales, "plane_linear_bwd": n_scales,
                "plane_bilinear_vjp": 0}
    extra = {"hash_grid_fwd": 2, "hash_grid_bwd": 2}
    return {k: density_calls * v + extra.get(k, 0) for k, v in per_call.items()}


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


def step_grads(field, signal, ds, cache, sampling, draws=None, urf_step=None):
    """One step's metrics, gradient leaves and post-step leaves (on the host)
    from the numpy params `signal` on the field's device, with `draws` (the
    step's own when None); with `urf_step` the line-of-sight loss on, at that
    step count. Returns (metrics, grads, params, draws)."""
    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS,
                          urf_loss=urf_step is not None)
    state, optim = init_train_state(field, lr=LR, iters=ITERS,
                                    params=tree_to_torch(signal, field.device))
    state.step = urf_step or 0
    step = make_train_step(field, optim, loss_cfg, H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV,
                           num_rays=CHECK_RAYS, patch_size=1, seed=SEED, **sampling)
    draws = step.draw() if draws is None else draws
    dd = {k: v.to(field.device) if torch.is_tensor(v) else v for k, v in draws.items()}
    grads, metrics = step.grads(state.params, ds.frame(0), flow_cache_to_device(cache, field.device),
                                dd, state.step)
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
    the CPU's, with the flagship's hierarchical sampling, with it and the
    line-of-sight loss at URF_STEP, and with UNIFORM_STEPS uniform samples
    (no sample_pdf); then, uniform, the card's
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
        cpu = step_grads(cpu_field, signal, ds, cache, hierarchical, urf_step=URF_STEP)
        card = step_grads(field, signal, ds, cache, hierarchical, draws=cpu[3],
                          urf_step=URF_STEP)
        if "urf_loss" not in card[0] or "urf_loss" not in cpu[0]:
            raise AssertionError("the URF step computed no urf_loss")
        compare_steps(f"card vs cpu, URF loss at step {URF_STEP}", field, signal, card, cpu,
                      STEP_RTOL, STEP_GRAD_RTOL, post_step=True)
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
    """Device time by kernel over one train step (torch.profiler); returns
    its wall ms, device busy ms, idle share and device ms by group."""
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
    idle = max(0.0, 1 - busy_ms / wall_ms)
    print(f"  profile 1 train step: wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle share {idle:.3f}", flush=True)
    print("  device ms by group " + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle, "device_ms": groups}


def train(field, params, ds, cache, opt, dev, warmup=WARMUP, timed=TIMED, classic=False,
          what="flagship"):
    """warmup + timed train steps of TRAIN_RAYS rays with opt's sampling
    from `params` (updated in place), bfloat16 MLPs, the flow loss on, each
    step's kernel launches checked against `launches_per_step`; then one
    step under the profiler. Returns a dict: launch counts of all steps,
    mean ms/step of the timed steps, their losses, the peak memory and the
    profiled step's numbers."""
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS)
    state, optim = init_train_state(field, lr=LR, iters=ITERS, params=params)
    step = make_train_step(field, optim, loss_cfg, H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV,
                           num_rays=TRAIN_RAYS, patch_size=1, num_steps=opt.num_steps,
                           num_coarse=opt.num_coarse, num_fine=opt.num_fine, seed=SEED)
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
    print(f"  {what} train step{' (classic)' if classic else ''}: {step_s * 1e3:.2f} ms/step "
          f"(mean of {timed}, min {min(times[warmup:]) * 1e3:.2f}), "
          f"{TRAIN_RAYS / step_s:.1f} train rays/s per GPU, peak memory {peak:.2f} GiB",
          flush=True)
    want = launches_per_step(field, classic, density_calls=2 if opt.num_coarse else 1)
    n_steps = warmup + timed
    print(f"  launches per step {json.dumps({k: v / n_steps for k, v in launches.items()})} "
          f"(expected {json.dumps(want)})", flush=True)
    for name, per_step in want.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {n_steps} steps, "
                                 f"expected {per_step} per step")
    profile = profile_step(step, state, frames[0], fc)
    return {"launches": launches, "ms_per_step": step_s * 1e3, "losses": losses[warmup:],
            "peak_gib": peak, "profile": profile}


# each kernel wrapper's plain PyTorch version, beside it in its module
PLAIN_VERSIONS = {"hash_grid_fwd": "hash_grid_fwd_plain", "hash_grid_bwd": "hash_grid_bwd_plain",
                  "plane_bilinear_fwd": "plane_bilinear_plain",
                  "plane_bilinear_bwd": "plane_bilinear_bwd_plain",
                  "plane_bilinear_vjp": "plane_bilinear_vjp_plain",
                  "plane_linear_fwd": "plane_linear_plain",
                  "plane_linear_bwd": "plane_linear_bwd_plain"}


def kernel_module(name):
    """The module whose global `name` the autograd.Functions call."""
    from lidar4d_tpu_torch.ops import hash_onehot as ho
    from lidar4d_tpu_torch.ops import plane_onehot as po

    return ho if name.startswith("hash_") else po


# each training-path kernel wrapper's bfloat16 twin, beside it in its module:
# what the reference's Pallas kernel computes on the TPU (rows 3-7 and 9-11
# of PERF.md's table; `plane_bilinear_vjp`, row 8, is off the training path)
TPU_VERSIONS = {"hash_grid_fwd": "hash_grid_fwd_tpu", "hash_grid_bwd": "hash_grid_bwd_tpu",
                "plane_bilinear_fwd": "plane_bilinear_tpu",
                "plane_bilinear_bwd": "plane_bilinear_bwd_tpu",
                "plane_linear_fwd": "plane_linear_tpu",
                "plane_linear_bwd": "plane_linear_bwd_tpu"}


@contextlib.contextmanager
def swapped_kernels(make, names=PLAIN_VERSIONS):
    """Every kernel wrapper `name` in `names` swapped for make(name,
    wrapper), restored after."""
    saved = {name: getattr(kernel_module(name), name) for name in names}
    for name, fn in saved.items():
        setattr(kernel_module(name), name, make(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernel_module(name), name, fn)


def plain_kernels():
    """Every kernel wrapper swapped for its plain PyTorch version, on the
    card's tensors too: the autograd.Functions then run the plain halves."""
    return swapped_kernels(lambda name, _: getattr(kernel_module(name), PLAIN_VERSIONS[name]))


def tpu_numerics():
    """Every training-path kernel wrapper swapped for its bfloat16 twin (the
    TPU kernels' numerics), on the card's tensors too: a witness of whether
    the TPU's rounding moves a run's quality, never the main path."""
    return swapped_kernels(lambda name, _: getattr(kernel_module(name), TPU_VERSIONS[name]),
                           TPU_VERSIONS)


def encoder_samples(field, ds, opt, dev, gen):
    """The encoders phase's unwarped points: TRAIN_RAYS rays of train frame
    0 x num_fine samples, x01 [N, 3] in [0, 1], and their per-ray times
    t [N, 1] (`per_ray_times`)."""
    from lidar4d_tpu_torch.ops.rays import get_lidar_rays

    cfg = field.cfg
    rays = get_lidar_rays(torch.as_tensor(ds.frame(0)["pose"], device=dev), FOV, ds.H_lidar,
                          ds.W_lidar, N=TRAIN_RAYS, generator=gen)
    x01 = chunk_points(rays["rays_o"], rays["rays_d"], cfg.near_lidar, cfg.far_lidar,
                       cfg.bound, opt.num_fine)
    return x01, per_ray_times(TRAIN_RAYS, opt.num_fine, cfg.num_frames, gen, dev)


def warp(field, flow_params, x01):
    """x01 moved by the flow net's forward flow at ENCODER_FLOW_T."""
    return x01 + field.flow_net(flow_params, x01, ENCODER_FLOW_T)[:, :3]


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
    Values within KERNEL_RTOL, gradients within GRAD_RTOL. Then
    plane_bilinear_vjp's cases (`vjp_cases`) on the warped points, each held
    against the plain version and timed. Returns the kernel run's launches
    and the cases' summary (sums over the four calls)."""
    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.ops import _cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    x01, t = encoder_samples(field, ds, opt, dev, gen)
    planes = field.planes_encoder
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
        pts = torch.cat([warp(field, flow_params, x01), t], -1)
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
    summary = {}
    with torch.no_grad():
        for case in vjp_cases(params, gen, pts[:, :3].detach(), t):
            check_case(case, summary, True, 20, 2)
    return launches, finish(summary)


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
        run = train(field, field.init(seed=SEED), ds, cache, opt, dev, CLASSIC_WARMUP,
                    CLASSIC_TIMED, classic=True)
    return summary, run["launches"], run["ms_per_step"], run["losses"]


def host_run(grads, metrics):
    """A step's (gradients, metrics) in the form `compare_steps` takes."""
    return ({k: float(v) for k, v in metrics.items()},
            [None if g is None else g.cpu() for g in grads], [None] * len(grads), None)


def parallel_steps(rank, field, signal, scene, frames, cache, opt, mesh, dev):
    """PARALLEL_STEPS sharded flagship steps at patch 1 and at patch (2, 8)
    on `scene`'s frames from the parameters `signal`; on rank 0 each step's loss
    and gradients are held against the single-process step from the same
    parameters and draws (metrics to scene["rtol"], gradients scene["grad_rtol"]).
    Returns ms/step and the
    kernel launches of the sharded steps alone, by patch mode."""
    import torch.distributed as dist

    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import init_train_state, make_train_step

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=scene["scale"],
                          num_frames=field.cfg.num_frames, iters=ITERS)
    out = {}
    for mode, patch in (("patch 1", 1), ("patch 2x8", (2, 8))):
        state, optim = init_train_state(field, lr=LR, iters=ITERS,
                                        params=tree_to_torch(signal, dev))
        kw = dict(H=scene["H"], W=scene["W"], fov_lidar=FOV, num_rays=TRAIN_RAYS,
                  patch_size=patch, num_coarse=opt.num_coarse, num_fine=opt.num_fine, seed=SEED)
        sharded = make_train_step(field, optim, loss_cfg, mesh=mesh, **kw)
        single = make_train_step(field, optim, loss_cfg, **kw)
        launches = dict.fromkeys(_cuda.LAUNCHES, 0)
        times = []
        for i in range(PARALLEL_STEPS):
            frame, draws = frames[i % STEP_FRAMES], sharded.draw()
            if rank == 0:
                ref = single.grads(state.params, frame, cache, draws, state.step)
            torch.cuda.synchronize()
            dist.barrier()              # the timed step starts on both ranks at once
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            grads, metrics = sharded.grads(state.params, frame, cache, draws, state.step)
            optim.step(state.params, grads, state.opt_state)
            state.step += 1
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, v in _cuda.LAUNCHES.items():
                launches[k] += v
            if rank == 0:
                compare_steps(f"{mode} step {i}: {mesh.size} ranks vs one process", field,
                              signal, host_run(grads, metrics), host_run(*ref), scene["rtol"],
                              scene["grad_rtol"], post_step=False)
        want = launches_per_step(field)
        for name, per_step in want.items():
            if launches[name] != per_step * PARALLEL_STEPS:
                raise AssertionError(f"rank {rank} {mode}: {name} launched {launches[name]} "
                                     f"times in {PARALLEL_STEPS} steps, expected {per_step} a "
                                     "step")
        flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(state.params)])
        ref_flat = flat.clone()
        dist.broadcast(ref_flat, src=0)
        if not torch.equal(ref_flat, flat):
            raise AssertionError(f"rank {rank} {mode}: parameters differ from rank 0's after "
                                 f"{PARALLEL_STEPS} steps")
        out[mode] = {"ms_per_step": [t * 1e3 for t in times],
                     "launches_per_step": {k: v / PARALLEL_STEPS for k, v in launches.items()},
                     "params_equal_rank0": True}
        print(f"  rank {rank} of {mesh.size}, {mode}: ms/step "
              + ", ".join(f"{t * 1e3:.1f}" for t in times) + " (host clock; the ranks share one "
              f"card); launches per step {json.dumps(out[mode]['launches_per_step'])}; "
              "parameters bitwise equal to rank 0's", flush=True)
    return out


def parallel_rank(rank, root):
    """One rank of the parallel phase, in a process of its own on card rank
    modulo the cards (`rank_device`: with one card every rank shares it):
    the sharded steps (`parallel_steps`), then one 66x1030 frame rendered
    over the ranks, held on rank 0 against the unsharded render. Writes its
    results to root/rank<rank>.pt."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.interop import tree_to_torch
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.models.renderer import render_staged
    from lidar4d_tpu_torch.parallel.mesh import make_mesh, rank_device
    from lidar4d_tpu_torch.sim.simulator import build_novel_rays
    from lidar4d_tpu_torch.train.train_step import flow_cache_to_device

    dev = rank_device("cuda", rank)
    torch.cuda.set_device(dev)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    opt = get_arg_parser().parse_args(["--config", CONFIG])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = train_field(LiDAR4DField(build_model_config(opt), device=dev), inputs["scale"])
    signal = signal_params(field.init(seed=SEED))
    mesh = make_mesh()
    frames = [{k: torch.as_tensor(v, device=dev) if k != "time" else v for k, v in f.items()}
              for f in inputs["frames"]]
    cache = flow_cache_to_device(inputs["cache"], dev)
    with mlp_dtype(torch.float32):
        out = {"steps": parallel_steps(rank, field, signal, inputs, frames, cache, opt, mesh,
                                       dev)}

    params = tree_to_torch(signal, dev)
    frame = inputs["frames"][0]
    rays_o, rays_d = build_novel_rays(np.asarray(frame["pose"])[None], opt.H_lidar, opt.W_lidar,
                                      opt.fov_lidar)
    ro, rd = (torch.as_tensor(r[0], dtype=torch.float32, device=dev) for r in (rays_o, rays_d))
    kw = dict(num_steps=opt.num_steps, chunk=16384, num_coarse=opt.num_coarse,
              num_fine=opt.num_fine)
    with mlp_dtype(torch.float32):
        render_staged(field, params, ro[:16384], rd[:16384], frame["time"], mesh=mesh, **kw)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = render_staged(field, params, ro, rd, frame["time"], mesh=mesh, **kw)
        torch.cuda.synchronize()
        out["render_s"] = time.perf_counter() - t0
        if rank == 0:
            t0 = time.perf_counter()
            want = render_staged(field, params, ro, rd, frame["time"], **kw)
            torch.cuda.synchronize()
            out["render_single_s"] = time.perf_counter() - t0
            out["render_rel_err"] = {}
            for k in want:
                scale = want[k].abs().max().item()
                err = (got[k] - want[k]).abs().max().item() / scale
                out["render_rel_err"][k] = err
                print(f"  render {opt.H_lidar}x{opt.W_lidar} over {mesh.size} ranks vs one "
                      f"process, {k}: max relative error {err:.3e} (tolerance "
                      f"{PARALLEL_RENDER_RTOL:g})", flush=True)
                if not (torch.isfinite(got[k]).all() and err <= PARALLEL_RENDER_RTOL):
                    raise AssertionError(f"sharded render {k} disagrees: {err}")
    print(f"  rank {rank}: the frame rendered over {mesh.size} ranks in {out['render_s']:.3f} s"
          + (f" (one process: {out['render_single_s']:.3f} s)" if rank == 0 else ""), flush=True)
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def check_nccl_one_rank(field, params, ds, cache, opt, dev):
    """A process group of one rank on the card with NCCL and one sharded
    flagship step through it (every collective of the step runs), held
    against the single-process step on the same draws. Returns its loss gap."""
    import torch.distributed as dist

    from lidar4d_tpu_torch.parallel.mesh import make_mesh
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    signal = signal_params(params)
    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS)
    fc = flow_cache_to_device(cache, dev)
    with tempfile.TemporaryDirectory() as root, mlp_dtype(torch.float32):
        dist.init_process_group("nccl", init_method=f"file://{root}/rendezvous", world_size=1,
                                rank=0)
        try:
            from lidar4d_tpu_torch.interop import tree_to_torch

            state, optim = init_train_state(field, lr=LR, iters=ITERS,
                                            params=tree_to_torch(signal, dev))
            kw = dict(H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV, num_rays=TRAIN_RAYS,
                      num_coarse=opt.num_coarse, num_fine=opt.num_fine, seed=SEED)
            sharded = make_train_step(field, optim, loss_cfg, mesh=make_mesh(1), **kw)
            single = make_train_step(field, optim, loss_cfg, **kw)
            draws = sharded.draw()
            frame = ds.frame(0)
            ref = single.grads(state.params, frame, fc, draws, 0)
            got = sharded.grads(state.params, frame, fc, draws, 0)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()

    compare_steps("NCCL, 1 rank vs one process", field, signal, host_run(*got), host_run(*ref),
                  KERNEL_STEP_RTOL, KERNEL_STEP_GRAD_RTOL, post_step=False)
    m_got, m_ref = host_run(*got)[0], host_run(*ref)[0]
    return abs(m_got["loss"] - m_ref["loss"]) / abs(m_ref["loss"])


def run_parallel_ranks(ds, cache, world, backend, rtol=KERNEL_STEP_RTOL,
                       grad_rtol=KERNEL_STEP_GRAD_RTOL):
    """`world` ranks of `parallel_rank` on `backend`, joined within
    PARALLEL_TIMEOUT (killed and reported otherwise), the steps' metrics
    held to `rtol` and their gradients to `grad_rtol` by group. Returns
    (seconds with their start, each rank's results)."""
    from lidar4d_tpu_torch.parallel.launch import join_ranks, start_ranks

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        torch.save({"scale": ds.scale, "H": ds.H_lidar, "W": ds.W_lidar, "cache": cache,
                    "frames": [ds.frame(i) for i in range(STEP_FRAMES)], "rtol": rtol,
                    "grad_rtol": grad_rtol},
                   os.path.join(root, "inputs.pt"))
        t0 = time.perf_counter()
        procs = start_ranks(parallel_rank, (root,), world, f"file://{root}/rendezvous", backend)
        join_ranks(procs, PARALLEL_TIMEOUT)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    print(f"  {world} {backend} ranks on {torch.cuda.device_count()} card(s): {seconds:.1f} s "
          "with their start", flush=True)
    return seconds, [{"steps": r["steps"], "render_s": r["render_s"],
                      **{k: r[k] for k in ("render_single_s", "render_rel_err") if k in r}}
                     for r in ranks]


def check_parallel(field, params, ds, cache, opt, dev):
    """The parallel phase: PARALLEL_RANKS gloo ranks on the one card
    (`run_parallel_ranks`; NCCL takes one card a rank), then a one-rank NCCL
    group in this process. Returns the phase's summary."""
    ranks_s, ranks = run_parallel_ranks(ds, cache, PARALLEL_RANKS, "gloo")
    nccl_gap = check_nccl_one_rank(field, params, ds, cache, opt, dev)
    print(f"  NCCL one-rank step loss gap {nccl_gap:.3e}", flush=True)
    return {"ranks": PARALLEL_RANKS, "backend": "gloo", "steps": PARALLEL_STEPS,
            "ranks_s": ranks_s, "nccl_world_1_loss_gap": nccl_gap, "by_rank": ranks}


class TrainerProbe:
    """Instrumentation of the trainer phase: a Trainer subclass that records,
    stage by stage, seconds, kernel launches and (refine) peak memory, and
    timing wrappers around checkpoint writes and reads and the U-Net
    optimization. `installed()` swaps them in for the CLI and restores."""

    def __init__(self):
        self.stages = []          # (stage, seconds, launches) in order
        self.ckpt = {"save": [], "restore": []}
        self.refine_unet = {}

    @contextlib.contextmanager
    def installed(self):
        from lidar4d_tpu_torch.cli import main_lidar4d
        from lidar4d_tpu_torch.ops import _cuda
        from lidar4d_tpu_torch.train import trainer as trainer_mod
        from lidar4d_tpu_torch.train.checkpoints import CheckpointManager

        probe = self

        def staged(name, fn):
            def run(*args, **kwargs):
                before = dict(_cuda.LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                probe.stages.append((name, time.perf_counter() - t0,
                                     {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}))
                return out
            return run

        class ProbedTrainer(trainer_mod.Trainer):
            def _load_or_build_flow_cache(self, refine_ds):
                return staged("flow cache", super()._load_or_build_flow_cache)(refine_ds)

            def train_one_epoch(self, dataset, patch_size):
                return staged("epoch", super().train_one_epoch)(dataset, patch_size)

            def evaluate_one_epoch(self, dataset, name=None):
                return staged("evaluate", super().evaluate_one_epoch)(dataset, name)

            def refine(self, dataset):
                return staged("refine", super().refine)(dataset)

            def test(self, dataset, **kwargs):
                return staged("test", super().test)(dataset, **kwargs)

        def timed(kind, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                probe.ckpt[kind].append(time.perf_counter() - t0)
                return out
            return run

        def refine_unet(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = saved["refine_unet"](*args, **kwargs)
            torch.cuda.synchronize()
            probe.refine_unet = {"seconds": time.perf_counter() - t0,
                                 "steps": kwargs["steps"],
                                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                 "batch": tuple(args[2].shape)}
            return out

        saved = {"Trainer": main_lidar4d.Trainer, "refine_unet": trainer_mod.refine_unet,
                 "_save": CheckpointManager._save, "restore": CheckpointManager.restore}
        main_lidar4d.Trainer = ProbedTrainer
        trainer_mod.refine_unet = refine_unet
        CheckpointManager._save = timed("save", saved["_save"])
        CheckpointManager.restore = timed("restore", saved["restore"])
        try:
            yield
        finally:
            main_lidar4d.Trainer = saved["Trainer"]
            trainer_mod.refine_unet = saved["refine_unet"]
            CheckpointManager._save = saved["_save"]
            CheckpointManager.restore = saved["restore"]


def feed_meters(meters, raydrop, intensity, depth, mask, gt):
    """Update the four meters with one frame as evaluate_one_epoch does."""
    gt_raydrop = gt[..., 0]
    meters[0].update(raydrop[None], gt_raydrop[None])
    meters[1].update((intensity * mask)[None], (gt[..., 1] * gt_raydrop)[None])
    meters[2].update((depth * mask)[None], (gt[..., 2] * gt_raydrop)[None])
    meters[3].update((depth * mask)[None], (gt[..., 2] * gt_raydrop)[None])
    return [np.asarray(m.measure(), np.float64) for m in meters]


def check_meters_card_vs_cpu(trainer, opt, val_ds, dev):
    """One val frame rendered on the card, refined as evaluate refines it,
    through the meters on the card and on the CPU: equal to METER_RTOL."""
    from lidar4d_tpu_torch.eval.meters import (
        DepthMeter, IntensityMeter, PointsMeter, RaydropMeter)

    def meters(device):
        return [RaydropMeter(ratio=opt.raydrop_ratio),
                IntensityMeter(scale=opt.intensity_scale, device=device),
                DepthMeter(scale=opt.scale, device=device),
                PointsMeter(scale=opt.scale, intrinsics=opt.fov_lidar, device=device)]

    params = trainer._eval_params()
    raydrop, intensity, depth = trainer._render_frame(params, val_ds, 0)
    raydrop = trainer._apply_refine(params, raydrop, intensity, depth)
    mask = (raydrop > 0.5).astype(np.float32)
    gt = np.asarray(val_ds.images_lidar[0])
    card = feed_meters(meters(dev), raydrop, intensity, depth, mask, gt)
    cpu = feed_meters(meters("cpu"), raydrop, intensity, depth, mask, gt)
    worst = 0.0
    for name, a, b in zip(("raydrop", "intensity", "depth", "points"), card, cpu):
        same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        rel = np.where(same_inf, 0.0, np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
        worst = max(worst, float(rel.max()))
        print(f"  meters on one val frame, {name}: card {a.tolist()} cpu {b.tolist()}, max rel "
              f"{rel.max():.3e} (tolerance {METER_RTOL:g})", flush=True)
        if not (rel.max() <= METER_RTOL):
            raise AssertionError(f"{name} meter on the card differs from the CPU: {rel.max()}")
    return worst


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_trainer(root, scale, offset, dev):
    """The port's training entry point, `cli.main_lidar4d.main`, on the card:
    the flagship config on the synthetic scene (written by the CLI into
    `root`/scene), TRAINER_EPOCHS epochs, then refine, evaluate and test in
    the workspace `root`/workspace; then a second `main` with --test_eval
    --ckpt latest in the same workspace, which must reproduce the first
    run's eval meters exactly; then one val frame's meters on the card
    against the CPU. Returns the phase's summary."""
    from lidar4d_tpu_torch.cli import main_lidar4d
    from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset

    probe = TrainerProbe()
    scene, ws = f"{root}/scene", f"{root}/workspace"
    # the synthetic scene holds every 5th frame out for val / test
    n_train = sum(1 for f in range(SCENE["num_frames"]) if f % 5 != 4)
    argv = ["--config", CONFIG, "--dataloader", "synthetic", "--path", scene,
            "--sequence_id", SCENE["sequence_id"], "--num_frames", str(SCENE["num_frames"]),
            "--synthetic_H", str(SCENE["H"]), "--synthetic_W", str(SCENE["W"]),
            "--synthetic_seed", str(SCENE["seed"]), "--scale", repr(scale),
            "--offset", *map(repr, offset), "--workspace", ws,
            "--iters", str(TRAINER_EPOCHS * n_train), "--hier_warmup_iters", str(n_train),
            "--eval_interval", "2", "--seed", str(SEED), "--device", str(dev)]
    t0 = time.perf_counter()
    with probe.installed():
        first = main_lidar4d.main(argv + ["--ckpt", "scratch"])
        t_first = time.perf_counter() - t0
        records = read_jsonl(first.metrics_path)
        names = sorted(os.listdir(first.ckpt.ckpt_dir))
        t1 = time.perf_counter()
        second = main_lidar4d.main(argv + ["--ckpt", "latest", "--test_eval"])
        t_second = time.perf_counter() - t1
    opt = first.opt
    val_ds = KITTI360Dataset(split="val", root_path=scene, sequence_id=SCENE["sequence_id"],
                             scale=opt.scale, offset=opt.offset, fov_lidar=opt.fov_lidar)
    n_test = len(KITTI360Dataset(split="test", root_path=scene,
                                 sequence_id=SCENE["sequence_id"], scale=opt.scale,
                                 offset=opt.offset))
    meter_rel = check_meters_card_vs_cpu(second, opt, val_ds, dev)
    with open(first.log_path) as f:
        bce = [(int(line.split()[2][:-1]), float(line.split()[-1])) for line in f
               if line.startswith("refine iter ")]
    records2 = read_jsonl(second.metrics_path)

    epochs = [r for r in records if "rays_per_sec" in r]
    evals = [r for r in records if "valid_loss" in r]
    failures = []
    for r in epochs:
        print(f"  epoch {r['epoch']}: {r['sampler']} sampler, patch {r['patch']}: loss "
              f"{r['loss']:.6f}, {r['rays_per_sec']:.1f} train rays/s", flush=True)
        if not np.isfinite(r["loss"]):
            failures.append(f"epoch {r['epoch']} loss {r['loss']}")
    want_modes = [("uniform", "1"), ("hierarchical", "2x8"), ("hierarchical", "1")]
    if [(r["sampler"], r["patch"]) for r in epochs] != want_modes:
        failures.append(f"epoch modes {[(r['sampler'], r['patch']) for r in epochs]}")

    stage_launch = {}
    for stage, _, launches in probe.stages:
        acc = stage_launch.setdefault(stage, {k: 0 for k in launches})
        for k, v in launches.items():
            acc[k] += v
    print("  kernel launches by stage " + json.dumps(stage_launch), flush=True)
    for name in TRAIN_KERNELS:
        if stage_launch["epoch"][name] <= 0:
            failures.append(f"{name} was not launched in the train epochs")
    for name, count in stage_launch["evaluate"].items():
        if (count <= 0) if name.endswith("_fwd") else (count != 0):
            failures.append(f"{name}: {count} launches in evaluation")

    if len(bce) < 2 or not bce[-1][1] < bce[0][1]:
        failures.append(f"the U-Net's BCE did not fall over refine: {bce}")
    print(f"  refine BCE by step: {bce[0]} ... {bce[-1]} ({len(bce)} log lines)", flush=True)
    final = evals[-1]
    print("  first run's last eval record " + json.dumps(final), flush=True)
    if not np.isfinite(final["PointsMeter"]).all():
        failures.append(f"CD / F-score not finite: {final['PointsMeter']}")
    if len(evals) != 2:
        failures.append(f"{len(evals)} eval records in the first run, not 2")
    resumed = [r for r in records2 if "valid_loss" in r][-1]
    print("  resumed run's eval record " + json.dumps(resumed), flush=True)
    if resumed != final:
        failures.append("the resumed run's eval record differs from the first run's")
    want = {f"lidar4d_ep{TRAINER_EPOCHS:04d}", f"lidar4d_ep{TRAINER_EPOCHS:04d}_refine"}
    if first.stats["best_result"] is not None:
        want.add("lidar4d_best")
    print(f"  checkpoints {names} (best result {first.stats['best_result']})", flush=True)
    if names != sorted(want):
        failures.append(f"checkpoint names {names}, expected {sorted(want)}")

    seconds = {stage: [round(t, 3) for s, t, _ in probe.stages if s == stage]
               for stage in ("flow cache", "epoch", "evaluate", "refine", "test")}
    ref = probe.refine_unet
    refine_ms = ref["seconds"] / ref["steps"] * 1e3
    print(f"  seconds by stage {json.dumps(seconds)}; first run {t_first:.1f} s, resumed run "
          f"{t_second:.1f} s", flush=True)
    print(f"  eval of the last run, s/frame: " + json.dumps(
        {k: round(v / second.eval_seconds["frames"], 4) for k, v in second.eval_seconds.items()
         if k != "frames"}), flush=True)
    print(f"  refine: {ref['steps']} steps on {ref['batch']} in {ref['seconds']:.1f} s, "
          f"{refine_ms:.2f} ms/step, peak memory {ref['peak_gib']:.2f} GiB", flush=True)
    print(f"  test s/frame {[round(t / n_test, 4) for t in seconds['test']]}", flush=True)
    ckpt_s = {k: [round(v, 4) for v in vs] for k, vs in probe.ckpt.items()}
    print(f"  checkpoint seconds {json.dumps(ckpt_s)}", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return {
        "epochs": [{k: r[k] for k in ("epoch", "sampler", "patch", "loss", "rays_per_sec")}
                   for r in epochs],
        "eval_s_per_frame": {k: v / second.eval_seconds["frames"]
                             for k, v in second.eval_seconds.items() if k != "frames"},
        "eval": final, "resume_exact": resumed == final, "meters_card_vs_cpu": meter_rel,
        "refine_ms_per_step": refine_ms, "refine_peak_gib": ref["peak_gib"],
        "refine_bce": [bce[0][1], bce[-1][1]],
        "test_s_per_frame": [t / n_test for t in seconds["test"]],
        "checkpoint_s": ckpt_s, "stage_s": seconds, "launches": stage_launch,
        "seconds": {"first_run": t_first, "resumed_run": t_second},
    }


def sim_argv(root, scale, offset, dev):
    """The simulation CLI's flags for the trainer phase's field and scene."""
    return ["--config", CONFIG, "--path", f"{root}/scene", "--sequence_id", SCENE["sequence_id"],
            "--num_frames", str(SCENE["num_frames"]), "--scale", repr(scale),
            "--offset", *map(repr, offset), "--seed", str(SEED), "--device", str(dev)]


def fresh_process_backends():
    """torch.backends' matmul / cuDNN TF32 switches as a fresh process has
    them (this script turns both off)."""
    code = ("import json, torch; print(json.dumps([torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    return json.loads(out.strip().splitlines()[-1])


@contextlib.contextmanager
def backends(matmul_tf32, cudnn_tf32):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul_tf32, cudnn_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run_sim_cli(argv):
    """`python -m lidar4d_tpu_torch.cli.main_lidar4d_sim argv` in a fresh
    process; returns (wall seconds, its printed render line's s/frame, its
    printed kernel launches, the checkpoint it loaded)."""
    import ast

    cmd = [sys.executable, "-m", "lidar4d_tpu_torch.cli.main_lidar4d_sim", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"simulation CLI failed ({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    rendered = [line for line in proc.stdout.splitlines() if line.startswith("[INFO] rendered")]
    loaded = [line.split("Loading ")[1].split()[0] for line in proc.stdout.splitlines()
              if line.startswith("[INFO] Loading")]
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "rendered" in line or "Loading" in line or "WARN" in line or "Warning" in line:
            print("  cli: " + line.strip()[:240], flush=True)
    line = rendered[-1]
    s_frame = float(line.split("(")[1].split(" s/frame")[0])
    launches = ast.literal_eval(line.split("kernel launches ")[1])
    return wall, s_frame, launches, (loaded[-1] if loaded else None)


def check_launches(what, launches):
    for name, count in launches.items():
        if (count <= 0) if name.endswith("_fwd") else (count != 0):
            raise AssertionError(f"{what}: kernel {name} launched {count} times")


def check_clouds(what, clouds, n_frames, H, W, min_points=1):
    if len(clouds) != n_frames:
        raise AssertionError(f"{what}: {len(clouds)} point clouds, not {n_frames}")
    for i, c in enumerate(clouds):
        if c.ndim != 2 or c.shape[1] != 4 or not min_points <= len(c) <= H * W \
                or not np.isfinite(c).all():
            raise AssertionError(f"{what}: frame {i} is not a finite [M, 4] cloud, "
                                 f"{min_points} <= M <= {H * W}: {c.shape}")


def read_clouds(ws):
    d = os.path.join(ws, "points")
    return [np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))]


def check_simulate(root, scale, offset, dev):
    """The simulation CLI on the trainer phase's refined field: 66x1030 with
    the U-Net refine in a fresh process, held bitwise against the same render
    in this process; then --kitti2nus (32x1024, no refine) in a fresh process
    and in this process, also bitwise. Returns the phase's summary."""
    from lidar4d_tpu_torch.cli import main_lidar4d_sim
    from lidar4d_tpu_torch.cli.config import build_model_config
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays, shift_trajectory
    from lidar4d_tpu_torch.train.checkpoints import CheckpointManager

    fresh = fresh_process_backends()
    print(f"  a fresh process's TF32 switches (matmul, cuDNN): {fresh}; this process's are "
          f"({torch.backends.cuda.matmul.allow_tf32}, {torch.backends.cudnn.allow_tf32})",
          flush=True)
    base = sim_argv(root, scale, offset, dev)
    trained = f"{root}/workspace"
    refine_ckpt = os.path.join(trained, "checkpoints", f"lidar4d_ep{TRAINER_EPOCHS:04d}_refine")
    out = {"checkpoint": os.path.basename(refine_ckpt), "backends_fresh": fresh}

    # 1. the config's sensor (66x1030) with the refine: a fresh process, then this one
    wall, s_frame, launches, loaded = run_sim_cli(base + ["--workspace", trained,
                                                          "--ckpt", "latest_model"])
    if loaded != refine_ckpt:
        raise AssertionError(f"latest_model resolved to {loaded}, not {refine_ckpt}")
    check_launches("simulation CLI", launches)
    cli_clouds = read_clouds(trained)
    opt = main_lidar4d_sim.get_sim_arg_parser().parse_args(base)
    n_frames, H, W = SCENE["num_frames"], opt.H_lidar, opt.W_lidar
    check_clouds("simulation CLI", cli_clouds, n_frames, H, W)
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = CheckpointManager(trained).restore(refine_ckpt, dev)["params"]
    poses, times = main_lidar4d_sim._sequence_poses_times(opt)
    rays_o, rays_d = build_novel_rays(poses, H, W, opt.fov_lidar)
    rays_o = shift_trajectory(rays_o, 0.0, 0.0, 0.0, opt.scale)
    sim = Simulator("lidar4d", opt, field, params, workspace=f"{root}/sim_inproc",
                    use_refine=True, H_lidar=H, W_lidar=W, device=dev)
    with backends(*fresh):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.render(rays_o, rays_d, times, save_img=False, save_video=False)
        torch.cuda.synchronize()
        inproc_s = (time.perf_counter() - t0) / n_frames
        inproc_launches = dict(_cuda.LAUNCHES)
    check_launches("in-process render", inproc_launches)
    mine = read_clouds(f"{root}/sim_inproc")
    differ = [i for i, (a, b) in enumerate(zip(cli_clouds, mine))
              if a.shape != b.shape or not np.array_equal(a, b)]
    print(f"  {H}x{W}, {n_frames} frames, U-Net refine: CLI in a fresh process {wall:.1f} s "
          f"wall, {s_frame:.4f} s/frame rendering; in this process {inproc_s:.4f} s/frame; "
          f"points a frame {np.mean([len(c) for c in mine]):.1f}; frames not bitwise equal "
          f"{differ}; launches CLI {launches}, here {inproc_launches}", flush=True)
    if differ:
        i = differ[0]
        a, b = cli_clouds[i], mine[i]
        gap = (np.abs(a - b).max() if a.shape == b.shape else f"{a.shape} vs {b.shape}")
        raise AssertionError(f"the fresh process's render differs from this process's in "
                             f"frames {differ}; frame {i}: {gap}")
    out[f"{H}x{W}"] = {"frames": n_frames, "cli_wall_s": wall, "cli_s_per_frame": s_frame,
                      "inproc_s_per_frame": inproc_s, "cli_launches": launches,
                      "inproc_launches": inproc_launches, "bitwise_equal": True,
                      "points_per_frame": float(np.mean([len(c) for c in mine]))}

    # 2. --kitti2nus: 32x1024, no refine, shifted and aligned
    k2n = base + ["--ckpt", refine_ckpt, "--kitti2nus", "--shift_y", "0.5", "--align_axis"]
    wall, s_frame, launches, _ = run_sim_cli(k2n + ["--workspace", f"{root}/sim_k2n_cli"])
    check_launches("simulation CLI kitti2nus", launches)
    cli_clouds = read_clouds(f"{root}/sim_k2n_cli")
    check_clouds("simulation CLI kitti2nus", cli_clouds, n_frames, 32, 1024)
    with backends(*fresh):
        t0 = time.perf_counter()
        sim = main_lidar4d_sim.main(k2n + ["--workspace", f"{root}/sim_k2n"])
        inproc_wall = time.perf_counter() - t0
        inproc_launches = dict(_cuda.LAUNCHES)
    check_launches("in-process kitti2nus", inproc_launches)
    if sim.use_refine or (sim.H_lidar, sim.W_lidar) != (32, 1024):
        raise AssertionError(f"kitti2nus: refine {sim.use_refine}, {sim.H_lidar}x{sim.W_lidar}")
    mine = read_clouds(f"{root}/sim_k2n")
    differ = [i for i, (a, b) in enumerate(zip(cli_clouds, mine))
              if a.shape != b.shape or not np.array_equal(a, b)]
    print(f"  kitti2nus 32x1024, {n_frames} frames, no refine: CLI in a fresh process "
          f"{wall:.1f} s wall, {s_frame:.4f} s/frame rendering; main() in this process "
          f"{inproc_wall:.1f} s; points a frame {np.mean([len(c) for c in mine]):.1f}; frames "
          f"not bitwise equal {differ}; launches CLI {launches}, here {inproc_launches}",
          flush=True)
    if differ:
        raise AssertionError(f"kitti2nus: the fresh process's render differs in frames {differ}")
    out["32x1024"] = {"frames": n_frames, "cli_wall_s": wall, "cli_s_per_frame": s_frame,
                      "inproc_wall_s": inproc_wall, "cli_launches": launches,
                      "inproc_launches": inproc_launches, "bitwise_equal": True,
                      "points_per_frame": float(np.mean([len(c) for c in mine]))}
    return out


def write_raw_kitti360(root, points, seed=SEED):
    """A raw KITTI-360 tree for sequence 1538 (64 frames; the layout of
    tests/test_preprocess.py: poses.txt with frames 1550-1551 missing, the two
    calibration files, velodyne .bin scans of `points` points)."""
    k3 = os.path.join(root, "KITTI-360")
    seq = "2013_05_28_drive_0000_sync"
    lidar_dir = os.path.join(k3, "data_3d_raw", seq, "velodyne_points", "data")
    for d in (os.path.join(k3, "calibration"), os.path.join(k3, "data_poses", seq), lidar_dir):
        os.makedirs(d)
    rng = np.random.default_rng(seed)
    cam_to_pose = np.hstack([np.eye(3), [[0.8], [0.3], [-0.1]]])
    with open(os.path.join(k3, "calibration", "calib_cam_to_pose.txt"), "w") as f:
        for cam in ("image_00", "image_01"):
            f.write(f"{cam}: " + " ".join(str(v) for v in cam_to_pose.reshape(-1)) + "\n")
    with open(os.path.join(k3, "calibration", "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(str(v) for v in np.hstack([np.eye(3), [[0.3], [0.0], [0.2]]]).reshape(-1))
                + "\n")
    lines = []
    for fid in range(1538, 1602):
        if fid not in (1550, 1551):
            pose = np.hstack([np.eye(3), [[0.5 * (fid - 1538)], [0.0], [0.0]]])
            lines.append(np.concatenate([[fid], pose.reshape(-1)]))
    np.savetxt(os.path.join(k3, "data_poses", seq, "poses.txt"), np.stack(lines))
    for fid in range(1538, 1602):
        az = rng.uniform(-np.pi, np.pi, points)
        el = rng.uniform(np.radians(-24.9), np.radians(2.0), points)
        r = rng.uniform(3, 90, points)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el), rng.uniform(0, 1, points)], axis=1).astype(np.float32)
        pts.tofile(os.path.join(lidar_dir, f"{fid:010d}.bin"))
    return lidar_dir


def ckdtree_kept(points, k=64, ratio=3.0):
    """The JAX package's cKDTree outlier removal (one worker), the reference
    path the others are counted against."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1)
    mean_d = d[:, 1:].mean(axis=1)
    return points[mean_d < mean_d.mean() + ratio * mean_d.std()]


def check_preprocess(root, scale, offset):
    """Host work: the preprocessing CLI on a raw KITTI-360 tree of scans at a
    real scan's size, the native extension built with this machine's g++ and
    held against numpy, and the three outlier-removal paths on the synthetic
    scene's first OUTLIER_FRAMES refine frames. Returns the phase's summary."""
    from lidar4d_tpu_torch import native
    from lidar4d_tpu_torch.cli import preprocess as preprocess_cli
    from lidar4d_tpu_torch.cli.config import get_arg_parser
    from lidar4d_tpu_torch.data import preprocess
    from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
    from lidar4d_tpu_torch.ops.pano import lidar_to_pano_with_intensities, pano_to_lidar
    from lidar4d_tpu_torch.utils.pointcloud import range_filter, statistical_outlier_removal

    out = {}
    raw = f"{root}/kitti360_raw"
    t0 = time.perf_counter()
    lidar_dir = write_raw_kitti360(raw, RAW_SCAN_POINTS)
    out["write_raw_s"] = time.perf_counter() - t0
    steps = {}
    saved = {n: getattr(preprocess, n) for n in ("generate_rangeview", "kitti360_to_nerf",
                                                 "cal_seq_config")}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            r = fn(*args, **kwargs)
            steps[name] = time.perf_counter() - t
            return r
        return run

    for name, fn in saved.items():
        setattr(preprocess, name, timed(name, fn))
    try:
        preprocess_cli.main(["--dataset", "kitti360", "--sequence_id", "1538", "--path", raw,
                             "--configs_dir", f"{root}/configs"])
    finally:
        for name, fn in saved.items():
            setattr(preprocess, name, fn)
    cfg = get_arg_parser().parse_args(["--config", f"{root}/configs/kitti360_1538.txt"])
    ds = KITTI360Dataset(split="train", root_path=cfg.path, sequence_id=cfg.sequence_id,
                         scale=cfg.scale, offset=cfg.offset)
    print(f"  preprocess CLI, 64 scans of {RAW_SCAN_POINTS} points at 66x1030, seconds by step "
          f"{json.dumps({k: round(v, 3) for k, v in steps.items()})}; train split {len(ds)} "
          f"frames {ds.images_lidar.shape}, scale {cfg.scale}, offset {cfg.offset}", flush=True)
    if (len(ds) != 60 or ds.images_lidar.shape[1:3] != (66, 1030)
            or not np.isfinite(ds.images_lidar).all()
            or not np.abs(ds.poses_lidar[:, :3, 3]).max() <= 1.0 + 1e-6):
        raise AssertionError("the preprocessed sequence does not load as 60 finite 66x1030 "
                             "frames with poses in the unit box")
    out["steps_s"] = steps

    t0 = time.perf_counter()
    so = native.build()
    native.library()
    out["native_build_s"] = time.perf_counter() - t0
    scan = np.fromfile(os.path.join(lidar_dir, "0000001538.bin"), np.float32).reshape(-1, 4)
    want = lidar_to_pano_with_intensities(scan, 66, 1030, FOV)
    got = native.lidar_to_pano_native(scan, 66, 1030, *FOV)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    print(f"  native library {so.name} built in {out['native_build_s']:.2f} s; pano of one "
          f"scan, native vs numpy: max abs error {err:.3e} (tolerance 1e-6 relative)",
          flush=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    out["native_pano_max_abs_err"] = err

    refine = KITTI360Dataset(split="refine", root_path=f"{root}/scene",
                             sequence_id=SCENE["sequence_id"], scale=scale, offset=offset)
    clouds = []
    for img in refine.images_lidar[:OUTLIER_FRAMES]:
        depth = np.asarray(img[..., 2] * img[..., 0], np.float64) / scale
        clouds.append(range_filter(pano_to_lidar(depth, refine.intrinsics_lidar))[:, :3])
    paths = {"cKDTree": ckdtree_kept,
             "cKDTree workers=-1": statistical_outlier_removal,
             "native": functools.partial(statistical_outlier_removal, use_native=True)}
    outliers = {}
    for name, fn in paths.items():
        t0 = time.perf_counter()
        kept = [fn(c) for c in clouds]
        outliers[name] = {"s_per_frame": (time.perf_counter() - t0) / len(clouds),
                          "kept": [len(k) for k in kept], "kept_sets": kept}
    ref = outliers["cKDTree"]["kept_sets"]
    for name, r in outliers.items():
        kept = r.pop("kept_sets")
        r["differ_from_cKDTree"] = [len({tuple(p) for p in a} ^ {tuple(p) for p in b})
                                    for a, b in zip(kept, ref)]
        print(f"  outlier removal, {name}: {r['s_per_frame']:.3f} s/frame over "
              f"{len(clouds)} frames of {np.mean([len(c) for c in clouds]):.0f} points; kept "
              f"{r['kept']}; points differing from cKDTree's kept set "
              f"{r['differ_from_cKDTree']}", flush=True)
    if any(outliers["cKDTree workers=-1"]["differ_from_cKDTree"]):
        raise AssertionError("workers=-1 changed the kept set")
    out["outlier_removal"] = outliers
    out["outlier_points_per_frame"] = [len(c) for c in clouds]
    return out


# reference phase: configs/kitti360_4950.txt at the CLI defaults (the paper's
# configuration and the default of both CLIs: 2^19-row hash tables, dense
# 32^2..256^2 static planes, 768 uniform samples), on the synthetic scene
REFERENCE_CONFIG = "configs/kitti360_4950.txt"
REFERENCE_WARMUP, REFERENCE_TIMED = 1, 3
REFERENCE_FRAME_T = 0.3
# a 4,096-ray chunk of the render, card kernels vs card plain versions, both
# with float32 MLPs: each output within this of the plain output's largest
# magnitude (the kernels' forward gaps are <= 1e-6)
REFERENCE_CHUNK_RTOL = 1e-5
# the port's hash-encode routes, by the module global its dispatch calls
ENCODE_ROUTES = (("hash_onehot", "hash_encode_onehot_fact", "factorized"),
                 ("hash_onehot", "hash_encode_onehot", "classic"),
                 ("hash_onehot", "hash_encode_folded", "folded"),
                 ("hash_field", "hash_encode_fact_multi_folded", "folded, variants fused"))


@contextlib.contextmanager
def recording_kernel_calls(calls):
    """Every kernel wrapper appends (name, arguments, keyword arguments) to
    `calls`, tensors cloned, and runs."""
    def keep(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def make(name, fn):
        def run(*args, **kwargs):
            calls.append((name, [keep(a) for a in args], {k: keep(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)
        return run

    with swapped_kernels(make):
        yield calls


@contextlib.contextmanager
def spying_encode_routes(routes):
    """Each hash-encode route of the port's dispatch (ENCODE_ROUTES)
    appends (route, spec) to `routes` and runs."""
    from lidar4d_tpu_torch.models import hash_field
    from lidar4d_tpu_torch.ops import hash_onehot

    mods = {"hash_onehot": hash_onehot, "hash_field": hash_field}
    saved = [(mods[m], name, getattr(mods[m], name), route) for m, name, route in ENCODE_ROUTES]
    for mod, name, fn, route in saved:
        def spy(spec, *args, _fn=fn, _route=route):
            routes.append((_route, spec))
            return _fn(spec, *args)
        setattr(mod, name, spy)
    try:
        yield routes
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)


def encoder_names(field):
    """{spec: encoder name} of the field's hash encodes and of their folded
    specs."""
    from lidar4d_tpu_torch.ops.hash_onehot import _folded_spec

    enc, flow = field.hash_encoder, field.flow_net
    named = [("static hash", enc.static_spec, enc.num_basis)]
    named += [(f"dynamic hash {xy}", enc.dynamic_spec(p), enc.num_basis)
              for p, xy in enumerate(("xy", "xz", "yz"))]
    named.append(("flow grid", flow.grid_spec, flow.num_basis))
    names = {}
    for name, spec, basis in named:
        names.setdefault(spec, []).append(name)
        if spec.n_features % basis == 0:
            names.setdefault(_folded_spec(spec, basis), []).append(f"{name}, folded")
    return {spec: " / ".join(dict.fromkeys(v)) for spec, v in names.items()}


def call_label(names, name, args):
    """A recorded kernel call in words: the encoder or planes and the shapes."""
    if name.startswith("hash_"):
        spec, xs = args[0], args[2] if name == "hash_grid_fwd" else args[1]
        return (f"{names.get(spec, 'hash')}: {spec.n_dims}D L={spec.n_levels} "
                f"F={spec.n_features} rows {max(spec.table_sizes)} V={xs.shape[0]} "
                f"N={xs.shape[1]}")
    if name == "plane_bilinear_bwd":
        return f"dense static planes {tuple(args[0].shape[:1])}x{tuple(args[2])} " \
               f"C={args[1].shape[1]} N={args[0].shape[1]}"
    grid, pts = args[0], args[1]
    return f"{'time' if name.startswith('plane_linear') else 'dense static'} planes " \
           f"{tuple(grid.shape)} N={pts.shape[1]}"


def call_flops(name, args, kwargs, outs):
    """Operations of one kernel call, counted as the earlier phases count
    them."""
    if name.startswith("hash_"):
        spec, xs = args[0], args[2] if name == "hash_grid_fwd" else args[1]
        return 2 * xs.shape[0] * xs.shape[1] * spec.n_levels * (1 << spec.n_dims) \
            * spec.n_features
    if name == "plane_bilinear_fwd":
        return 2 * 4 * outs[0].numel()
    if name == "plane_bilinear_bwd":
        return 2 * 4 * args[1].numel()
    if name == "plane_linear_fwd":
        return 2 * 2 * outs[0].numel()
    if name == "plane_linear_bwd":
        grid, cot = args[0], args[2]
        lead = args[3] if len(args) > 3 else kwargs.get("lead", 0)
        return 4 * cot.numel() + 3 * cot.numel() * (grid.shape[0] - lead) // grid.shape[0]
    return 24 * args[2].numel()                                      # plane_bilinear_vjp


# the coordinates' place among each backward kernel's arguments
COORD_ARG = {"hash_grid_bwd": 1, "plane_bilinear_bwd": 0, "plane_bilinear_vjp": 1,
             "plane_linear_bwd": 1}


def recorded_cases(field, calls):
    """(check_case case, exact, route) of each recorded kernel call, on its
    own arguments: the kernel against its plain version, a backward kernel
    against its plain version with tables and cotangents in float64 (exact;
    the coordinates stay float32, so that every point keeps the kernel's
    cell, and with it a coordinate gradient that is a slope of that cell);
    bytes = every input read once and every output written once (with the
    hash kernels' level table); route = the route the call's launch plan
    took, by the wrapper's route counter (None where the kernel has one
    route). The kernel is looked up at each call, so that a caller may swap
    it for another build."""
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.ops import hash_onehot as ho

    names = encoder_names(field)
    for name, args, kwargs in calls:
        mod = kernel_module(name)
        run = functools.partial(lambda m, k, *a, **kw: getattr(m, k)(*a, **kw), mod, name,
                                *args, **kwargs)
        plain = functools.partial(getattr(mod, PLAIN_VERSIONS[name]), *args, **kwargs)
        before = collections.Counter(_cuda.ROUTE_LAUNCHES)
        outs = run()
        routes = [r for (k, r) in _cuda.ROUTE_LAUNCHES - before if k == name]
        outs = outs if isinstance(outs, tuple) else (outs,)
        tensors = [a for a in (*args, *kwargs.values()) if torch.is_tensor(a)]
        if name.startswith("hash_"):
            tensors.append(ho._level_table(args[0], outs[0].device))
        case = (name, call_label(names, name, args), run, plain, None,
                nbytes(*tensors, *outs), call_flops(name, args, kwargs, outs))
        if name == "plane_bilinear_vjp":
            case += (functools.partial(vjp_zeros, *args),)
        del outs
        exact = None
        if name in COORD_ARG:
            wide = [a.double() if torch.is_tensor(a) and a.is_floating_point()
                    and i != COORD_ARG[name] else a for i, a in enumerate(args)]
            exact = functools.partial(getattr(mod, PLAIN_VERSIONS[name]), *wide, **kwargs)
        yield case, exact, routes[0] if len(routes) == 1 else None


def per_density_call(field):
    """Kernel launches of one density call of `field` (no flow loss)."""
    return {k: v - launches_per_step(field, density_calls=0)[k]
            for k, v in launches_per_step(field, density_calls=1).items()}


def record_reference_step(field, signal_t, ds, cache, opt, dev):
    """One reference step (TRAIN_RAYS rays, opt's uniform samples, the flow
    loss) on O(0.1-1) parameters with every kernel call and every
    hash-encode route recorded. Returns (calls, routes)."""
    from lidar4d_tpu_torch.train.losses import LossConfig
    from lidar4d_tpu_torch.train.train_step import (
        flow_cache_to_device, init_train_state, make_train_step)

    loss_cfg = LossConfig(flow_loss=True, grad_loss=True, scale=ds.scale,
                          num_frames=field.cfg.num_frames, iters=ITERS)
    state, optim = init_train_state(field, lr=LR, iters=ITERS, params=signal_t)
    step = make_train_step(field, optim, loss_cfg, H=ds.H_lidar, W=ds.W_lidar, fov_lidar=FOV,
                           num_rays=TRAIN_RAYS, patch_size=1, num_steps=opt.num_steps,
                           num_coarse=opt.num_coarse, num_fine=opt.num_fine, seed=SEED)
    calls, routes = [], []
    with recording_kernel_calls(calls), spying_encode_routes(routes):
        step.grads(state.params, ds.frame(0), flow_cache_to_device(cache, dev), step.draw(), 0)
    return calls, routes


# The routes the reference's largest tables take (ops/hash_onehot.py's
# launch plans), by kernel and encoder: the forward's tile path (the gather
# path below its fewest points) for tables over the L2, with its resident
# floor; the xy planes' tile path; the backward's vector route.
REFERENCE_ROUTES = {"hash_grid_fwd": {"static hash": ("tile over L2",),
                                      "flow grid": ("tile over L2", "gather over L2"),
                                      "dynamic hash xy": ("tile",)},
                    "hash_grid_bwd": {"static hash": ("vector",), "flow grid": ("vector",),
                                      "dynamic hash xy": ("vector",)}}


def check_reference_kernels(field, signal_t, ds, cache, opt, dev):
    """One reference step (`record_reference_step`); then each recorded
    call, forward and backward, held against its plain version on its own
    inputs and timed beside its bound, every static hash, flow grid and xy
    call held to its route in REFERENCE_ROUTES. Returns (routes by encoder,
    the calls' rows, the per-kernel sums)."""
    calls, routes = record_reference_step(field, signal_t, ds, cache, opt, dev)
    names, basis = encoder_names(field), field.hash_encoder.num_basis
    by_encoder = {}
    for route, spec in routes:
        f = f"F'={spec.n_features // basis}" if route.startswith("folded") \
            else f"F={spec.n_features}"
        key = f"{route} at {f}, {max(spec.table_sizes)} rows a level"
        enc = by_encoder.setdefault(names.get(spec, str(spec)), {})
        enc[key] = enc.get(key, 0) + 1
    print("  hash-encode routes of one reference step (calls): " + json.dumps(by_encoder),
          flush=True)
    counts = {name: sum(1 for c in calls if c[0] == name) for name in PLAIN_VERSIONS}
    want = launches_per_step(field, density_calls=1)
    print(f"  kernel calls of the step {json.dumps(counts)} (expected {json.dumps(want)})",
          flush=True)
    if counts != want:
        raise AssertionError(f"the reference step's kernel calls {counts}, expected {want}")
    if any(route.startswith(("factorized", "folded, variants")) for route, _ in routes):
        raise AssertionError("a reference encoder took a flagship route: "
                             + json.dumps(by_encoder))
    summary, rows, wrong = {}, [], []
    with torch.no_grad():
        for (name, args, _), (case, exact, route) in zip(calls, recorded_cases(field, calls)):
            row = check_case(case, summary, True, 5, 1, exact)
            enc = names.get(args[0]) if name.startswith("hash_") else None
            want_route = REFERENCE_ROUTES.get(name, {}).get(enc)
            row["route"] = route
            if route is not None:
                print(f"    route {route}" + (f" (must be {' or '.join(want_route)})"
                                              if want_route else ""), flush=True)
            if want_route is not None and route not in want_route:
                wrong.append(f"{case[1]}: route {route}, must be {' or '.join(want_route)}")
            rows.append(row)
    del calls
    torch.cuda.empty_cache()
    if wrong:
        raise AssertionError("reference calls off their routes: " + "; ".join(wrong))
    return by_encoder, rows, finish(summary)


def check_reference_render(field, signal_t, opt, dev):
    """One 66x1030 frame of the reference field through Simulator.render
    with the U-Net refine (bfloat16 MLPs), twice, with s/frame, peak memory
    and launches (the field's chunk of rays, frame_chunk, read off them);
    then, with float32 MLPs, the frame's first chunk against the same rays
    rendered on the card's plain versions."""
    from lidar4d_tpu_torch.models.renderer import frame_chunk, render_rays
    from lidar4d_tpu_torch.ops import _cuda
    from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays

    H, W = opt.H_lidar, opt.W_lidar
    rays_o, rays_d = build_novel_rays(np.eye(4, dtype=np.float32)[None], H, W, opt.fov_lidar)
    times = np.array([REFERENCE_FRAME_T], np.float32)
    frames = []

    class Hooked(Simulator):
        def _refine(self, raydrop, intensity, depth):
            frames.append((raydrop, intensity, depth))
            return super()._refine(raydrop, intensity, depth)

    sim = Hooked("lidar4d", opt, field, signal_t, use_refine=True, H_lidar=H, W_lidar=W,
                 device=dev)
    chunk = frame_chunk(field)
    seconds = []
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        pred = sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_cuda.LAUNCHES)
    n_chunks = -(-H * W // chunk)
    want = {k: n_chunks * v if k.endswith("_fwd") else 0
            for k, v in per_density_call(field).items()}
    print(f"  render 1 frame {H}x{W} (Simulator.render, U-Net refine): {seconds[0]:.3f} s, then "
          f"{seconds[1]:.3f} s; peak memory {peak:.2f} GiB; chunk {chunk} rays ({n_chunks} "
          f"chunks); launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"render launches {launches}, expected {want}")
    for k, v in zip(("raydrop", "intensity", "depth"), frames[-1]):
        print(f"  frame {k}: mean {v.mean().item():.5f} min {v.min().item():.5f} "
              f"max {v.max().item():.5f}", flush=True)
        if tuple(v.shape) != (H, W) or not torch.isfinite(v).all():
            raise AssertionError(f"the reference frame's {k} is not finite of shape ({H}, {W})")
    if pred is None or pred.ndim != 2 or pred.shape[1] != 4 or not np.isfinite(pred).all():
        raise AssertionError("the reference frame's point cloud is not a finite [M, 4] array")

    frames.clear()
    with mlp_dtype(torch.float32):
        sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False)
        o, d = (torch.as_tensor(r[0, :chunk], device=dev) for r in (rays_o, rays_d))
        with plain_kernels(), torch.no_grad():
            plain = render_rays(field, signal_t, o, d, times[0], num_steps=opt.num_steps,
                                with_aux=False)
    raydrop, intensity, depth = (v.reshape(-1)[:chunk] for v in frames[-1])
    gaps = {}
    for k, got, want_ in (("depth", depth, plain["depth_lidar"]),
                          ("raydrop", raydrop, plain["image_lidar"][:, 0]),
                          ("intensity", intensity, plain["image_lidar"][:, 1])):
        gaps[k] = (got - want_).abs().max().item() / max(want_.abs().max().item(), 1e-30)
    print(f"  the frame's first {chunk}-ray chunk (float32 MLPs) against the card's plain "
          f"versions: max relative gap {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}"
          f" (tolerance {REFERENCE_CHUNK_RTOL:g})", flush=True)
    if not all(v <= REFERENCE_CHUNK_RTOL for v in gaps.values()):
        raise AssertionError(f"the reference render's first chunk differs from the plain "
                             f"versions': {gaps}")
    return {"s_per_frame": seconds, "peak_gib": peak, "chunk": chunk, "launches": launches,
            "chunk_vs_plain": gaps}


def check_reference_cli(root, scale, offset, dev, field):
    """The training CLI with the reference config on the synthetic scene
    (the trainer phase wrote it under `root`/scene): one epoch, one
    evaluation of the val frames, no refine (--train_only); then the
    simulation CLI with --kitti2nus on its checkpoint in a fresh process.
    Checks every train kernel's launches per step in the epoch, the forward
    kernels' per chunk of rays in evaluation and simulation, finite losses
    and clouds."""
    from lidar4d_tpu_torch.cli import main_lidar4d
    from lidar4d_tpu_torch.models.renderer import frame_chunk

    scene, ws = f"{root}/scene", f"{root}/reference_workspace"
    n_train = sum(1 for f in range(SCENE["num_frames"]) if f % 5 != 4)
    data = ["--path", scene, "--sequence_id", SCENE["sequence_id"],
            "--num_frames", str(SCENE["num_frames"]), "--scale", repr(scale),
            "--offset", *map(repr, offset), "--seed", str(SEED), "--device", str(dev)]
    argv = ["--config", REFERENCE_CONFIG, "--dataloader", "synthetic", *data,
            "--synthetic_H", str(SCENE["H"]), "--synthetic_W", str(SCENE["W"]),
            "--synthetic_seed", str(SCENE["seed"]), "--workspace", ws, "--iters", str(n_train),
            "--eval_interval", "1", "--train_only", "--ckpt", "scratch"]
    probe = TrainerProbe()
    t0 = time.perf_counter()
    with probe.installed():
        trainer = main_lidar4d.main(argv)
    t_run = time.perf_counter() - t0
    records = read_jsonl(trainer.metrics_path)
    epochs = [r for r in records if "rays_per_sec" in r]
    evals = [r for r in records if "valid_loss" in r]
    stages = {}
    for stage, seconds, launches in probe.stages:
        stages.setdefault(stage, []).append({"seconds": seconds, "launches": launches})
    n_val = trainer.eval_seconds["frames"]
    H, W = SCENE["H"], SCENE["W"]
    step = launches_per_step(field, density_calls=1)
    want = {"epoch": {k: n_train * v for k, v in step.items()},
            "evaluate": {k: n_val * -(-H * W // frame_chunk(field)) * v if k.endswith("_fwd")
                         else 0 for k, v in per_density_call(field).items()}}
    failures = []
    for stage, w in want.items():
        got = stages[stage][0]["launches"] if len(stages.get(stage, ())) == 1 else None
        print(f"  {stage}: launches {got} (expected {w})", flush=True)
        if got != w:
            failures.append(f"{stage} launches {got}, expected {w}")
    for r in epochs:
        print(f"  epoch {r['epoch']}: {r['sampler']} sampler, patch {r['patch']}: loss "
              f"{r['loss']:.6f}, {r['rays_per_sec']:.1f} train rays/s", flush=True)
    if [(r["sampler"], r["patch"]) for r in epochs] != [("uniform", "1")] or not all(
            np.isfinite(r["loss"]) for r in epochs):
        failures.append(f"epochs {epochs}")
    print("  eval record " + json.dumps(evals), flush=True)
    if len(evals) != 1 or not np.isfinite(evals[0]["valid_loss"]):
        failures.append(f"eval records {evals}")
    ckpt_dir = trainer.ckpt.ckpt_dir
    sizes = {n: sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                    os.walk(os.path.join(ckpt_dir, n)) for f in fs)
             if os.path.isdir(os.path.join(ckpt_dir, n)) else os.path.getsize(
                 os.path.join(ckpt_dir, n)) for n in sorted(os.listdir(ckpt_dir))}
    eval_s = {k: v / n_val for k, v in trainer.eval_seconds.items() if k != "frames"}
    print(f"  trainer CLI: {t_run:.1f} s; stages (s) "
          + json.dumps({k: [round(x["seconds"], 3) for x in v] for k, v in stages.items()})
          + f"; eval s/frame {json.dumps({k: round(v, 4) for k, v in eval_s.items()})}; "
          f"checkpoint save s {[round(x, 3) for x in probe.ckpt['save']]}, bytes "
          f"{json.dumps(sizes)}", flush=True)
    if "lidar4d_ep0001" not in sizes:
        failures.append(f"checkpoints {sorted(sizes)}")
    if failures:
        raise AssertionError("; ".join(failures))

    sim_ws = f"{root}/reference_sim"
    wall, s_frame, launches, loaded = run_sim_cli(
        ["--config", REFERENCE_CONFIG, *data, "--workspace", sim_ws,
         "--ckpt", os.path.join(ckpt_dir, "lidar4d_ep0001"), "--kitti2nus"])
    check_launches("reference simulation CLI", launches)
    n_frames = SCENE["num_frames"]
    per_chunk = per_density_call(field)["hash_grid_fwd"]
    want_fwd = n_frames * -(-32 * 1024 // frame_chunk(field)) * per_chunk
    clouds = read_clouds(sim_ws)
    # a field of one epoch may keep no point: its ray-drop head is barely
    # trained (alpha_r = 0.01) and the cloud keeps pixels above 0.5
    check_clouds("reference simulation CLI", clouds, n_frames, 32, 1024, min_points=0)
    print(f"  simulation CLI --kitti2nus (32x1024, no refine), a fresh process: {wall:.1f} s wall, "
          f"{s_frame:.4f} s/frame rendering, points a frame "
          f"{np.mean([len(c) for c in clouds]):.1f}; launches {launches} (hash_grid_fwd "
          f"expected {want_fwd})", flush=True)
    if launches["hash_grid_fwd"] != want_fwd:
        raise AssertionError(f"simulation CLI hash_grid_fwd launches {launches}, expected "
                             f"{want_fwd}")
    return {"trainer": {"seconds": t_run, "epoch": epochs[0], "eval": evals[0],
                        "eval_s_per_frame": eval_s, "stage_s": {
                            k: [x["seconds"] for x in v] for k, v in stages.items()},
                        "checkpoint_save_s": probe.ckpt["save"], "checkpoint_bytes": sizes,
                        "launches": {k: v[0]["launches"] for k, v in stages.items()}},
            "simulate_kitti2nus": {"cli_wall_s": wall, "s_per_frame": s_frame,
                                   "launches": launches, "checkpoint": loaded,
                                   "points_per_frame": float(np.mean([len(c) for c in clouds]))}}


def check_reference(root, scale, offset, dev):
    """The reference configuration (REFERENCE_CONFIG at the CLI defaults, no
    width overridden) at full width from the port's seeded init: its
    parameter count and routes, every kernel call of one step against its
    plain version, REFERENCE_WARMUP + REFERENCE_TIMED steps with a profiled
    one, one card step against the CPU's, one 66x1030 frame through
    Simulator.render, then the training CLI (one epoch, one evaluation) and
    the simulation CLI (--kitti2nus). Returns the phase's summary."""
    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.interop import tree_leaves, tree_to_torch
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    opt = get_arg_parser().parse_args(["--config", REFERENCE_CONFIG])
    opt.near_lidar *= scale
    opt.far_lidar *= scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=SEED)
    sizes = {k: sum(p.numel() for p in tree_leaves(v)) for k, v in params.items()}
    print(f"  field of {REFERENCE_CONFIG}: {sum(sizes.values()):,} parameters "
          f"{json.dumps(sizes)}; {opt.num_steps} uniform samples (coarse {opt.num_coarse}); "
          f"flow clouds at most {opt.flow_cloud_max_points or 'all'} points", flush=True)
    signal = signal_params(params)
    signal_t = tree_to_torch(signal, dev)
    ds, cache = scene_steps(f"{root}/scene", scale, offset, opt.flow_cloud_max_points)
    out = {"parameters": sizes}
    seconds = {}

    t0 = time.perf_counter()
    out["routes"], out["calls"], out["kernels"] = check_reference_kernels(
        field, signal_t, ds, cache, opt, dev)
    seconds["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run = train(field, params, ds, cache, opt, dev, REFERENCE_WARMUP, REFERENCE_TIMED,
                what="reference")
    out["steps"] = {"ms_per_step": run["ms_per_step"],
                    "train_rays_per_s": TRAIN_RAYS / run["ms_per_step"] * 1e3,
                    "peak_gib": run["peak_gib"], "losses": run["losses"],
                    "profile": run["profile"],
                    "launches_per_step": {k: v / (REFERENCE_WARMUP + REFERENCE_TIMED)
                                          for k, v in run["launches"].items()}}
    out["launches"] = run["launches"]
    seconds["steps"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu_field = LiDAR4DField(field.cfg, device="cpu")
    uniform = dict(num_steps=opt.num_steps)
    with mlp_dtype(torch.float32):
        cpu = step_grads(cpu_field, signal, ds, cache, uniform)
        card = step_grads(field, signal, ds, cache, uniform, draws=cpu[3])
    compare_steps("reference card vs cpu", field, signal, card, cpu, STEP_RTOL,
                  UNIFORM_STEP_GRAD_RTOL, post_step=True)
    del cpu, card
    seconds["card_vs_cpu"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["render"] = check_reference_render(field, signal_t, opt, dev)
    del signal_t, params
    torch.cuda.empty_cache()
    seconds["render"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out.update(check_reference_cli(root, scale, offset, dev, field))
    seconds["cli"] = time.perf_counter() - t0
    out["seconds"] = seconds
    print("  reference phase seconds " + json.dumps({k: round(v, 2) for k, v in seconds.items()}),
          flush=True)
    return out


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
    from lidar4d_tpu_torch.models.renderer import render_frames_staged, render_rays
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
    check_launches("render", launches)

    torch.cuda.synchronize()
    t_steady = time.perf_counter()
    sim.render(rays_o, rays_d, times, save_pc=False, save_img=False, save_video=False,
               frame_batch=2)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    print(f"  second render: {steady_s:.3f} s, {steady_s / 2:.3f} s/frame; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    groups, hash_launches = profile_render(sim, rays_o[:1], rays_d[:1], times[:1])
    ray_chunk = inspect.signature(render_frames_staged).parameters["chunk"].default
    print(f"  hash_grid_fwd in the profiled frame: {groups['hash_grid_fwd']:.3f} ms device time, "
          f"{hash_launches} launches, {groups['hash_grid_fwd'] * ray_chunk / (H * W):.3f} ms a "
          f"{ray_chunk}-ray chunk ({H * W} rays a frame)", flush=True)
    seconds["slice"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as root:
        phase("scene")
        t0 = time.perf_counter()
        ds, cache, scale, offset = make_scene(root)
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
    train_launches = train(tfield, params, ds, cache, opt, dev)["launches"]
    seconds["train"] = time.perf_counter() - t0

    phase("parallel")
    t0 = time.perf_counter()
    parallel_summary = check_parallel(tfield, params, ds, cache, opt, dev)
    seconds["parallel"] = time.perf_counter() - t0

    phase("encoders")
    t0 = time.perf_counter()
    encoder_launches, encoder_summary = check_encoders(tfield, params, ds, opt, dev)
    seconds["encoders"] = time.perf_counter() - t0

    phase("classic")
    t0 = time.perf_counter()
    classic_summary, classic_launches, classic_ms, classic_losses = check_classic(
        tfield, params, ds, cache, opt, dev)
    seconds["classic"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as root:
        phase("trainer")
        t0 = time.perf_counter()
        trainer_summary = check_trainer(root, scale, offset, dev)
        seconds["trainer"] = time.perf_counter() - t0

        phase("simulate")
        t0 = time.perf_counter()
        simulate_summary = check_simulate(root, scale, offset, dev)
        seconds["simulate"] = time.perf_counter() - t0

        phase("preprocess")
        t0 = time.perf_counter()
        preprocess_summary = check_preprocess(root, scale, offset)
        seconds["preprocess"] = time.perf_counter() - t0

        phase("reference")
        t0 = time.perf_counter()
        reference_summary = check_reference(root, scale, offset, dev)
        seconds["reference"] = time.perf_counter() - t0
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
    for name in TRAIN_KERNELS:
        if reference_summary["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the reference path")
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        s = {**train_summary, **encoder_summary}[name]
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
    print(json.dumps({"parallel": parallel_summary}), flush=True)
    print(json.dumps({"trainer": trainer_summary}), flush=True)
    print(json.dumps({"simulate": simulate_summary}), flush=True)
    print(json.dumps({"preprocess": preprocess_summary}), flush=True)
    print(json.dumps({"reference": reference_summary}), flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
