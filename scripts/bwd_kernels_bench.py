#!/usr/bin/env python3
"""Time hash_grid_bwd and plane_linear_bwd against their first design, at the
flagship train step's per-call sizes, on one NVIDIA GPU.

    python3 scripts/bwd_kernels_bench.py BASELINE_CSRC

From the repository root. BASELINE_CSRC holds the kernel sources of commit
c1015c7, the last with the first design of both kernels:

    git archive c1015c7 lidar4d_tpu_torch/csrc | tar -x --strip-components=2 -C DIR

They are built with the package's nvcc flags into a library of their own and
called through that commit's C entry points (hash_grid_bwd without `run`,
plane_linear_bwd without the launch plan). The cases are chip_smoke.py's
train-kernels cases of the two kernels: 1,024 training rays of the synthetic
scene (seed 0) x 128 and x 256 samples (131,072 and 262,144 points per
density call) with the flagship field's specs, and the flow loss's cloud and
ground points; under "fact" the train step's own route, under "classic" the
classic one-hot route's F = 8 specs. Each case is held against its plain
version (relative error of the largest magnitude, limit 1e-4) and timed with
CUDA events in turns: first design, current, current, first design.

Prints one line per case with both means, then one JSON line with the sums
over a step's calls per kernel and route. Imports nothing of JAX.
"""

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lidar4d_tpu_torch.ops import _cuda  # noqa: E402
from lidar4d_tpu_torch.ops import hash_onehot as ho  # noqa: E402
from lidar4d_tpu_torch.ops import plane_onehot as po  # noqa: E402

KERNELS = ("hash_grid_bwd", "plane_linear_bwd")
ITERS = 20
RTOL = 1e-4


def build_baseline(csrc):
    """Compile the .cu files of `csrc` with the package's nvcc flags into a
    library of their own; returns the ctypes handle with commit c1015c7's
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
    lib.lidar4d_hash_grid_bwd.argtypes = (p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, p)
    lib.lidar4d_plane_linear_bwd.argtypes = (p, p, p, p, p, i, i, i, i, i, p)
    for fn in (lib.lidar4d_hash_grid_bwd, lib.lidar4d_plane_linear_bwd):
        fn.restype = i
    return lib


def baseline_wrappers(lib):
    """hash_grid_bwd / plane_linear_bwd through the baseline library, with
    commit c1015c7's wrappers' arguments."""

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def hash_grid_bwd(spec, xs, cot, n_tables=None):
        v, n, _ = xs.shape
        n_tables = v if n_tables is None else n_tables
        dtab = torch.zeros((n_tables, spec.n_rows, spec.n_features), device=xs.device)
        levels = ho._level_table(spec, xs.device)
        rc = lib.lidar4d_hash_grid_bwd(xs.data_ptr(), cot.data_ptr(), levels.data_ptr(),
                                       dtab.data_ptr(), v, n, spec.n_levels, spec.n_dims,
                                       spec.n_features, spec.n_rows, ho._smem_floats(spec),
                                       stream(xs.device))
        if rc:
            raise RuntimeError(f"baseline hash_grid_bwd: cudaError {rc}")
        return dtab

    def plane_linear_bwd(grid, x, cot, lead=0):
        p, c, w = grid.shape
        n = x.shape[1]
        dgrid = torch.zeros((p, c, w), device=x.device)
        dx = torch.empty((p, n), device=x.device)
        rc = lib.lidar4d_plane_linear_bwd(grid.data_ptr(), x.data_ptr(), cot.data_ptr(),
                                          dgrid.data_ptr(), dx.data_ptr(), p, n, c, w,
                                          min(max(lead, 0), p), stream(x.device))
        if rc:
            raise RuntimeError(f"baseline plane_linear_bwd: cudaError {rc}")
        return dgrid, dx

    return {"hash_grid_bwd": hash_grid_bwd, "plane_linear_bwd": plane_linear_bwd}


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
    with patched(ho, hash_grid_bwd=wrappers["hash_grid_bwd"]), \
            patched(po, plane_linear_bwd=wrappers["plane_linear_bwd"]):
        yield


def rel_err(run, plain):
    got, want = run(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    return max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def step_cases(field, params, ds, cache, opt, dev, classic):
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
        cases += [(k, f"{pts.shape[0]} pts {label}", run, plain)
                  for k, label, run, plain, *_ in cs.backward_cases(field, params, gen, pts,
                                                                    classic)]
    flow = cs.flow_loss_cases(field, params, gen, torch.as_tensor(cache["points"][fi], device=dev),
                              torch.as_tensor(cache["ground"][fi], device=dev), True, classic)
    cases += [(k, label, run, plain) for k, label, run, plain, *_ in flow]
    return [c for c in cases if c[0] in KERNELS]


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bwd_kernels_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    _, log = _cuda.build()
    _cuda.library()
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    base = baseline_wrappers(build_baseline(sys.argv[1]))

    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    opt = get_arg_parser().parse_args(["--config", str(ROOT / cs.CONFIG)])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    params = field.init(seed=cs.SEED)
    with tempfile.TemporaryDirectory() as root:
        ds, cache, scale = cs.make_scene(root)
    field = cs.train_field(field, scale)

    sums = {}
    with torch.no_grad():
        for route in ("fact", "classic"):
            for name, label, run, plain in step_cases(field, params, ds, cache, opt, dev,
                                                      route == "classic"):
                err = rel_err(run, plain)
                line = {"route": route, "kernel": name, "case": label, "max_rel": err}
                if not err <= RTOL:
                    raise AssertionError(f"{name} {label}: max_rel {err} > {RTOL}")
                with baseline(base):
                    line["baseline_max_rel"] = rel_err(run, plain)
                    b1 = cs.cuda_ms(run, ITERS)
                c1, c2 = cs.cuda_ms(run, ITERS), cs.cuda_ms(run, ITERS)
                with baseline(base):
                    b2 = cs.cuda_ms(run, ITERS)
                line.update(ms=(c1 + c2) / 2, baseline_ms=(b1 + b2) / 2, turns=[b1, c1, c2, b2])
                print(json.dumps(line), flush=True)
                s = sums.setdefault(f"{route} {name}", {})
                for k, v in line.items():
                    if isinstance(v, float) and k not in ("max_rel", "baseline_max_rel"):
                        s[k] = s.get(k, 0.0) + v
                torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"per_step_sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
