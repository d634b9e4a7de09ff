"""Build, load and launch the package's CUDA kernels (`lidar4d_tpu_torch/csrc`).

The kernels have a plain C interface and include no PyTorch headers, so one
`nvcc` call compiles every `csrc/*.cu` for Hopper (`sm_90a`) into one shared
library in seconds. The library's file name carries a hash of the sources and
flags, so an edited source is never served by a stale build. It is built at
first use into `lidar4d_tpu_torch/_build/` and loaded with `ctypes`: every
pointer and the stream are passed as `c_void_p`, the stream being PyTorch's
current one, and each C entry returns `cudaGetLastError()` after its launch.

`LAUNCHES` counts the launches of each kernel; `launch` is the only place
that adds to it, right where the kernel is launched.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, tables, levels, out, n_variants, n, n_levels, n_dims, n_features, rows, stream
    "hash_grid_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _P),
    # grid, pts, out, n_planes, n, channels, height, width, stream
    "plane_bilinear_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # grid, x, out, n_planes, n, channels, width, stream
    "plane_linear_fwd": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, cot, levels, dtab, n_variants, n, n_levels, n_dims, n_features, rows,
    # run, smem_floats, stream
    "hash_grid_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _I, _I, _P),
    # pts, cot, dgrid, n_planes, n, channels, height, width, stream
    "plane_bilinear_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # grid, x, cot, dgrid, dx, n_planes, n, channels, width, lead, run, copy,
    # stream
    "plane_linear_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # grid, pts, cot, dgrid, dpts, n_planes, n, channels, height, width, stream
    "plane_bilinear_vjp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

# Occupancy queries of the persistent kernels (resident blocks per SM; no
# launch): hash_grid_bwd (n_dims, n_features, smem_floats) and
# plane_linear_bwd (channels, width, copy).
_QUERIES = {
    "hash_grid_bwd_blocks_per_sm": (_I, _I, _I),
    "plane_linear_bwd_blocks_per_sm": (_I, _I, _I),
}

LAUNCHES = {name: 0 for name in _SIGNATURES}

_lib = None


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblidar4d_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build():
    """Compile every csrc/*.cu into one library unless it already exists.

    Returns (path, nvcc's output); the output is empty when nothing was built.
    """
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
            fn = getattr(lib, f"lidar4d_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_cuda_tensor(name, t, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad: a raw kernel wrapper does not differentiate; "
            "call the differentiable entry point (its autograd.Function) instead")


def aligned(t, nbytes=16):
    """t itself if its storage is `nbytes`-aligned, else an aligned copy."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def launch(name, device, *args):
    """Launch kernel `name` on `device`'s current stream; raise on a refusal."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(library(), f"lidar4d_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1


def persistent_run(n, groups, n_grids, min_run, sms, blocks_per_sm, waves=1):
    """Consecutive points each lane group takes in a persistent kernel whose
    blocks hold `groups` lane groups, launched as `n_grids` independent
    grids (levels x variants, tables) of ceil(n / (groups x run)) blocks:
    together at most `waves` resident waves of the card (waves x sms x
    blocks_per_sm blocks), and no group takes fewer than `min_run` points (a
    short call gets fewer blocks, at least one a grid)."""
    most = -(-n // (groups * min_run))
    blocks = max(1, min(most, waves * sms * blocks_per_sm // n_grids))
    return max(min_run, -(-n // (blocks * groups)))


@lru_cache(maxsize=None)
def blocks_per_sm(query, *args):
    """Resident blocks per SM of a persistent kernel (`_QUERIES`), from the
    CUDA occupancy calculator for its registers, threads and shared memory."""
    blocks = getattr(library(), f"lidar4d_{query}")(*args)
    if blocks < 1:
        raise RuntimeError(f"occupancy query {query}{args} failed: {blocks}")
    return blocks


@lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no quiet CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions")
    return device
