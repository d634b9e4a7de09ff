"""Native (C++) host-side preprocessing, built with g++ and loaded by ctypes.

Port of `lidar4d_tpu/native/`: the same two C entries (`preprocess.cpp`),
`lidar_to_pano` (the range-view projection) and `knn_outlier_mask` (open3d's
statistical outlier removal on a voxel-grid kNN), compiled with the same
flags. One `g++` call builds the library at first use into
`lidar4d_tpu_torch/_build/`; its file name carries a hash of the source, the
compiler and the flags, and it is written under a temporary name and
renamed, so processes that build at the same time never load half a file.

Unlike the JAX package's loader there is no fallback: a caller that asks for
the native path gets it, or a RuntimeError that names the compiler's error.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("preprocess.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path(compiler="g++") -> Path:
    """Where the library built from the current source by `compiler` lives."""
    h = hashlib.sha256(" ".join((compiler, *FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpreprocess_{h.hexdigest()[:16]}.so"


def build(compiler="g++") -> Path:
    """Compile `preprocess.cpp` unless the library already exists; returns
    its path. Raises RuntimeError when the compiler is missing or fails."""
    so = library_path(compiler)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {compiler} to build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64, f64 = ctypes.c_int64, ctypes.c_double
        lib.lidar_to_pano.argtypes = [
            ctypes.POINTER(ctypes.c_float), i64, i64, i64, f64, f64, f64,
            ctypes.POINTER(f64), ctypes.POINTER(f64)]
        lib.lidar_to_pano.restype = None
        lib.knn_outlier_mask.argtypes = [
            ctypes.POINTER(ctypes.c_float), i64, i64, f64, ctypes.POINTER(ctypes.c_uint8)]
        lib.knn_outlier_mask.restype = None
        _lib = lib
    return _lib


def _points(points, columns):
    arr = np.asarray(points)
    if arr.ndim != 2 or arr.shape[1] < columns:
        raise ValueError(f"points must be [N, >={columns}], got {arr.shape}")
    return np.ascontiguousarray(arr[:, :columns], np.float32)


def lidar_to_pano_native(points_with_intensities, H, W, fov_up, fov, max_depth=80.0):
    """Native twin of `ops.pano.lidar_to_pano_with_intensities`: (N, 4)
    points (xyz + intensity, read as float32) -> (pano, intensities), each
    [H, W] float64."""
    if H <= 0 or W <= 0:
        raise ValueError(f"pano size must be positive, got {H}x{W}")
    lib = library()
    pts = _points(points_with_intensities, 4)
    pano = np.zeros((H, W), np.float64)
    intens = np.zeros((H, W), np.float64)
    lib.lidar_to_pano(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0], H, W,
        float(fov_up), float(fov), float(max_depth),
        pano.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        intens.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return pano, intens


def knn_outlier_mask_native(points, nb_neighbors=64, std_ratio=3.0):
    """Native twin of `utils.pointcloud.statistical_outlier_removal`'s mask:
    True where a point's mean distance to its `nb_neighbors` nearest
    neighbours is below the cloud's mean + `std_ratio` x std of it."""
    if nb_neighbors < 1:
        raise ValueError(f"nb_neighbors must be positive, got {nb_neighbors}")
    lib = library()
    pts = _points(points, 3)
    mask = np.zeros((pts.shape[0],), np.uint8)
    lib.knn_outlier_mask(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        int(nb_neighbors), float(std_ratio),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mask.astype(bool)
