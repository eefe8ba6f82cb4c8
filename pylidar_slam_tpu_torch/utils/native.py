"""ctypes bindings to the shared native host runtime
(``native/pointcloud_native.cpp``, the same source the JAX package uses).

The library is compiled with g++ at first use into ``build/native/`` (never
into ``native/``); when no toolchain is present the callers fall back to
numpy.
"""
from __future__ import annotations

import ctypes
import functools
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from pylidar_slam_tpu_torch.utils.build import (REPO_ROOT, BuildError,
                                                build_shared_library)

logger = logging.getLogger(__name__)

SOURCE = REPO_ROOT / "native" / "pointcloud_native.cpp"
# The JAX package's flags: the same compiler options give the same bytes.
_COMMAND = ["g++", "-O3", "-march=native", "-fno-math-errno", "-fopenmp",
            "-shared", "-fPIC"]


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built."""
    try:
        path = build_shared_library("pointcloud_native", [SOURCE], _COMMAND,
                                    "native", host_specific=True)
    except BuildError as e:
        logger.warning("Native library build failed (%s); using numpy "
                       "fallbacks", e)
        return None
    lib = ctypes.CDLL(str(path))
    lib.load_kitti_scan.restype = ctypes.c_int
    lib.load_kitti_scan.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int]
    lib.encode_range_image.restype = ctypes.c_int
    lib.encode_range_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.grid_sample_mask.restype = ctypes.c_int
    lib.grid_sample_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.lc_subsample.restype = ctypes.c_int
    lib.lc_subsample.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def load_kitti_scan(path: str, capacity: int) -> Optional[Tuple[np.ndarray, int]]:
    """KITTI ``.bin`` scan read in one pass: the 0.205 degree correction
    applied in float32 and rows holding a NaN dropped.  A zero-padded
    (capacity, 3) float32 buffer and its number of valid rows; None if the
    native library is unavailable or the file cannot be opened.  Counts its
    reads in ``load_kitti_scan.reads``."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((capacity, 3), np.float32)
    n = lib.load_kitti_scan(str(path).encode(), out.ctypes.data_as(ctypes.c_void_p),
                            capacity)
    if n < 0:
        return None
    with _READS_LOCK:  # the runner's prefetch threads read concurrently
        load_kitti_scan.reads += 1
    return out, int(n)


load_kitti_scan.reads = 0
_READS_LOCK = threading.Lock()


def encode_range_image(points: np.ndarray, h: int, w: int,
                       fov_up_rad: float, fov_down_rad: float,
                       range_step: float, sub16: bool = False,
                       planes: bool = False) -> Optional[np.ndarray]:
    """O(n) single-pass z-buffered range-image encode.

    Default (mode 0, rimg): (h*w, 3) rows [r_lo, r_hi, sub] with 4+4-bit
    sub-pixel offsets; `sub16` (mode 1, rimg16): (h*w, 4) with 8+8-bit
    offsets; `planes` (mode 2, rimg8): (h*w + (h+w+1)//2, 2) range-only
    pixels followed by the per-row / per-column mean angular offset planes.
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points[:, :3], np.float32)
    if planes:
        out = np.zeros((h * w + (h + w + 1) // 2, 2), np.uint8)
        mode = 2
    else:
        out = np.zeros((h * w, 4 if sub16 else 3), np.uint8)
        mode = 1 if sub16 else 0
    lib.encode_range_image(points.ctypes.data_as(ctypes.c_void_p),
                           points.shape[0], h, w,
                           ctypes.c_float(fov_up_rad),
                           ctypes.c_float(fov_down_rad),
                           ctypes.c_float(range_step),
                           mode,
                           out.ctypes.data_as(ctypes.c_void_p))
    return out


def grid_sample_mask(points: np.ndarray, voxel_size: float) -> Optional[np.ndarray]:
    """O(n) hash-table voxel sampling mask (first point per voxel), or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points[:, :3], np.float32)
    keep = np.zeros((points.shape[0],), np.uint8)
    lib.grid_sample_mask(points.ctypes.data_as(ctypes.c_void_p),
                         points.shape[0], ctypes.c_float(voxel_size),
                         keep.ctypes.data_as(ctypes.c_void_p))
    return keep.astype(bool)


def lc_subsample(points: np.ndarray, voxel_size: float,
                 cap: int) -> Optional[Tuple[np.ndarray, int]]:
    """Fused zero-row drop + first point per voxel + an even selection of at
    most `cap` of them, in one O(n) pass: a zero-padded (cap, 3) float32
    buffer and its number of valid rows, or None if the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.zeros((cap, 3), np.float32)
    n = lib.lc_subsample(points.ctypes.data_as(ctypes.c_void_p),
                         points.shape[0], ctypes.c_float(voxel_size),
                         cap, out.ctypes.data_as(ctypes.c_void_p))
    return out, int(n)
