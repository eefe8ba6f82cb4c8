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


def encode_range_image_planes(points: np.ndarray, h: int, w: int,
                              fov_up_rad: float, fov_down_rad: float,
                              range_step: float) -> Optional[np.ndarray]:
    """O(n) single-pass z-buffered rimg8 encode: (h*w + (h+w+1)//2, 2) uint8
    range-only pixels followed by the per-row / per-column mean angular
    offset planes.  None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.zeros((h * w + (h + w + 1) // 2, 2), np.uint8)
    lib.encode_range_image(points.ctypes.data_as(ctypes.c_void_p),
                           points.shape[0], h, w,
                           ctypes.c_float(fov_up_rad),
                           ctypes.c_float(fov_down_rad),
                           ctypes.c_float(range_step),
                           2,  # mode 2: range pixels + angular planes
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
