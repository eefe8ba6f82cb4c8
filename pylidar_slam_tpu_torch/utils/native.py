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
from typing import Optional

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
