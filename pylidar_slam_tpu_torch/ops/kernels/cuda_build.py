"""nvcc build of a kernel source into a ctypes-loadable library.

Sources under ``pylidar_slam_tpu_torch/csrc/`` are compiled at first use for
``sm_90a`` into ``build/kernels/`` with a plain C interface, which builds in
seconds (including PyTorch's headers would take minutes).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

from pylidar_slam_tpu_torch.utils.build import BuildError, build_shared_library

CSRC = Path(__file__).resolve().parents[2] / "csrc"

# Guards the wrappers' launch counts (``assoc_gn.launches``,
# ``nn_argmin.launches``), which threads of one process bump concurrently.
LAUNCH_LOCK = threading.Lock()

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC",
              # separate rounding of every product and sum, as the plain
              # PyTorch composites round them
              "--fmad=false",
              # register / shared-memory / spill report, kept in the log
              "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Builds (once per source hash) and loads ``csrc/<name>.cu``; raises
    BuildError when nvcc is missing or rejects the source."""
    src = CSRC / f"{name}.cu"
    path = build_shared_library(name, [src], [nvcc_path()] + NVCC_FLAGS,
                                "kernels")
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise BuildError(f"cannot load {path}: {e}") from e
