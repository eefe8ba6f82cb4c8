"""Kernel B2: exact brute-force 1-NN with a streaming (min, argmin).

``nn_argmin`` launches ``csrc/nn_argmin.cu`` on CUDA tensors and runs
``nn_argmin_plain`` -- the JAX package's chunked XLA composite
(``ops/icp3d.py::brute_force_nn``) in plain PyTorch -- on CPU tensors only.
On a CUDA tensor the wrapper launches the kernel or raises; it never falls
back.

For (M, 3) queries and (V, 3) model points with a (V,) validity mask: the
index (int32) and squared distance of each query's nearest valid model
point.  Invalid rows never win, the lowest index wins ties, and a map with
no valid row gives index 0 and +inf.

``nn_argmin.launches`` counts the kernel's runs.  Inside ``capture()`` (a
CUDA graph's capture on the calling thread) a launch is recorded, not run:
it is counted on the scope's object, and each replay of the graph adds
that count with ``add_launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
import types
from typing import Optional, Tuple

import torch

from pylidar_slam_tpu_torch.ops.kernels.cuda_build import LAUNCH_LOCK

PLAIN_CHUNK = 1024  # model rows per step of the plain version


def nn_argmin_plain(queries: torch.Tensor, model: torch.Tensor,
                    model_valid: Optional[torch.Tensor] = None,
                    chunk: int = PLAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunked over the model rows
    as the JAX ``brute_force_nn`` is.  The squared distance is written as
    the explicit left-to-right sum of the three squared differences, so it
    rounds as the kernel does."""
    m = queries.shape[0]
    best_d = torch.full((m,), math.inf, dtype=queries.dtype, device=queries.device)
    best_i = torch.zeros((m,), dtype=torch.int32, device=queries.device)
    for base in range(0, model.shape[0], chunk):
        e = queries[:, None, :] - model[None, base:base + chunk]
        d = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
        if model_valid is not None:
            d = torch.where(model_valid[None, base:base + chunk], d,
                            torch.full_like(d, math.inf))
        cd, ci = torch.min(d, dim=1)  # the first minimum of the chunk
        better = cd < best_d
        best_d = torch.where(better, cd, best_d)
        best_i = torch.where(better, (ci + base).to(torch.int32), best_i)
    return best_i, best_d


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from pylidar_slam_tpu_torch.ops.kernels.cuda_build import load_kernel_library
    lib = load_kernel_library("nn_argmin")
    for fn in (lib.nn_argmin_splits, lib.nn_argmin_padded_rows):
        fn.restype = ctypes.c_int
    lib.nn_argmin_splits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nn_argmin_padded_rows.argtypes = [ctypes.c_int]
    lib.nn_argmin_launch.restype = ctypes.c_int
    lib.nn_argmin_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_shape(m: int, v: int, device_index: int) -> Tuple[int, int]:
    """(V splits, packed model rows) for M queries and V model points on
    the device: the split count follows the card's SM count."""
    lib = _library()
    with torch.cuda.device(device_index):
        return lib.nn_argmin_splits(m, v), lib.nn_argmin_padded_rows(v)


_capturing = threading.local()


@contextlib.contextmanager
def capture():
    """The scope of a CUDA-graph capture on this thread: the launches in it
    are counted in the yielded object's ``launches``, not in
    ``nn_argmin.launches``."""
    _capturing.scope = scope = types.SimpleNamespace(launches=0)
    try:
        yield scope
    finally:
        _capturing.scope = None


def add_launches(n: int) -> None:
    """Counts `n` launches a graph replay ran."""
    with LAUNCH_LOCK:  # job threads launch concurrently
        nn_argmin.launches += n


def build() -> None:
    """Builds and loads the kernel library (raises BuildError on failure)."""
    _library()


def _check(queries, model, model_valid, active):
    if queries.device.type != "cuda":
        raise ValueError(f"nn_argmin runs on CUDA or CPU tensors, got {queries.device}")
    if queries.dim() != 2 or queries.shape[1] != 3 or queries.dtype != torch.float32:
        raise ValueError(f"queries must be (M, 3) float32, got "
                         f"{tuple(queries.shape)} {queries.dtype}")
    if model.dim() != 2 or model.shape[1] != 3 or model.dtype != torch.float32:
        raise ValueError(f"model must be (V, 3) float32, got "
                         f"{tuple(model.shape)} {model.dtype}")
    if model_valid.shape != (model.shape[0],) or model_valid.dtype != torch.bool:
        raise ValueError(f"model_valid must be ({model.shape[0]},) bool, got "
                         f"{tuple(model_valid.shape)} {model_valid.dtype}")
    if queries.shape[0] * 3 >= 2 ** 31 or model.shape[0] * 3 >= 2 ** 31:
        raise ValueError("nn_argmin indexes with int32")
    named = [("model", model), ("model_valid", model_valid)]
    if active is not None:
        if active.numel() != 1 or active.dtype != torch.bool:
            raise ValueError("active must be a one-element bool tensor")
        named.append(("active", active))
    for name, t in [("queries", queries)] + named:
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def nn_argmin(queries: torch.Tensor, model: torch.Tensor,
              model_valid: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: queries (M, 3) vs model (V, 3) -> (idx (M,) int32,
    sq_dist (M,)).

    `active` (a device bool, optional) skips the pass without a host sync:
    when it holds False the kernel does no work and returns index 0 and
    +inf, which the caller discards.  CPU tensors run ``nn_argmin_plain``,
    which always computes; CUDA tensors launch the kernel.
    """
    if queries.device.type == "cpu":
        return nn_argmin_plain(queries, model, model_valid)
    if model_valid is None:
        model_valid = torch.ones((model.shape[0],), dtype=torch.bool,
                                 device=model.device)
    _check(queries, model, model_valid, active)
    m, v = queries.shape[0], model.shape[0]
    dev = queries.device
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    sq = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return idx, sq
    lib = _library()
    splits, rows = _scratch_shape(m, v, dev.index if dev.index is not None
                                  else torch.cuda.current_device())
    packed = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    part_d = torch.empty((splits * m,), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits * m,), dtype=torch.int32, device=dev)
    err = lib.nn_argmin_launch(
        queries.data_ptr(), model.data_ptr(), model_valid.data_ptr(),
        None if active is None else active.data_ptr(), m, v, splits,
        packed.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), idx.data_ptr(),
        sq.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_argmin launch failed with cudaError_t {err}")
    scope = getattr(_capturing, "scope", None)
    if scope is not None:
        scope.launches += 1
    else:
        add_launches(1)
    return idx, sq


nn_argmin.launches = 0
