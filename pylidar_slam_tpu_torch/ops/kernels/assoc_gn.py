"""Kernel B1: fused window association + point-to-plane normal equations.

``assoc_gn`` launches ``csrc/assoc_gn.cu`` on CUDA tensors and runs
``assoc_gn_plain`` -- the same function composed from plain PyTorch ops, as
the JAX main path composes ``window_associate`` with ``ops/optimization`` --
on CPU tensors only.  On a CUDA tensor the wrapper launches the kernel or
raises; it never falls back.

Output: one (30,) float32 tensor -- the 21 upper-triangle entries of
H = sum w^2 J J^T (row-major), g = sum w^2 J r (6), the loss sum (w r)^2,
the match count and the weight mass sum w^2 (``unpack`` splits it).

``assoc_gn.launches`` counts the kernel's runs.  Inside ``capture(device)``
(a CUDA graph's capture on the calling thread) a launch is recorded, not
run: it takes its tickets from the graph's own counter and is counted on
the scope's object, and each replay of the graph adds that count with
``add_launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Tuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.ops import optimization
from pylidar_slam_tpu_torch.ops.kernels.cuda_build import LAUNCH_LOCK

NUM_OUT = 30
SCHEME_IDS = {"least_square": 0, "default": 0, "huber": 1, "exp": 2,
              "neighborhood": 3, "geman_mcclure": 4,
              "square_geman_mcclure": 5, "cauchy": 6}
_UPPER = [(a, b) for a in range(6) for b in range(a, 6)]


def window_associate_images(model_xyz: torch.Tensor,
                            model_normal: torch.Tensor,
                            model_valid: torch.Tensor,
                            tgt_img: torch.Tensor,
                            window_rows: int, window_cols: int,
                            max_dist: float):
    """For each target pixel, the closest valid model candidate in the
    window (model pixel (r - dr, c - dc), dr outer, dc inner, first minimum
    wins).  Columns wrap in azimuth; rows outside the image are empty.

    Returns (ref_xyz, ref_normal, mask, sq_dists) flattened to (H*W, ...).
    """
    h, w, _ = tgt_img.shape
    wr, wc = window_rows, window_cols
    tgt_valid = torch.amax(torch.abs(tgt_img), dim=-1) > 0

    def pad(img):
        cols = torch.cat([img[:, w - wc:], img, img[:, :wc]], dim=1) \
            if wc > 0 else img
        if wr == 0:
            return cols
        zeros = cols.new_zeros((wr,) + cols.shape[1:])
        return torch.cat([zeros, cols, zeros], dim=0)

    px = pad(model_xyz)
    pn = pad(model_normal)
    pv = pad(model_valid[..., None])[..., 0]

    best_d = torch.full((h, w), math.inf, dtype=tgt_img.dtype,
                        device=tgt_img.device)
    best_xyz = torch.zeros_like(tgt_img)
    best_nrm = torch.zeros_like(tgt_img)
    inf = torch.full_like(best_d, math.inf)
    for dr in range(-wr, wr + 1):
        for dc in range(-wc, wc + 1):
            r0, c0 = wr - dr, wc - dc
            cx = px[r0:r0 + h, c0:c0 + w]
            e = tgt_img - cx
            d = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
            d = torch.where(pv[r0:r0 + h, c0:c0 + w] & tgt_valid, d, inf)
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_xyz = torch.where(better[..., None], cx, best_xyz)
            best_nrm = torch.where(better[..., None], pn[r0:r0 + h, c0:c0 + w],
                                   best_nrm)

    ok = torch.isfinite(best_d) & (best_d <= max_dist * max_dist) & \
        (torch.amax(torch.abs(best_nrm), dim=-1) > 0)
    return (best_xyz.reshape(-1, 3), best_nrm.reshape(-1, 3), ok.reshape(-1),
            torch.where(ok, best_d, torch.zeros_like(best_d)).reshape(-1))


def assoc_gn_plain(timg: torch.Tensor, model_xyz: torch.Tensor,
                   model_normal: torch.Tensor, model_valid: torch.Tensor,
                   wr: int, wc: int, max_nd: float, scheme: str, sigma: float,
                   plane_gate: float = 0.0, eps: float = 1.0e-4) -> torch.Tensor:
    """The kernel's function in plain PyTorch: window association, plane
    gate, point-to-plane residual and Jacobian at the zero delta, robust
    weights and the weighted sums, packed as the kernel packs them."""
    ref, nrm, ok, sq_d = window_associate_images(
        model_xyz, model_normal, model_valid, timg, wr, wc, max_nd)
    tp = timg.reshape(-1, 3)
    zero6 = tp.new_zeros(6)
    res = optimization.point_to_plane_residuals(zero6, tp, ref, nrm, ok)
    if plane_gate > 0.0:
        ok = ok & (torch.abs(res) <= plane_gate)
        res = torch.where(ok, res, torch.zeros_like(res))
    jac = optimization.point_to_plane_jacobian(zero6, tp, nrm, ok)
    weights = optimization.robust_weights(scheme, res, sigma, sq_dists=sq_d,
                                          eps=eps)
    wres = res * weights
    wjac = jac * weights[:, None]
    h = torch.sum(wjac[:, :, None] * wjac[:, None, :], dim=0)
    g = torch.sum(wjac * wres[:, None], dim=0)
    upper = torch.stack([h[a, b] for a, b in _UPPER])
    wmass = torch.sum(torch.where(ok, weights * weights,
                                  torch.zeros_like(weights)))
    return torch.cat([upper, g, torch.stack([
        torch.sum(wres * wres), ok.sum().to(wres.dtype), wmass])])


def sum_errors(ours, ref) -> Tuple[float, float]:
    """How far two (30,) sum vectors are apart: (max |ours - ref|, max of
    |ours - ref| / scale).

    The scale is the largest value a float32 summation error can be
    relative to.  By Cauchy-Schwarz, sum |w^2 J_a J_b| <= sqrt(H_aa H_bb)
    and sum |w^2 J_a r| <= sqrt(H_aa loss), so H_ab uses sqrt(H_aa H_bb),
    g_a uses sqrt(H_aa loss), and the loss and weight mass use their own
    values.  Two float32 sums of n terms in different orders then differ
    by a small multiple of n_eff * 6e-8 of the scale.  The match count
    (scale 1) is an integer and must agree exactly.
    """
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    diag = [ref[_UPPER.index((a, a))] for a in range(6)]
    scale = np.array([math.sqrt(diag[a] * diag[b]) for a, b in _UPPER]
                     + [math.sqrt(diag[a] * ref[27]) for a in range(6)]
                     + [ref[27], 1.0, ref[29]])
    err = np.abs(ours - ref)
    return float(err.max()), float((err / np.maximum(scale, 1e-30)).max())


@functools.lru_cache(maxsize=None)
def _symmetric_index(device: torch.device) -> torch.Tensor:
    return torch.tensor([[_UPPER.index((min(a, b), max(a, b))) for b in range(6)]
                         for a in range(6)], device=device)


def unpack(sums: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(30,) sums -> (H (6, 6), g (6,), loss, match count, weight mass)."""
    return (sums[_symmetric_index(sums.device)], sums[21:27], sums[27],
            sums[28], sums[29])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from pylidar_slam_tpu_torch.ops.kernels.cuda_build import load_kernel_library
    lib = load_kernel_library("assoc_gn")
    lib.assoc_gn_partials_size.restype = ctypes.c_int
    lib.assoc_gn_partials_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.assoc_gn_launch.restype = ctypes.c_int
    lib.assoc_gn_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4)
    return lib


@functools.lru_cache(maxsize=None)
def _counter(device_index: int, stream: int) -> torch.Tensor:
    """The kernel's last-block ticket counter of one stream of a device:
    zeroed once here, on that stream, and left at 0 by every pass.  Passes
    on one stream never overlap; two streams (the CLI's parallel jobs) each
    draw their tickets from a counter of their own."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", device_index))


class _Capture:
    """A CUDA-graph capture's B1 state: the graph's ticket counter, zeroed
    before the capture and left at 0 by every replay, and the launches the
    capture recorded."""

    def __init__(self, device: torch.device):
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.launches = 0


_capturing = threading.local()


@contextlib.contextmanager
def capture(device: torch.device):
    """The scope of a CUDA-graph capture on this thread: B1's launches in
    it draw tickets from a counter of the graph's own (made here, before
    the capture begins, so nothing is allocated inside it; a graph may be
    replayed on any stream) and are counted in the yielded object's
    ``launches``, not in ``assoc_gn.launches``.  The graph's nodes hold the
    counter's address: keep the yielded ``counter`` as long as the graph."""
    _capturing.scope = scope = _Capture(device)
    try:
        yield scope
    finally:
        _capturing.scope = None


def add_launches(n: int) -> None:
    """Counts `n` launches a graph replay ran."""
    with LAUNCH_LOCK:
        assoc_gn.launches += n


def build() -> None:
    """Builds and loads the kernel library (raises BuildError on failure)."""
    _library()


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _check(timg, model_xyz, model_normal, model_valid):
    if timg.device.type != "cuda":
        raise ValueError(f"assoc_gn runs on CUDA or CPU tensors, got {timg.device}")
    h, w = model_valid.shape[0], model_valid.shape[1]
    if h * w == 0:
        raise ValueError("assoc_gn needs a non-empty image")
    for name, t in (("timg", timg), ("model_xyz", model_xyz),
                    ("model_normal", model_normal)):
        if t.shape != (h, w, 3) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({h}, {w}, 3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if model_valid.dim() != 2 or model_valid.dtype != torch.bool:
        raise ValueError("model_valid must be (H, W) bool")
    for name, t in (("timg", timg), ("model_xyz", model_xyz),
                    ("model_normal", model_normal), ("model_valid", model_valid)):
        if t.device != timg.device:
            raise ValueError(f"{name} is on {t.device}, timg on {timg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def assoc_gn(timg: torch.Tensor, model_xyz: torch.Tensor,
             model_normal: torch.Tensor, model_valid: torch.Tensor,
             wr: int, wc: int, max_nd: float, scheme: str, sigma: float,
             plane_gate: float = 0.0, eps: float = 1.0e-4) -> torch.Tensor:
    """Fused pass over (H, W, 3) target / model images -> (30,) sums.

    `max_nd` gates the squared candidate distance, `plane_gate` (> 0 to
    enable) the plane residual; `sigma` is the robust scale of `scheme`.
    CPU tensors run ``assoc_gn_plain``; CUDA tensors launch the kernel.
    """
    if timg.device.type == "cpu":
        return assoc_gn_plain(timg, model_xyz, model_normal, model_valid,
                              wr, wc, max_nd, scheme, sigma, plane_gate, eps)
    _check(timg, model_xyz, model_normal, model_valid)
    lib = _library()
    h, w = model_valid.shape
    partials = torch.empty(lib.assoc_gn_partials_size(h, w),
                           dtype=torch.float32, device=timg.device)
    out = torch.empty(NUM_OUT, dtype=torch.float32, device=timg.device)
    stream = torch.cuda.current_stream(timg.device)
    scope = getattr(_capturing, "scope", None)
    counter = scope.counter if scope is not None else \
        _counter(_device_index(timg.device), stream.cuda_stream)
    err = lib.assoc_gn_launch(
        timg.data_ptr(), model_xyz.data_ptr(), model_normal.data_ptr(),
        model_valid.data_ptr(), h, w, int(wr), int(wc),
        float(max_nd) * float(max_nd), SCHEME_IDS[scheme], float(sigma),
        float(sigma) ** 2, float(plane_gate), float(eps),
        partials.data_ptr(), counter.data_ptr(), out.data_ptr(),
        stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"assoc_gn launch failed with cudaError_t {err}")
    if scope is not None:
        scope.launches += 1
    else:
        add_launches(1)  # job threads launch concurrently
    return out


assoc_gn.launches = 0
