"""Vertex-map geometry (torch port of ``pylidar_slam_tpu.ops.geometry``):
the box-filtered covariance normal map.  Channels-last ``(H, W, 3)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pylidar_slam_tpu_torch.ops.projection import point_norm


def box_filter(image: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Window SUM with SAME zero padding over the two leading dims of an
    (H, W, C) image, as padded shifted adds in float32.

    Written out rather than as a convolution: cuDNN would run a float32
    convolution in TF32 unless told otherwise, and the normal fit below is
    sensitive to the rounding of these sums at long range.  The window is
    added in row-major order, one tap at a time -- the order of the JAX
    package's ``reduce_window``, so both round alike.
    """
    h, w, _ = image.shape
    pad = kernel_size // 2
    padded = F.pad(image, (0, 0, pad, pad, pad, pad))
    out = torch.zeros_like(image)
    for dr in range(kernel_size):
        for dc in range(kernel_size):
            out = out + padded[dr:dr + h, dc:dc + w]
    return out


def _adjugate_3x3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., 3, 3) matrices: inv(m) = adj(m) / det(m)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)


def inverse_3x3(m: torch.Tensor, eps: float = 1.0e-6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form 3x3 inverse -> (inverse, det); singular matrices
    (|det| <= eps) give a zero inverse (the reference's det guard)."""
    adj = _adjugate_3x3(m)
    det = (m[..., 0, 0] * adj[..., 0, 0] + m[..., 0, 1] * adj[..., 1, 0]
           + m[..., 0, 2] * adj[..., 2, 0])
    ok = torch.abs(det) > eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    inv = adj / safe_det[..., None, None]
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv)), det


def compute_normal_map(vertex_map: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Unit normals of an (H, W, 3) vertex map.

    Solves, per pixel, ``(sum_w v v^T) n = sum_w v`` over a k x k window
    (null pixels contribute zeros), then normalizes.  Singular windows and
    null pixels get a zero normal.
    """
    h, w, _ = vertex_map.shape
    v_boxed = box_filter(vertex_map, kernel_size)
    outer = vertex_map[..., :, None] * vertex_map[..., None, :]
    cov_boxed = box_filter(outer.reshape(h, w, 9), kernel_size).reshape(h, w, 3, 3)

    inv, det = inverse_3x3(cov_boxed)
    n = (inv @ v_boxed[..., None])[..., 0]

    ok = torch.abs(det) > 1.0e-6
    norms = point_norm(n)[..., None]
    pos = norms > 0
    n = torch.where(pos, n / torch.where(pos, norms, torch.ones_like(norms)),
                    torch.zeros_like(n))
    n = torch.where(ok[..., None], n, torch.zeros_like(n))
    null_pixel = point_norm(vertex_map)[..., None] == 0.0
    return torch.where(null_pixel, torch.zeros_like(n), n)
