"""Vertex-map geometry (torch port of ``pylidar_slam_tpu.ops.geometry``):
the box-filtered covariance normal map (channels-last ``(H, W, 3)``), the
k-NN plane normals of the surfel map and the projective association of the
ring-buffer map (per-pixel min over K reference maps).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pylidar_slam_tpu_torch.ops.projection import point_norm


def mask_not_null(tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """True where at least one channel along `dim` is non-zero (keepdim)."""
    return torch.amax(torch.abs(tensor), dim=dim, keepdim=True) > 0


def box_filter(image: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Window SUM with SAME zero padding over the H and W dims of an
    (..., H, W, C) image, as padded shifted adds in float32.

    Written out rather than as a convolution: cuDNN would run a float32
    convolution in TF32 unless told otherwise, and the normal fit below is
    sensitive to the rounding of these sums at long range.  The window is
    added in row-major order, one tap at a time -- the order of the JAX
    package's ``reduce_window``, so both round alike.
    """
    h, w = image.shape[-3:-1]
    pad = kernel_size // 2
    padded = F.pad(image, (0, 0, pad, pad, pad, pad))
    out = torch.zeros_like(image)
    for dr in range(kernel_size):
        for dc in range(kernel_size):
            out = out + padded[..., dr:dr + h, dc:dc + w, :]
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
    """Unit normals of an (..., H, W, 3) vertex map.

    Solves, per pixel, ``(sum_w v v^T) n = sum_w v`` over a k x k window
    (null pixels contribute zeros), then normalizes.  Singular windows and
    null pixels get a zero normal.
    """
    lead = vertex_map.shape[:-1]
    v_boxed = box_filter(vertex_map, kernel_size)
    outer = vertex_map[..., :, None] * vertex_map[..., None, :]
    cov_boxed = box_filter(outer.reshape(lead + (9,)), kernel_size).reshape(lead + (3, 3))

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


def compute_normal_map_centered(vertex_map: torch.Tensor, kernel_size: int = 5,
                                min_neighbors: int = 3) -> torch.Tensor:
    """Window plane fit by the CENTERED covariance: each k x k window's
    valid vertices are centered on the window mean before the outer
    products (entries scale with the window's spread, not its range), and
    the normal is the covariance's smallest eigenvector, turned to point
    away from the sensor.  Pixels that are null or have fewer than
    `min_neighbors` valid window neighbours get a zero normal.

    The k^2 shifted outer products are added to a running covariance in
    the JAX package's order (rows outer, columns inner), each as one fused
    multiply-add: the compiled JAX program contracts them so, and 99.6% of
    the covariance entries of a 32x256 scan then round alike (against 65%
    with a separate product and sum).
    """
    h, w, _ = vertex_map.shape
    pad = kernel_size // 2
    valid = point_norm(vertex_map) > 0
    vw = vertex_map * valid[..., None]
    cnt = box_filter(valid[..., None].to(vertex_map.dtype), kernel_size)[..., 0]
    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = box_filter(vw, kernel_size) / safe_cnt[..., None]

    vp = F.pad(vw, (0, 0, pad, pad, pad, pad))
    mp = F.pad(valid, (pad, pad, pad, pad))
    cov = vertex_map.new_zeros((h, w, 3, 3))
    for dr in range(kernel_size):
        for dc in range(kernel_size):
            u = (vp[dr:dr + h, dc:dc + w] - mean) * mp[dr:dr + h, dc:dc + w, None]
            cov = torch.addcmul(cov, u[..., :, None], u[..., None, :])
    n = smallest_eigenvector_3x3(cov / safe_cnt[..., None, None])

    ok = valid & (cnt >= min_neighbors)
    flip = torch.sum(n * vertex_map, dim=-1, keepdim=True) < 0
    n = torch.where(flip, -n, n)
    return torch.where(ok[..., None], n, torch.zeros_like(n))


def smallest_eigenvector_3x3(m: torch.Tensor, eps: float = 1.0e-9) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric
    (..., 3, 3) matrices, in closed form: the eigenvalues from the
    trigonometric solution of the characteristic cubic, the eigenvector from
    the column space of ``(A - l1 I)(A - l2 I)``.  Near-isotropic matrices
    (plane undefined) give zeros."""
    a00, a11, a22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    a01, a02, a12 = m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.where(p > eps, p, torch.ones_like(p))
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    b = (m - q[..., None, None] * eye) / safe_p[..., None, None]
    det_b = (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
             - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
             + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0]))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)  # largest
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3

    prod = (m - l1[..., None, None] * eye) @ (m - l2[..., None, None] * eye)
    col_norms = torch.linalg.vector_norm(prod, dim=-2)  # (..., 3) per column
    best = torch.argmax(col_norms, dim=-1)
    v = torch.gather(prod, -1, best[..., None, None].expand(*m.shape[:-2], 3, 1))[..., 0]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = (p > eps)[..., None] & (norm > eps)
    unit = v / torch.where(norm > eps, norm, torch.ones_like(norm))
    return torch.where(ok, unit, torch.zeros_like(unit))


def knn_plane_normals(neighbors: torch.Tensor, valid: torch.Tensor,
                      min_neighbors: int = 3) -> torch.Tensor:
    """Per-query plane normal from k gathered neighbours: the smallest
    eigenvector of the valid neighbours' sample covariance.  ``neighbors``
    (M, k, 3) with validity (M, k); queries with fewer than
    ``min_neighbors`` valid neighbours get a zero normal."""
    w = valid.to(neighbors.dtype)[..., None]  # (M, k, 1)
    count = torch.clamp(torch.sum(w, dim=1), min=1.0)  # (M, 1)
    # The sums over the k neighbours run in neighbour order, the covariance
    # as a multiply-add chain: on the CPU that rounds as the JAX package's
    # reduction and einsum do, and a near-degenerate covariance decides its
    # eigenvector on such roundings.
    weighted = neighbors * w
    total = weighted[:, 0]
    for j in range(1, weighted.shape[1]):
        total = total + weighted[:, j]
    mean = total / count
    centered = (neighbors - mean[:, None, :]) * w
    cov = torch.zeros(centered.shape[:1] + (3, 3), dtype=centered.dtype,
                      device=centered.device)
    for j in range(centered.shape[1]):
        cov = torch.addcmul(cov, centered[:, j, :, None], centered[:, j, None, :])
    n = smallest_eigenvector_3x3(cov / count[..., None])
    enough = torch.sum(valid, dim=1) >= min_neighbors
    return torch.where(enough[:, None], n, torch.zeros_like(n))


def oriented_normal_map(vertex_map: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """``compute_normal_map`` with the normals turned towards the sensor."""
    n = compute_normal_map(vertex_map, kernel_size)
    flip = torch.sum(n * vertex_map, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def compute_neighbors(vm_target: torch.Tensor, vm_reference: torch.Tensor,
                      reference_fields: Optional[torch.Tensor] = None):
    """Projective nearest neighbour: per pixel, the closest of K reference
    maps' vertices at the same pixel.

    Args:
        vm_target: (H, W, 3) target vertex map.
        vm_reference: (K, H, W, 3) reference vertex maps.
        reference_fields: optional (K, H, W, C) fields gathered at the argmin.

    Returns (neighbors (H, W, 3), fields (H, W, C) or None), zero where the
    target pixel is null or no reference vertex is.  The first minimum wins
    ties (``torch.argmin``, as ``jnp.argmin``).
    """
    mask_target = mask_not_null(vm_target)  # (H, W, 1)
    mask_reference = mask_not_null(vm_reference)  # (K, H, W, 1)
    diff = point_norm(vm_target[None] - vm_reference)[..., None]
    inf = torch.full_like(diff, math.inf)
    diff = torch.where(mask_reference & mask_target[None], diff, inf)[..., 0]

    best = torch.argmin(diff, dim=0)  # (H, W)
    best_dist = torch.gather(diff, 0, best[None])[0]
    keep = torch.isfinite(best_dist)[..., None] & mask_target

    def take(maps):
        got = torch.gather(maps, 0, best[None, ..., None].expand(
            1, *maps.shape[1:]))[0]
        return torch.where(keep, got, torch.zeros_like(got))

    fields = None if reference_fields is None else take(reference_fields)
    return take(vm_reference), fields
