"""Closed-form rigid registration: weighted Procrustes / Kabsch (torch port
of ``pylidar_slam_tpu.ops.registration``).

The 3x3 SVD is a fixed number of one-sided Jacobi sweeps written in tensor
ops: ``torch.linalg.svd`` on a CUDA tensor checks its solver's status on
the host, a sync inside every ICP iteration of the procrustes path.
"""
from __future__ import annotations

from typing import Optional

import torch

JACOBI_SWEEPS = 6  # a 3x3 float32 sweep pair converges in 3-4; 6 leaves margin
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _jacobi_svd3(h: torch.Tensor):
    """One-sided Jacobi SVD of (B, 3, 3) matrices: rotations on the right
    make the columns of h V orthogonal, so h V = U S.  Returns (the columns
    a_k = s_k u_k and the columns v_k, each a list of three (B, 3) tensors,
    and the singular values (B, 3)), unsorted."""
    a = [h[..., 0], h[..., 1], h[..., 2]]
    eye = torch.eye(3, dtype=h.dtype, device=h.device).expand_as(h)
    v = [eye[..., 0], eye[..., 1], eye[..., 2]]
    tiny = torch.finfo(h.dtype).tiny
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            alpha = torch.sum(a[p] * a[p], dim=-1, keepdim=True)
            beta = torch.sum(a[q] * a[q], dim=-1, keepdim=True)
            gamma = torch.sum(a[p] * a[q], dim=-1, keepdim=True)
            rotate = torch.abs(gamma) > tiny
            zeta = (beta - alpha) / (2.0 * torch.where(rotate, gamma,
                                                       torch.ones_like(gamma)))
            sign = torch.where(zeta >= 0, torch.ones_like(zeta), -torch.ones_like(zeta))
            # |zeta| past 1e18 overflows zeta^2 to inf and gives t = 0, the
            # limit: the pair is already orthogonal to float32 precision
            t = sign / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(rotate, t, torch.zeros_like(t))
            c = torch.rsqrt(1.0 + t * t)
            s = c * t
            a[p], a[q] = c * a[p] - s * a[q], s * a[p] + c * a[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]
    sing = torch.stack([torch.linalg.vector_norm(x, dim=-1) for x in a], dim=-1)
    return a, v, sing


def kabsch_rotation(h: torch.Tensor) -> torch.Tensor:
    """The proper rotation R = V diag(1, 1, det(V U^T)) U^T of the SVD
    h = U S V^T, for (B, 3, 3) cross-covariances h = sum w tgt_c ref_c^T.

    With v1, v2 and u1 = h v1 / s1, u2 = h v2 / s2 of the two largest
    singular values, R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T: for
    orthonormal bases v1 x v2 = det(V) v3 and u1 x u2 = det(U) u3, so the
    last term is det(V U^T) v3 u3^T, the Kabsch sign flip included, and the
    smallest singular vector (ill-determined for planar data) is never
    formed.
    """
    a, v, sing = _jacobi_svd3(h)
    order = torch.argsort(sing, dim=-1, descending=True, stable=True)
    cols_a = torch.stack(a, dim=-1)  # (B, 3, 3), column k = a_k
    cols_v = torch.stack(v, dim=-1)

    def column(mat, k):
        idx = order[..., k, None, None].expand(*order.shape[:-1], 3, 1)
        return torch.gather(mat, -1, idx)[..., 0]

    def unit(x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=torch.finfo(x.dtype).tiny)

    v1, v2 = column(cols_v, 0), column(cols_v, 1)
    u1, u2 = unit(column(cols_a, 0)), unit(column(cols_a, 1))
    v3, u3 = _cross(v1, v2), _cross(u1, u2)
    return (v1[..., :, None] * u1[..., None, :] + v2[..., :, None] * u2[..., None, :]
            + v3[..., :, None] * u3[..., None, :])


def weighted_procrustes(ref_points: torch.Tensor, target_points: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rigid transform T minimizing sum w ||T(target) - ref||^2.

    ref_points, target_points (B, N, 3); weights (B, N) non-negative
    (masking = zero weight).  Returns (B, 4, 4) pose matrices mapping
    target -> ref.
    """
    b, n, _ = ref_points.shape
    if weights is None:
        weights = ref_points.new_ones((b, n))
    wsum = torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-12)
    wn = (weights / wsum)[..., None]
    mu_ref = torch.sum(ref_points * wn, dim=1, keepdim=True)
    mu_tgt = torch.sum(target_points * wn, dim=1, keepdim=True)
    ref_c = ref_points - mu_ref
    tgt_c = target_points - mu_tgt
    h = (weights[..., None] * tgt_c).transpose(1, 2) @ ref_c
    rot = kabsch_rotation(h)
    tr = mu_ref[:, 0, :] - torch.sum(rot * mu_tgt, dim=-1)
    mat = ref_points.new_zeros((b, 4, 4))
    mat[:, :3, :3] = rot
    mat[:, :3, 3] = tr
    mat[:, 3:, 3] = 1.0
    return mat
