"""SE(3) pose utilities (torch port of ``pylidar_slam_tpu.ops.se3``).

The pose parameterization is ``(tx, ty, tz, ex, ey, ez)`` (euler "xyz").
Device functions are batched over leading dims; ``PosesInterpolator`` is the
host-side numpy utility the datasets use.
"""
from __future__ import annotations

import numpy as np
import torch

from pylidar_slam_tpu_torch.ops import rotation


def build_pose_matrix(params: torch.Tensor) -> torch.Tensor:
    """(B, 6) params -> (B, 4, 4) pose matrices."""
    b = params.shape[0]
    mat = params.new_zeros((b, 4, 4))
    mat[:, :3, :3] = rotation.euler_to_mat(params[:, 3:])
    mat[:, :3, 3] = params[:, :3]
    mat[:, 3, 3] = 1.0
    return mat


def from_pose_matrix(matrices: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) pose matrices -> (B, 6) params."""
    angles = rotation.mat_to_euler(matrices[:, :3, :3])
    return torch.cat([matrices[:, :3, 3], angles], dim=-1)


def inverse_pose_matrix(matrices: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of (..., 4, 4) rigid transforms."""
    rt = matrices[..., :3, :3].transpose(-1, -2)
    inv = torch.zeros_like(matrices)
    inv[..., :3, :3] = rt
    inv[..., :3, 3] = -(rt @ matrices[..., :3, 3:4])[..., 0]
    # a slice, not a 0-dim element: setting a 0-dim CUDA view from a Python
    # number copies a host scalar and syncs; a slice is filled on the device
    inv[..., 3:, 3] = 1.0
    return inv


def apply_transformation(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Applies (..., 4, 4) rigid transforms to (..., N, 3) point clouds."""
    return points @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]


def apply_rotation(vectors: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Applies the rotation of (..., 4, 4) transforms to (..., N, 3) vectors."""
    return vectors @ pose[..., :3, :3].transpose(-1, -2)


def normalize_pose_matrix(matrices: torch.Tensor) -> torch.Tensor:
    """Re-projects the rotation block onto SO(3) (euler round-trip)."""
    return build_pose_matrix(from_pose_matrix(matrices))


def pose_motion_magnitude(delta: torch.Tensor, lever_m: float = 15.0) -> torch.Tensor:
    """Scalar motion of a (4, 4) relative pose: translation norm plus the
    rotation as point displacement at a `lever_m` arm
    (||R - I||_F ~= sqrt(2) * angle for small angles)."""
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    return torch.linalg.vector_norm(delta[:3, 3]) + (lever_m / 1.4142135) * \
        torch.linalg.vector_norm(delta[:3, :3] - eye)


# ----------------------------------------------------------------------------
# Quaternions (the slerp of the de-skew and elastic warps, on the device)
# ----------------------------------------------------------------------------

def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) unit quaternions (w, x, y, z).

    Branchless Shepperd extraction: all four candidate formulas are
    computed and the one with the largest score is selected per matrix.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Slerp between quaternions; `alpha` broadcasts against (..., 1).
    Near-parallel pairs (sin theta < 1e-6) fall back to lerp."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe_sin)
    w1 = torch.where(small, alpha, torch.sin(alpha * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def interpolate_pose(pose: torch.Tensor, alphas: torch.Tensor):
    """Per-point fractions of a (4, 4) motion: slerp(I, pose, alpha) for the
    rotation, alpha * t for the translation.  `alphas` (N,) in [0, 1] ->
    ((N, 3, 3) rotations, (N, 3) translations)."""
    n = alphas.shape[0]
    q1 = mat_to_quat(pose[:3, :3])
    # the identity quaternion built on the device (a host tensor copied up
    # would sync)
    q0 = torch.cat([torch.ones_like(q1[:1]), torch.zeros_like(q1[1:])])
    qs = quat_slerp(q0.expand(n, 4), q1.expand(n, 4), alphas[:, None])
    return quat_to_mat(qs), alphas[:, None] * pose[:3, 3][None, :]


def warp_points(rots: torch.Tensor, trs: torch.Tensor, points: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """R_n p_n + t_n per point for (N, 3, 3) rotations, (N, 3) translations
    and points; rows outside `mask` are zero.  Written as a broadcast
    product and a 3-term sum, not a batched matmul of N 3x3 blocks."""
    p = torch.sum(rots * points[:, None, :], dim=-1) + trs
    return torch.where(mask[:, None], p, torch.zeros_like(p))


# ----------------------------------------------------------------------------
# Host-side (numpy) pose interpolation for datasets
# ----------------------------------------------------------------------------

def np_mat_to_quat(rot: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) unit quaternions (w, x, y, z), branchless."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = np.sqrt(np.maximum(1.0 + tr, 1e-12)) / 2.0
    q0 = np.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                   (m10 - m01) / (4 * qw0)], axis=-1)
    qx1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12)) / 2.0
    q1 = np.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                   (m02 + m20) / (4 * qx1)], axis=-1)
    qy2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-12)) / 2.0
    q2 = np.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                   (m12 + m21) / (4 * qy2)], axis=-1)
    qz3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-12)) / 2.0
    q3 = np.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                   (m12 + m21) / (4 * qz3), qz3], axis=-1)
    scores = np.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                       -m00 - m11 + m22], axis=-1)
    best = np.argmax(scores, axis=-1)
    qs = np.stack([q0, q1, q2, q3], axis=-2)
    q = np.take_along_axis(
        qs, np.repeat(best[..., None, None], 4, axis=-1), axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def np_quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], axis=-1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], axis=-1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def np_quat_slerp(q0: np.ndarray, q1: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    dot = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(dot < 0, -q1, q1)
    dot = np.clip(np.abs(dot), -1.0, 1.0)
    theta = np.arccos(dot)
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = np.where(small, 1.0, sin_theta)
    w0 = np.where(small, 1.0 - alpha, np.sin((1.0 - alpha) * theta) / safe_sin)
    w1 = np.where(small, alpha, np.sin(alpha * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class PosesInterpolator:
    """Slerp + lerp interpolation of (N, 4, 4) poses over timestamps (host)."""

    def __init__(self, poses: np.ndarray, timestamps: np.ndarray):
        assert poses.ndim == 3 and poses.shape[1:] == (4, 4)
        order = np.argsort(timestamps)
        self.timestamps = timestamps[order]
        self.poses = poses[order]
        self.quats = np_mat_to_quat(self.poses[:, :3, :3])
        self.min_timestamp = self.timestamps.min()
        self.max_timestamp = self.timestamps.max()

    def __call__(self, query: np.ndarray) -> np.ndarray:
        query = np.clip(query, self.min_timestamp, self.max_timestamp)
        idx = np.searchsorted(self.timestamps, query, side="right") - 1
        idx = np.clip(idx, 0, len(self.timestamps) - 2)
        t0 = self.timestamps[idx]
        t1 = self.timestamps[idx + 1]
        denom = np.where(t1 - t0 <= 0, 1.0, t1 - t0)
        alpha = ((query - t0) / denom).reshape(-1, 1)
        rots = np_quat_to_mat(np_quat_slerp(self.quats[idx],
                                            self.quats[idx + 1], alpha))
        trs = (1 - alpha) * self.poses[idx, :3, 3] + alpha * self.poses[idx + 1, :3, 3]
        out = np.tile(np.eye(4, dtype=np.float64), (query.shape[0], 1, 1))
        out[:, :3, :3] = rots
        out[:, :3, 3] = trs
        return out
