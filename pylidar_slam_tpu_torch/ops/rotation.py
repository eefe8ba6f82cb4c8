"""Euler-angle rotation algebra with analytic Jacobians (torch port of
``pylidar_slam_tpu.ops.rotation``).

Convention: ``R = Rz(ez) @ Ry(ey) @ Rx(ex)`` with parameters ordered
``(ex, ey, ez)``, the reference implementation's "xyz" euler.
"""
from __future__ import annotations

import numpy as np
import torch


def _stack3x3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rx(c, s):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def _ry(c, s):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack3x3([[c, z, s], [z, o, z], [-s, z, c]])


def _rz(c, s):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


def _jac_rx(c, s):
    z = torch.zeros_like(c)
    return _stack3x3([[z, z, z], [z, -s, -c], [z, c, -s]])


def _jac_ry(c, s):
    z = torch.zeros_like(c)
    return _stack3x3([[-s, z, c], [z, z, z], [-c, z, -s]])


def _jac_rz(c, s):
    z = torch.zeros_like(c)
    return _stack3x3([[-s, -c, z], [c, -s, z], [z, z, z]])


def euler_to_mat(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) [ex, ey, ez] -> rotation matrices (..., 3, 3)."""
    c, s = torch.cos(angles), torch.sin(angles)
    return _rz(c[..., 2], s[..., 2]) @ _ry(c[..., 1], s[..., 1]) @ \
        _rx(c[..., 0], s[..., 0])


def np_euler_to_mat(angles) -> np.ndarray:
    """Float64 numpy ``euler_to_mat`` for host-side code."""
    angles = np.asarray(angles, np.float64)
    cx, cy, cz = np.cos(angles[..., 0]), np.cos(angles[..., 1]), np.cos(angles[..., 2])
    sx, sy, sz = np.sin(angles[..., 0]), np.sin(angles[..., 1]), np.sin(angles[..., 2])
    out = np.empty(angles.shape[:-1] + (3, 3), np.float64)
    out[..., 0, 0] = cz * cy
    out[..., 0, 1] = cz * sy * sx - sz * cx
    out[..., 0, 2] = cz * sy * cx + sz * sx
    out[..., 1, 0] = sz * cy
    out[..., 1, 1] = sz * sy * sx + cz * cx
    out[..., 1, 2] = sz * sy * cx - cz * sx
    out[..., 2, 0] = -sy
    out[..., 2, 1] = cy * sx
    out[..., 2, 2] = cy * cx
    return out


def mat_to_euler(rot: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> euler angles (..., 3), gimbal-lock
    safe without branches."""
    sy = torch.sqrt(rot[..., 0, 0] * rot[..., 0, 0] + rot[..., 1, 0] * rot[..., 1, 0])
    singular = sy < eps
    x_ns = torch.atan2(rot[..., 2, 1], rot[..., 2, 2])
    y = torch.atan2(-rot[..., 2, 0], sy)
    z_ns = torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    x_s = torch.atan2(-rot[..., 1, 2], rot[..., 1, 1])
    x = torch.where(singular, x_s, x_ns)
    z = torch.where(singular, torch.zeros_like(z_ns), z_ns)
    return torch.stack([x, y, z], dim=-1)


def euler_jacobian(angles: torch.Tensor) -> torch.Tensor:
    """Analytic dR/d(ex,ey,ez): (B, 3) -> (B, 3, 3, 3)."""
    c, s = torch.cos(angles), torch.sin(angles)
    rz = _rz(c[..., 2], s[..., 2])
    ry = _ry(c[..., 1], s[..., 1])
    rx = _rx(c[..., 0], s[..., 0])
    jx = rz @ ry @ _jac_rx(c[..., 0], s[..., 0])
    jy = rz @ _jac_ry(c[..., 1], s[..., 1]) @ rx
    jz = _jac_rz(c[..., 2], s[..., 2]) @ ry @ rx
    return torch.stack([jx, jy, jz], dim=-3)


def pose_matrix_jacobian(pose_params: torch.Tensor) -> torch.Tensor:
    """Analytic d(4x4 pose matrix)/d(6 params): (B, 6) -> (B, 6, 4, 4)."""
    b = pose_params.shape[0]
    jac = pose_params.new_zeros((b, 6, 4, 4))
    jac[:, 0, 0, 3] = 1.0
    jac[:, 1, 1, 3] = 1.0
    jac[:, 2, 2, 3] = 1.0
    jac[:, 3:, :3, :3] = euler_jacobian(pose_params[:, 3:])
    return jac
