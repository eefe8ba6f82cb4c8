"""Point-sharded ICP Gauss-Newton over the ranks of a group (torch port of
``pylidar_slam_tpu.parallel.sharded_icp``).

Each rank holds a slice of the points, forms its partial 6x6 normal
equations, and one all-reduce of the (6,6)+(6,)+() payload per iteration
gives every rank the same system to solve.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.ops import optimization


def point_sharded_gauss_newton_step(group: dist.ProcessGroup,
                                    scheme: str = "least_square",
                                    sigma: float = 0.5) -> Callable:
    """Builds ``step(params (6,), target (n, 3), ref (n, 3), normals (n, 3),
    mask (n,)) -> (dx (6,), loss)`` for this rank's n points; dx and loss
    are the same on every rank of `group` (computed from the all-reduced
    normal equations)."""

    def step(params, target, ref, normals, mask):
        res = optimization.point_to_plane_residuals(params, target, ref, normals, mask)
        jac = optimization.point_to_plane_jacobian(params, target, normals, mask)
        sq_d = torch.sum((target - ref) ** 2, dim=-1)
        w = optimization.robust_weights(scheme, res, sigma, sq_dists=sq_d)
        h, g, loss = optimization.normal_equations(res, jac, w, group=group)
        eye = torch.eye(6, dtype=h.dtype, device=h.device)
        chol = torch.linalg.cholesky(h + 1e-8 * eye)
        return -torch.cholesky_solve(g[:, None], chol)[:, 0], loss

    return step
