"""Robust weighted least squares + Gauss-Newton on SE(3) (torch port of
``pylidar_slam_tpu.ops.optimization``).

IRLS weights ``w_i = sqrt(C(r_i)) / max(|r_i|, eps)`` for a robust cost C,
then Gauss-Newton steps ``dx = -(J^T J)^{-1} J^T r`` on the weighted system.
Everything is masked fixed-shape, and the 6x6 solve stays on the device
without a host sync (``cholesky_ex`` reports failure in a tensor).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.ops import rotation, se3

SCHEMES = ("least_square", "default", "huber", "exp", "neighborhood",
           "geman_mcclure", "square_geman_mcclure", "cauchy")


def robust_cost(scheme: str, residuals: torch.Tensor, sigma,
                sq_dists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Robust cost C(r) for each residual (elementwise)."""
    r2 = residuals * residuals
    if scheme in ("least_square", "default"):
        return r2
    if scheme == "huber":
        abs_r = torch.abs(residuals)
        return torch.where(abs_r < sigma, r2, 2.0 * sigma * abs_r - sigma ** 2)
    if scheme == "exp":
        return r2 * torch.exp(-r2 / sigma ** 2)
    if scheme == "neighborhood":
        assert sq_dists is not None, "neighborhood scheme requires sq_dists"
        return r2 * torch.exp(-sq_dists / sigma ** 2)
    if scheme == "geman_mcclure":
        return sigma * r2 / (sigma + r2)
    if scheme == "square_geman_mcclure":
        return r2 * (sigma / (sigma + r2)) ** 2
    if scheme == "cauchy":
        return torch.log(1.0 + (residuals / sigma) ** 2)
    raise ValueError(f"Unknown least-square scheme: {scheme}")


def robust_weights(scheme: str, residuals: torch.Tensor, sigma,
                   sq_dists: Optional[torch.Tensor] = None,
                   eps: float = 1.0e-4) -> torch.Tensor:
    """IRLS attenuation weights sqrt(C(r)) / max(|r|, eps)."""
    if scheme in ("least_square", "default"):
        return torch.ones_like(residuals)
    clamped = torch.clamp(torch.abs(residuals), min=eps)
    return torch.sqrt(robust_cost(scheme, residuals, sigma, sq_dists)) / clamped


# ----------------------------------------------------------------------------
# Point-to-plane residuals and analytic Jacobian
# ----------------------------------------------------------------------------

def point_to_plane_residuals(params: torch.Tensor,
                             target_points: torch.Tensor,
                             ref_points: torch.Tensor,
                             ref_normals: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residuals ((T(params) p - q) . n) for (N, 3) correspondences -> (N,)."""
    mat = se3.build_pose_matrix(params[None])[0]
    transformed = se3.apply_transformation(target_points, mat)
    res = torch.sum((transformed - ref_points) * ref_normals, dim=-1)
    if mask is not None:
        res = torch.where(mask, res, torch.zeros_like(res))
    return res


def point_to_plane_jacobian(params: torch.Tensor,
                            target_points: torch.Tensor,
                            ref_normals: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Analytic Jacobian of the point-to-plane residuals: (N, 6),
    J[n, p] = (dT/dx_p @ p_n) . n_n."""
    jac_mat = rotation.pose_matrix_jacobian(params[None])[0]  # (6, 4, 4)
    jac_rot = jac_mat[:, :3, :3]
    jac_tr = jac_mat[:, :3, 3]
    dpt = torch.einsum("pij,nj->pni", jac_rot, target_points) + jac_tr[:, None, :]
    jac = torch.einsum("pni,ni->np", dpt, ref_normals)
    if mask is not None:
        jac = torch.where(mask[:, None], jac, torch.zeros_like(jac))
    return jac


def point_to_plane_at_identity(points: torch.Tensor, ref_points: torch.Tensor,
                               ref_normals: torch.Tensor,
                               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``point_to_plane_residuals`` and ``point_to_plane_jacobian`` at the
    zero pose delta, where T = I: r = (p - q) . n and J = [n, p x n], without
    building the pose matrix and its derivative (kernel B1 forms them so)."""
    res = torch.sum((points - ref_points) * ref_normals, dim=-1)
    jac = torch.cat([ref_normals, torch.linalg.cross(points, ref_normals)], dim=-1)
    return (torch.where(mask, res, torch.zeros_like(res)),
            torch.where(mask[:, None], jac, torch.zeros_like(jac)))


def point_to_point_residuals(params: torch.Tensor,
                             target_points: torch.Tensor,
                             ref_points: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean distance residuals ||T(params) p - q|| -> (N,); masked rows
    are exactly zero."""
    mat = se3.build_pose_matrix(params[None])[0]
    diff = se3.apply_transformation(target_points, mat) - ref_points
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = torch.where(mask, sq, torch.zeros_like(sq))
    return _sqrt(torch.clamp(sq, min=1e-20)) * (sq > 0)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  CUDA's sqrtf is; torch's vectorized
    CPU sqrt is not always (1 ulp on ~0.5% of inputs), so on the CPU it
    goes through float64, whose sqrt rounded once more to float32 is the
    correctly rounded float32 result."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def point_to_point_jacobian(params: torch.Tensor,
                            target_points: torch.Tensor,
                            ref_points: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Analytic Jacobian of the point-to-point NORM residuals: (N, 6),
    J[n, p] = (dT/dx_p @ p_n) . (T p_n - q_n) / ||T p_n - q_n||."""
    jac_mat = rotation.pose_matrix_jacobian(params[None])[0]
    jac_rot = jac_mat[:, :3, :3]
    jac_tr = jac_mat[:, :3, 3]
    dpt = torch.einsum("pij,nj->pni", jac_rot, target_points) + jac_tr[:, None, :]
    mat = se3.build_pose_matrix(params[None])[0]
    diff = se3.apply_transformation(target_points, mat) - ref_points
    norms = torch.clamp(torch.linalg.vector_norm(diff, dim=-1, keepdim=True), min=1e-9)
    u = diff / norms
    # the 3-term dot as a fused multiply-add chain in index order: the
    # rounding of the JAX package's contraction on the CPU
    jac = torch.addcmul(torch.addcmul(dpt[..., 0] * u[:, 0], dpt[..., 1], u[:, 1]),
                        dpt[..., 2], u[:, 2]).T
    if mask is not None:
        jac = torch.where(mask[:, None], jac, torch.zeros_like(jac))
    return jac


# ----------------------------------------------------------------------------
# Gauss-Newton
# ----------------------------------------------------------------------------

def add_pose_prior(h: torch.Tensor, g: torch.Tensor,
                   prior_res: Optional[torch.Tensor],
                   prior_weight: Optional[torch.Tensor]):
    """Quadratic pose priors on a 6x6 system: the per-parameter cost
    ``prior_weight[i] * (prior_res[i] + dx[i])^2`` adds diag(w) to H and
    w * prior_res to g (identity-Jacobian residuals, no extra rows)."""
    if prior_res is None or prior_weight is None:
        return h, g
    return h + torch.diag(prior_weight), g + prior_weight * prior_res


def solve_normal_equations(h: torch.Tensor, g: torch.Tensor,
                           det_threshold: float = 1.0e-7,
                           prior_res: Optional[torch.Tensor] = None,
                           prior_weight: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dx = -H^{-1} g by Cholesky, on the device with no host sync, after
    the optional pose priors (``add_pose_prior``).

    Singular systems (|det| < det_threshold, the reference's guard) give
    dx = 0 and singular = True.  H is a sum of outer products (positive
    semi-definite), so det(H) is the squared product of the Cholesky
    diagonal, and a factorization that fails marks H singular as well.
    """
    h, g = add_pose_prior(h, g, prior_res, prior_weight)
    chol, info = torch.linalg.cholesky_ex(h)
    det = torch.prod(torch.diagonal(chol)) ** 2
    singular = (info != 0) | (torch.abs(det) < det_threshold)
    dx = -torch.cholesky_solve(g[:, None], chol)[:, 0]
    return torch.where(singular, torch.zeros_like(dx), dx), singular


class GNResult(NamedTuple):
    params: torch.Tensor  # (6,) optimized parameters
    loss: torch.Tensor  # () sum of squared weighted residuals
    delta_norm: torch.Tensor  # () norm of the last step
    singular: torch.Tensor  # () bool: hit a singular 6x6 system


def normal_equations(res: torch.Tensor, jac: torch.Tensor, weights: torch.Tensor,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (6, 6), g (6,), loss) of the weighted residuals (N,) and Jacobian
    (N, 6).  With a process `group`, each rank holds a slice of the points
    and the partial sums are added over the group's ranks by one all-reduce,
    so every rank ends with the same system."""
    wres = res * weights
    wjac = jac * weights[:, None]
    h = torch.sum(wjac[:, :, None] * wjac[:, None, :], dim=0)
    g = torch.sum(wjac * wres[:, None], dim=0)
    loss = torch.sum(wres * wres)
    if group is not None:  # one all-reduce of the packed (36 + 6 + 1) sums
        flat = torch.cat([h.reshape(-1), g, loss.reshape(1)])
        dist.all_reduce(flat, group=group)
        h, g, loss = flat[:36].reshape(6, 6), flat[36:42], flat[42]
    return h, g, loss


def gauss_newton_step(res: torch.Tensor, jac: torch.Tensor,
                      weights: torch.Tensor,
                      det_threshold: float = 1.0e-7,
                      damping: float = 0.0,
                      prior_res: Optional[torch.Tensor] = None,
                      prior_weight: Optional[torch.Tensor] = None,
                      group=None):
    """One weighted GN step from residuals (N,), Jacobian (N, 6), weights
    (N,).  With a process `group`, the rows are this rank's slice and the
    partial normal equations are all-reduced first (``normal_equations``).
    The optional pose priors (``add_pose_prior``) join next, as global
    terms; then `damping` > 0 adds the Levenberg term
    ``damping * trace(H) / 6 * I``.  Returns (dx (6,), loss, singular)."""
    h, g, loss = normal_equations(res, jac, weights, group)
    h, g = add_pose_prior(h, g, prior_res, prior_weight)
    if damping > 0.0:
        h = h + (damping * torch.trace(h) / 6.0) * torch.eye(
            6, dtype=h.dtype, device=h.device)
    dx, singular = solve_normal_equations(h, g, det_threshold)
    return dx, loss, singular


def gauss_newton(x0: torch.Tensor, res_fun, jac_fun, max_iters: int = 10,
                 norm_stop_criterion: float = 1.0e-3,
                 scheme: str = "least_square", sigma: float = 0.5,
                 sq_dists: Optional[torch.Tensor] = None,
                 eps: float = 1.0e-4) -> GNResult:
    """Gauss-Newton on a 6-parameter pose: `res_fun(x) -> (N,)`,
    `jac_fun(x) -> (N, 6)`, weights from the residuals of each step.

    At least one step; then up to `max_iters` in all, stopping once
    ||dx|| < `norm_stop_criterion` or the system is singular.  A step whose
    residual norm is below 1e-7 leaves x unchanged.  The JAX early-exit loop
    becomes fixed trips whose carries freeze once the stop condition holds,
    so nothing waits on the host.
    """
    def body(x):
        jac = jac_fun(x)
        res = res_fun(x)
        weights = robust_weights(scheme, res, sigma, sq_dists, eps)
        dx, loss, singular = gauss_newton_step(res, jac, weights)
        degenerate = torch.linalg.vector_norm(res) < 1.0e-7
        dx = torch.where(degenerate, torch.zeros_like(dx), dx)
        return x + dx, loss, torch.linalg.vector_norm(dx), singular

    x, loss, dn, singular = body(x0)
    for _ in range(1, max(int(max_iters), 1)):
        active = (dn >= norm_stop_criterion) & (~singular)
        nx, nloss, ndn, nsing = body(x)
        x = torch.where(active, nx, x)
        loss = torch.where(active, nloss, loss)
        dn = torch.where(active, ndn, dn)
        singular = torch.where(active, nsing, singular)
    return GNResult(x, loss, dn, singular)
