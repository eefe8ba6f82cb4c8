"""SE(3) pose-graph optimization (torch port of
``pylidar_slam_tpu.ops.pose_graph``).

* ``optimize_pose_graph_host``: float64 sparse Gauss-Newton on the host,
  numpy + scipy's sparse LU -- the solver the online backend uses;
* ``optimize_pose_graph``: the device solver, Gauss-Newton with the normal
  equations solved matrix-free by block-Jacobi preconditioned conjugate
  gradients.  Per-edge residuals r_e = [t, log_rot] of (Z^-1 X_i^-1 X_j)
  and their Jacobians at the zero perturbation (right-multiplicative,
  X <- X Exp(dx)) come from ``torch.func.jacfwd`` under ``vmap``; H v
  products are one batched pass over the edges plus index adds.  The fixed
  ``num_iters`` and ``cg_iters`` loops never wait for the host.  Given a
  process group, each rank holds a slice of the edges (poses and priors
  replicated), and the edge terms of the gradient, of the preconditioner
  blocks and of every H v product are summed over the group.

Absolute (GPS-style) constraints are unary priors with their own
information.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


def log_rotation(rot: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: (..., 3, 3) -> (..., 3) axis-angle.

    Near the identity arccos' is infinite, so that branch uses a Taylor
    expansion of theta/(2 sin theta) in (1 - cos theta), with both branches
    kept finite (the log sits inside jacfwd at near-identity edge errors).
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    near = cos_theta > 1.0 - 1e-4
    c_safe = torch.where(near, torch.full_like(cos_theta, 1.0 - 1e-4), cos_theta)
    theta = torch.arccos(c_safe)
    sin_theta = torch.sqrt(torch.clamp(1.0 - c_safe * c_safe, min=1e-12))
    scale_exact = theta / (2.0 * sin_theta)
    # theta^2 ~ 2 (1 - c); theta/(2 sin) ~ 0.5 + theta^2/12 + 7 theta^4/720
    t2 = 2.0 * (1.0 - cos_theta)
    scale_taylor = 0.5 + t2 / 12.0 + 7.0 * t2 * t2 / 720.0
    scale = torch.where(near, scale_taylor, scale_exact)
    w = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                     rot[..., 0, 2] - rot[..., 2, 0],
                     rot[..., 1, 0] - rot[..., 0, 1]], dim=-1)
    return w * scale[..., None]


def _skew(axis: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(axis[..., 0])
    return torch.stack([
        torch.stack([zeros, -axis[..., 2], axis[..., 1]], dim=-1),
        torch.stack([axis[..., 2], zeros, -axis[..., 0]], dim=-1),
        torch.stack([-axis[..., 1], axis[..., 0], zeros], dim=-1),
    ], dim=-2)


def exp_rotation(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exp map: (..., 3) axis-angle -> (..., 3, 3) (Rodrigues)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = theta[..., 0] < 1e-8
    safe = torch.where(small[..., None], torch.ones_like(theta), theta)
    axis = w / safe
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    k = _skew(axis)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    rot = eye + s * k + (1.0 - c) * (k @ k)
    return torch.where(small[..., None, None], eye + k, rot)


def exp_se3(dx: torch.Tensor) -> torch.Tensor:
    """Small (..., 6) perturbation [t, w] -> (..., 4, 4) transform
    (first-order coupling: t applied directly, adequate for GN updates)."""
    return _pose(exp_rotation(dx[..., 3:]), dx[..., :3])


def _pose(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from rotations and translations, without in-place writes
    (the residuals run under ``jacfwd`` and ``vmap``)."""
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _inverse_pose(mat: torch.Tensor) -> torch.Tensor:
    rt = mat[..., :3, :3].transpose(-1, -2)
    return _pose(rt, -(rt @ mat[..., :3, 3:4])[..., 0])


def _residual(err: torch.Tensor) -> torch.Tensor:
    return torch.cat([err[..., :3, 3], log_rotation(err[..., :3, :3])], dim=-1)


def _edge_residual(xi, xj, z_inv, dxi, dxj) -> torch.Tensor:
    """Residual of one edge at perturbations (dxi, dxj): (6,)."""
    err = z_inv @ _inverse_pose(xi @ exp_se3(dxi)) @ (xj @ exp_se3(dxj))
    return _residual(err)


class PoseGraph(NamedTuple):
    """Static-shape edge arrays (pad with zero-information edges)."""
    edge_i: torch.Tensor  # (E,) int64 source pose index
    edge_j: torch.Tensor  # (E,) int64 target pose index
    measurements: torch.Tensor  # (E, 4, 4) Z_ij (j expressed in i)
    information: torch.Tensor  # (E, 6, 6)
    prior_idx: torch.Tensor  # (P,) int64 pose index of unary priors
    prior_measurements: torch.Tensor  # (P, 4, 4)
    prior_information: torch.Tensor  # (P, 6, 6)


def optimize_pose_graph(poses: torch.Tensor, graph: PoseGraph,
                        num_iters: int = 20, cg_iters: int = 50,
                        damping: float = 1.0e-6,
                        fix_first: bool = True,
                        group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Optimizes (M, 4, 4) absolute poses against the graph's constraints
    on their device, in their dtype.

    With `group`, `graph`'s edges are this rank's slice of the edge set and
    its priors are the whole set: the edge terms of g, of the block-Jacobi
    blocks and of each H v are all-reduced over `group` (one all-reduce
    each, as GSPMD's scatter-add collectives over an edge-sharded graph),
    and the prior terms are added after it, once.  Every rank returns the
    same poses."""
    from torch.func import jacfwd, vmap

    m = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    pi = graph.prior_idx.long()
    z_inv = _inverse_pose(graph.measurements.to(dtype))
    pz_inv = _inverse_pose(graph.prior_measurements.to(dtype))
    info = graph.information.to(dtype)
    pinfo = graph.prior_information.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    zero6 = torch.zeros(6, dtype=dtype, device=dev)

    # (jacfwd may hand back its Jacobians in float64; the solve runs in
    # the poses' dtype)
    def edge_res_jac(xi, xj, zi):
        res = _edge_residual(xi, xj, zi, zero6, zero6)
        ji = jacfwd(lambda d: _edge_residual(xi, xj, zi, d, zero6))(zero6)
        jj = jacfwd(lambda d: _edge_residual(xi, xj, zi, zero6, d))(zero6)
        return res, ji.to(dtype), jj.to(dtype)

    def prior_res_jac(xi, zi):
        def res_fn(d):
            return _residual(zi @ (xi @ exp_se3(d)))
        return res_fn(zero6), jacfwd(res_fn)(zero6).to(dtype)

    def scatter(idx, values):
        out = torch.zeros((m, *values.shape[1:]), dtype=dtype, device=dev)
        return out.index_add_(0, idx, values)

    def edge_sum(v):
        if group is not None:
            dist.all_reduce(v, group=group)
        return v

    def mask_fixed(v):
        if not fix_first:
            return v
        keep = torch.ones((m, 1), dtype=dtype, device=dev)
        keep[0] = 0.0
        return v * keep

    for _ in range(num_iters):
        res, ji, jj = vmap(edge_res_jac)(poses[ei], poses[ej], z_inv)
        pres, pjac = vmap(prior_res_jac)(poses[pi], pz_inv)

        # gradient g = J^T I r scattered to poses
        g = (edge_sum(scatter(ei, torch.einsum("epd,epq,eq->ed", ji, info, res))
                      + scatter(ej, torch.einsum("epd,epq,eq->ed", jj, info, res)))
             + scatter(pi, torch.einsum("epd,epq,eq->ed", pjac, pinfo, pres)))
        # block-Jacobi preconditioner: per-pose 6x6 diagonal blocks
        diag = (edge_sum(scatter(ei, torch.einsum("epa,epq,eqb->eab", ji, info, ji))
                         + scatter(ej, torch.einsum("epa,epq,eqb->eab", jj, info, jj)))
                + scatter(pi, torch.einsum("epa,epq,eqb->eab", pjac, pinfo, pjac)))
        diag = diag + damping * eye6
        diag_inv = torch.linalg.inv_ex(diag + 1e-8 * eye6).inverse

        def hv(v):
            jv = (torch.einsum("eab,eb->ea", ji, v[ei])
                  + torch.einsum("eab,eb->ea", jj, v[ej]))
            ijv = torch.einsum("eab,eb->ea", info, jv)
            ipv = torch.einsum("eab,eb->ea", pinfo,
                               torch.einsum("eab,eb->ea", pjac, v[pi]))
            out = (edge_sum(scatter(ei, torch.einsum("eba,eb->ea", ji, ijv))
                            + scatter(ej, torch.einsum("eba,eb->ea", jj, ijv)))
                   + scatter(pi, torch.einsum("eba,eb->ea", pjac, ipv)))
            return mask_fixed(out + damping * v)

        def precond(v):
            return mask_fixed(torch.einsum("mab,mb->ma", diag_inv, v))

        r = mask_fixed(-g)
        z = precond(r)
        x, p = torch.zeros_like(r), z
        for _ in range(cg_iters):
            hp = hv(p)
            rz = torch.sum(r * z)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-12)
            x = x + alpha * p
            r = r - alpha * hp
            z = precond(r)
            beta = torch.sum(r * z) / torch.clamp(rz, min=1e-12)
            p = z + beta * p
        poses = poses @ exp_se3(mask_fixed(x))
    return poses


# ----------------------------------------------------------------------------
# Host-side float64 solver
# ----------------------------------------------------------------------------

def _np_exp_rotation(w):
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-10
    safe = np.where(small[..., None], 1.0, theta)
    axis = w / safe
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    zeros = np.zeros_like(axis[..., 0])
    k = np.stack([
        np.stack([zeros, -axis[..., 2], axis[..., 1]], axis=-1),
        np.stack([axis[..., 2], zeros, -axis[..., 0]], axis=-1),
        np.stack([-axis[..., 1], axis[..., 0], zeros], axis=-1),
    ], axis=-2)
    eye = np.broadcast_to(np.eye(3), k.shape)
    rot = eye + s * k + (1.0 - c) * (k @ k)
    return np.where(small[..., None, None], eye + k, rot)


def _np_exp_se3(dx):
    mat = np.zeros((*dx.shape[:-1], 4, 4))
    mat[..., :3, :3] = _np_exp_rotation(dx[..., 3:])
    mat[..., :3, 3] = dx[..., :3]
    mat[..., 3, 3] = 1.0
    return mat


def _np_log_rotation(rot):
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = np.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = np.arccos(cos_theta)
    sin_theta = np.sqrt(np.maximum(1.0 - cos_theta * cos_theta, 0.0))
    near = cos_theta > 1.0 - 1e-8
    scale = np.where(near, 0.5 + (1.0 - cos_theta) / 6.0,
                     theta / np.maximum(2.0 * sin_theta, 1e-300))
    w = np.stack([rot[..., 2, 1] - rot[..., 1, 2],
                  rot[..., 0, 2] - rot[..., 2, 0],
                  rot[..., 1, 0] - rot[..., 0, 1]], axis=-1)
    return w * scale[..., None]


def _np_inv_pose(mats):
    rt = np.swapaxes(mats[..., :3, :3], -1, -2)
    out = np.zeros_like(mats)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", rt, mats[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def optimize_pose_graph_host(poses, edge_i, edge_j, measurements, information,
                             prior_idx=None, prior_measurements=None,
                             prior_information=None,
                             num_iters: int = 30, damping: float = 1.0e-6,
                             fix_first: bool = True,
                             tol: float = 1.0e-10):
    """Float64 sparse Gauss-Newton over (M, 4, 4) absolute poses (host).

    The residual of ``optimize_pose_graph`` (err = Z^-1 Xi^-1 Xj, res =
    [t, log R], right-multiplicative perturbation); Jacobians by vectorized
    central differences (f64: ~1e-9 accurate, and a Jacobian error cannot
    bias the fixed point of GN); normal equations solved exactly by scipy's
    sparse LU.
    """
    from scipy.sparse import csc_matrix
    from scipy.sparse.linalg import splu

    poses = np.asarray(poses, np.float64).copy()
    edge_i = np.asarray(edge_i, np.int64)
    edge_j = np.asarray(edge_j, np.int64)
    z_inv = _np_inv_pose(np.asarray(measurements, np.float64))
    info = np.asarray(information, np.float64)
    m = poses.shape[0]
    e = edge_i.shape[0]
    has_priors = prior_idx is not None and len(np.atleast_1d(prior_idx)) > 0
    if has_priors:
        prior_idx = np.asarray(prior_idx, np.int64)
        pz = np.asarray(prior_measurements, np.float64)
        pinfo = np.asarray(prior_information, np.float64)

    def edge_res(xi, xj):
        err = np.einsum("eij,ejk,ekl->eil", z_inv, _np_inv_pose(xi), xj)
        return np.concatenate(
            [err[:, :3, 3], _np_log_rotation(err[:, :3, :3])], axis=-1)

    def prior_res(xp):
        err = np.einsum("eij,ejk->eik", pz, xp)
        return np.concatenate(
            [err[:, :3, 3], _np_log_rotation(err[:, :3, :3])], axis=-1)

    eps = 1.0e-6
    eye6 = np.eye(6)

    for _ in range(num_iters):
        xi = poses[edge_i]
        xj = poses[edge_j]
        res = edge_res(xi, xj)

        # central-difference Jacobians, vectorized over all edges per axis
        ji = np.empty((e, 6, 6))
        jj = np.empty((e, 6, 6))
        for k in range(6):
            d = _np_exp_se3(eps * eye6[k])
            dm = _np_exp_se3(-eps * eye6[k])
            ji[:, :, k] = (edge_res(xi @ d, xj) - edge_res(xi @ dm, xj)) / (2 * eps)
            jj[:, :, k] = (edge_res(xi, xj @ d) - edge_res(xi, xj @ dm)) / (2 * eps)

        # g = J^T I r; H blocks = J^T I J, assembled as sparse COO
        i_r = np.einsum("epq,eq->ep", info, res)
        g = np.zeros((m, 6))
        np.add.at(g, edge_i, np.einsum("epa,ep->ea", ji, i_r))
        np.add.at(g, edge_j, np.einsum("epa,ep->ea", jj, i_r))

        i_ji = np.einsum("epq,eqa->epa", info, ji)
        i_jj = np.einsum("epq,eqa->epa", info, jj)
        hii = np.einsum("epa,epb->eab", ji, i_ji)
        hij = np.einsum("epa,epb->eab", ji, i_jj)
        hji = np.swapaxes(hij, -1, -2)
        hjj = np.einsum("epa,epb->eab", jj, i_jj)

        blocks = [hii, hij, hji, hjj]
        rows_ = [edge_i, edge_i, edge_j, edge_j]
        cols_ = [edge_i, edge_j, edge_i, edge_j]

        if has_priors:
            xp = poses[prior_idx]
            pres = prior_res(xp)
            pjac = np.empty((len(prior_idx), 6, 6))
            for k in range(6):
                d = _np_exp_se3(eps * eye6[k])
                dm = _np_exp_se3(-eps * eye6[k])
                pjac[:, :, k] = (prior_res(xp @ d) - prior_res(xp @ dm)) / (2 * eps)
            ip_r = np.einsum("epq,eq->ep", pinfo, pres)
            np.add.at(g, prior_idx, np.einsum("epa,ep->ea", pjac, ip_r))
            i_pj = np.einsum("epq,eqa->epa", pinfo, pjac)
            blocks.append(np.einsum("epa,epb->eab", pjac, i_pj))
            rows_.append(prior_idx)
            cols_.append(prior_idx)

        # 6Mx6M sparse normal equations from the 6x6 blocks
        off = np.arange(6)
        data, rr, cc = [], [], []
        for blk, bi, bj in zip(blocks, rows_, cols_):
            n_b = blk.shape[0]
            r_idx = (bi[:, None, None] * 6 + off[None, :, None])
            c_idx = (bj[:, None, None] * 6 + off[None, None, :])
            data.append(blk.reshape(n_b, -1).ravel())
            rr.append(np.broadcast_to(r_idx, (n_b, 6, 6)).ravel())
            cc.append(np.broadcast_to(c_idx, (n_b, 6, 6)).ravel())
        data = np.concatenate(data)
        rr = np.concatenate(rr)
        cc = np.concatenate(cc)

        b = -g.reshape(-1)
        if fix_first:
            # gauge fix: drop pose-0 rows/cols, pin its block to identity
            keep = (rr >= 6) & (cc >= 6)
            data, rr, cc = data[keep], rr[keep], cc[keep]
            data = np.concatenate([data, np.ones(6)])
            rr = np.concatenate([rr, off])
            cc = np.concatenate([cc, off])
            b[:6] = 0.0
        data = np.concatenate([data, np.full(6 * m, damping)])
        diag_all = np.arange(6 * m)
        rr = np.concatenate([rr, diag_all])
        cc = np.concatenate([cc, diag_all])

        h_mat = csc_matrix((data, (rr, cc)), shape=(6 * m, 6 * m))
        try:
            dx = splu(h_mat).solve(b).reshape(m, 6)
        except RuntimeError:  # singular factorization
            break
        if fix_first:
            dx[0] = 0.0
        poses = poses @ _np_exp_se3(dx)
        if float(np.linalg.norm(dx)) < tol:
            break

    # re-orthonormalize rotations accumulated over many compositions
    u, _, vt = np.linalg.svd(poses[:, :3, :3])
    det = np.linalg.det(u @ vt)
    d = np.stack([np.ones_like(det), np.ones_like(det), det], axis=-1)
    poses[:, :3, :3] = u @ (d[:, :, None] * vt)
    return poses
