"""Cloud-to-cloud ICP with exact nearest neighbours (torch port of
``pylidar_slam_tpu.ops.icp3d``): the loop closure's refine.

``brute_force_nn`` is kernel B2 on CUDA tensors and its plain version on
CPU tensors.  ``icp_align`` runs the JAX function's early-exit loop as
``max_iters`` fixed trips with frozen carries: the convergence test stays on
the device and drives B2's ``active`` flag, so a converged trip does no NN
work and nothing waits for the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pylidar_slam_tpu_torch.ops import optimization, registration, se3
from pylidar_slam_tpu_torch.ops.kernels.nn_argmin import nn_argmin


def brute_force_nn(queries: torch.Tensor, refs: torch.Tensor,
                   ref_mask: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (M, 3) queries vs (V, 3) refs -> (idx (M,) int32,
    sq_dist (M,)); lowest index on ties, index 0 / +inf when no ref is
    valid.  Kernel B2 on CUDA tensors, where a False device flag `active`
    skips the pass (index 0, +inf); its plain version (``nn_argmin_plain``,
    the JAX function's chunked composite) on CPU tensors, where a False
    `active` gives the kernel's skipped result without computing."""
    if active is not None and queries.device.type == "cpu" and not bool(active):
        m = queries.shape[0]
        return (torch.zeros((m,), dtype=torch.int32),
                torch.full((m,), math.inf, dtype=queries.dtype))
    return nn_argmin(queries, refs, ref_mask, active=active)


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (..., 4, 4) maps source -> target frame
    num_iters: torch.Tensor  # (...,) int32 trips that ran
    mean_residual: torch.Tensor  # (...,)


def icp_align(source: torch.Tensor, target: torch.Tensor,
              init_transform: Optional[torch.Tensor] = None,
              source_mask: Optional[torch.Tensor] = None,
              target_mask: Optional[torch.Tensor] = None,
              max_iters: int = 20,
              max_corr_dist: float = 1.0,
              scheme: str = "geman_mcclure",
              sigma: float = 0.5,
              threshold_delta: float = 1.0e-5,
              active: Optional[torch.Tensor] = None) -> ICPResult:
    """Point-to-point ICP aligning `source` (N, 3) onto `target` (padded).

    Each trip: transform, exact NN, the correspondence gate, robust
    weights, the closed-form weighted Procrustes fit, the pose composed and
    re-normalized, and the delta's norm; a pose whose delta fell under
    `threshold_delta` (or whose `active` flag is False) stays frozen.

    `target` may carry a leading candidate axis, (C, V, 3) with masks (C, V),
    inits (C, 4, 4) and `active` (C,): each candidate is aligned as the JAX
    function aligns one pair, the per-point work batched over candidates
    and one B2 pass per candidate and trip.
    """
    batched = target.dim() == 3
    if not batched:
        target = target[None]
        target_mask = None if target_mask is None else target_mask[None]
        init_transform = None if init_transform is None else init_transform[None]
        active = None if active is None else active.reshape(1)
    c, n, dev, dtype = target.shape[0], source.shape[0], source.device, source.dtype
    t = (torch.eye(4, dtype=dtype, device=dev).expand(c, 4, 4) if init_transform is None
         else init_transform.to(dtype))
    if source_mask is None:
        source_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if active is None:
        active = torch.ones((c,), dtype=torch.bool, device=dev)
    dnorm = torch.full((c,), math.inf, dtype=dtype, device=dev)
    it = torch.zeros((c,), dtype=torch.int32, device=dev)
    mean_res = torch.zeros((c,), dtype=dtype, device=dev)
    for _ in range(max_iters):
        run = active & (dnorm >= threshold_delta)
        moved = se3.apply_transformation(source[None], t)  # (C, N, 3)
        nn = [brute_force_nn(moved[k], target[k],
                             None if target_mask is None else target_mask[k],
                             active=run[k])
              for k in range(c)]
        idx = torch.stack([i for i, _ in nn]).long()
        sq_d = torch.stack([d for _, d in nn])
        matched = torch.gather(target, 1, idx[..., None].expand(c, n, 3))
        ok = source_mask[None] & (sq_d < max_corr_dist ** 2)
        res = torch.sqrt(torch.clamp(sq_d, min=1e-12))
        w = optimization.robust_weights(scheme, res, sigma) ** 2
        w = torch.where(ok, w, torch.zeros_like(w))
        delta = registration.weighted_procrustes(matched, moved, w)
        new_t = se3.normalize_pose_matrix(delta @ t)
        new_dnorm = torch.linalg.vector_norm(se3.from_pose_matrix(delta), dim=-1)
        okf = ok.to(dtype)
        new_res = torch.sum(res * okf, dim=1) / torch.clamp(torch.sum(okf, dim=1), min=1)
        t = torch.where(run[:, None, None], new_t, t)
        dnorm = torch.where(run, new_dnorm, dnorm)
        mean_res = torch.where(run, new_res, mean_res)
        it = it + run.to(torch.int32)
    if not batched:
        t, it, mean_res = t[0], it[0], mean_res[0]
    return ICPResult(transform=t, num_iters=it, mean_residual=mean_res)
