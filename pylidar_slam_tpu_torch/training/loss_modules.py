"""Training losses for PoseNet (torch port of
``pylidar_slam_tpu.training.loss_modules``).

* **Unsupervised point-to-plane**: the normal map of the reference vertex
  map, the target map moved by the predicted pose and rasterized again (the
  gradient flows through the gathered point values, straight-through on the
  raster's indices), masked robust point-to-plane residuals, the mean of the
  squared costs over the valid pixels.
* **Supervised**: L1/L2 on translation and rotation (in degrees by
  default), with fixed weights or learned exponential uncertainty weights
  ``sum_i l_i e^{-s_i} + s_i``.

Both return ``(loss, logs)``, with every value a device tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from pylidar_slam_tpu_torch.config import MISSING
from pylidar_slam_tpu_torch.ops import geometry, optimization, projection, se3


@dataclass
class LossConfig:
    mode: str = MISSING


@dataclass
class PointToPlaneLossConfig(LossConfig):
    mode: str = "unsupervised"
    least_square_scheme: Dict[str, Any] = field(
        default_factory=lambda: dict(scheme="geman_mcclure", sigma=0.5))


@dataclass
class SupervisedLossConfig(LossConfig):
    mode: str = "supervised"
    loss_degrees: bool = True
    loss_weights: List[float] = field(default_factory=lambda: [1.0, 1.0])
    with_exp_weights: bool = False
    init_weights: List[float] = field(default_factory=lambda: [-3.0, -3.0])
    loss_option: str = "l2"


def _not_null(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=-1) > 0


def point_to_plane_loss(vertex_maps: torch.Tensor, pose_params: torch.Tensor,
                        proj: projection.SphericalProjection,
                        scheme: str = "geman_mcclure", sigma: float = 0.5,
                        normals_kernel_size: int = 5):
    """Unsupervised loss. vertex_maps: (B, 2, 3, H, W) [ref, target];
    pose_params: (B, 6) predicted target->ref pose.  Returns (loss, logs)."""
    b, s = vertex_maps.shape[:2]
    assert s == 2
    ref_vm = vertex_maps[:, 0].permute(0, 2, 3, 1)  # (B, H, W, 3)
    tgt_vm = vertex_maps[:, 1].permute(0, 2, 3, 1)
    ref_nm = geometry.compute_normal_map(ref_vm, normals_kernel_size)

    pts = tgt_vm.reshape(b, -1, 3)
    mask = _not_null(pts)
    transformed = se3.apply_transformation(pts, se3.build_pose_matrix(pose_params))
    transformed = torch.where(mask[..., None], transformed, torch.zeros_like(transformed))
    vm_trans = projection.build_vertex_map(transformed, proj, mask=mask)

    pc_t = vm_trans.reshape(b, -1, 3)
    pc_r = ref_vm.reshape(b, -1, 3)
    n_r = ref_nm.reshape(b, -1, 3)
    m = _not_null(pc_t) & _not_null(pc_r) & _not_null(n_r)
    diff = pc_r - pc_t
    residuals = torch.where(m, torch.abs(torch.sum(diff * n_r, dim=-1)),
                            torch.zeros_like(m, dtype=diff.dtype))
    sq_dists = torch.sum(diff * diff, dim=-1)
    cost = optimization.robust_cost(scheme, residuals, sigma, sq_dists)
    losses = torch.sum(cost * cost, dim=-1) / torch.clamp(m.sum(dim=-1), min=1)
    loss = losses.mean()
    return loss, {"loss_icp": loss}


def supervised_loss(pose_params: torch.Tensor, ground_truth: torch.Tensor,
                    config: SupervisedLossConfig, exp_s: Optional[torch.Tensor] = None):
    """Supervised pose loss. pose_params (B, 6); ground_truth (B, 4, 4)
    relative GT; exp_s: optional (2,) learned log-variance weights."""
    gt_params = se3.from_pose_matrix(ground_truth.to(pose_params.dtype))

    def l1(x, y):
        return torch.abs(x - y).sum(dim=1).mean()

    def crit(x, y):
        if config.loss_option == "l1":
            return l1(x, y)
        return ((x - y) ** 2).sum(dim=1).mean()

    pred_rot, gt_rot = pose_params[:, 3:], gt_params[:, 3:]
    if config.loss_degrees:
        scale = 180.0 / math.pi
        pred_rot, gt_rot = pred_rot * scale, gt_rot * scale
    loss_rot = crit(pred_rot, gt_rot)
    rot_l1 = l1(pred_rot, gt_rot)
    loss_trans = crit(pose_params[:, :3], gt_params[:, :3])
    trans_l1 = l1(pose_params[:, :3], gt_params[:, :3])

    logs = {"loss_rot": loss_rot, "loss_trans": loss_trans,
            "loss_rot_l1": rot_l1, "loss_trans_l1": trans_l1}
    if config.with_exp_weights:
        assert exp_s is not None, "with_exp_weights requires the s parameters"
        loss = (loss_trans * torch.exp(-exp_s[0]) + exp_s[0]
                + loss_rot * torch.exp(-exp_s[1]) + exp_s[1])
        logs["s_trans"] = exp_s[0]
        logs["s_rot"] = exp_s[1]
    else:
        w = config.loss_weights
        loss = loss_trans * w[0] + loss_rot * w[1]
    logs["loss"] = loss
    return loss, logs
