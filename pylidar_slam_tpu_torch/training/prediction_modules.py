"""Prediction module: wraps PoseNet for training and inference (torch port
of ``pylidar_slam_tpu.training.prediction_modules``).

Consumes stacked vertex maps ``(B, 2, 3, H, W)`` and emits ``pose_params``
(B, 6) and ``pose_matrix`` (B, 4, 4); ``relative_ground_truth`` turns an
absolute ground-truth pair into the relative ``inv(gt0) @ gt1``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.models import POSENET
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import se3


@dataclass
class PredictionConfig:
    type: str = "poseresnet"
    posenet_config: Dict[str, Any] = field(default_factory=dict)


class PoseNetPredictionModule:
    """Holds the network (``module``), its weights and its BatchNorm
    statistics."""

    def __init__(self, config: PredictionConfig, seed: int = 0,
                 device: Optional[torch.device] = None):
        if not isinstance(config, PredictionConfig):
            config = dataclass_from_dict(PredictionConfig, config)
        self.config = config
        self.net_config = dataclass_from_dict(PoseResNetConfig,
                                              dict(config.posenet_config or {}))
        cls, _ = POSENET.get(config.type)
        # drawn on the CPU from the seed, so every device starts alike
        generator = torch.Generator().manual_seed(int(seed))
        self.module: PoseResNet = cls(self.net_config, generator=generator)
        if device is not None:
            self.module.to(device)

    def apply(self, vertex_maps: torch.Tensor, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pose_params (B, 6), pose_matrix (B, 4, 4)); a train-mode pass
        moves the BatchNorm running statistics."""
        self.module.train(train)
        pose_params = self.module(vertex_maps)[:, 0, :]  # num_out_poses = 1
        return pose_params, se3.build_pose_matrix(pose_params)


def relative_ground_truth(absolute_gt: torch.Tensor) -> torch.Tensor:
    """(B, 2, 4, 4) absolute GT pair -> (B, 4, 4) relative inv(gt0) @ gt1."""
    return se3.inverse_pose_matrix(absolute_gt[:, 0]) @ absolute_gt[:, 1]
