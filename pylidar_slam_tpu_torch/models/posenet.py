"""PoseResNet: regresses 6-DoF relative pose(s) from stacked vertex maps
(torch port of ``pylidar_slam_tpu.models.posenet``).

A ResNet encoder over a stacked pair of vertex maps, a global average pool
and separate rotation / translation heads: rotation scaled by 0.1, the
heads drawn small (``variance_scaling(1e-4, fan_avg, uniform)``, i.e.
xavier-uniform with gain 0.01), ``fc_rot`` without a bias.

Input: ``(B, seq, C, H, W)``, flattened to NCHW ``(B, seq*C, H, W)`` with
the channels in the same order as the JAX package's stacked NHWC input.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn as nn

from pylidar_slam_tpu_torch.models import POSENET
from pylidar_slam_tpu_torch.models.resnet import ResNetEncoder, lecun_normal_


@dataclass
class PoseResNetConfig:
    type: str = "poseresnet"
    num_input_channels: int = 3
    sequence_len: int = 2
    num_out_poses: int = 1
    resnet_model: int = 18
    activation: str = "relu"
    regression_activation: str = "relu"


class PoseResNet(nn.Module):
    def __init__(self, config: Any, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        in_ch = config.sequence_len * config.num_input_channels
        self.encoder = ResNetEncoder(in_ch, model=config.resnet_model,
                                     activation=config.activation)
        feat = self.encoder.out_channels
        self.fc_rot = nn.Linear(feat, 3 * config.num_out_poses, bias=False)
        self.fc_trans = nn.Linear(feat, 3 * config.num_out_poses)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax modules' initial distributions, drawn from `generator`."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                lecun_normal_(module.weight, generator)
        with torch.no_grad():
            for fc in (self.fc_rot, self.fc_trans):
                fan_avg = 0.5 * (fc.in_features + fc.out_features)
                limit = math.sqrt(3.0 * 0.01 ** 2 / fan_avg)
                fc.weight.uniform_(-limit, limit, generator=generator)
            self.fc_trans.bias.zero_()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, seq, C, H, W) stacked vertex maps -> (B, num_out_poses, 6)."""
        cfg = self.config
        b, seq, c, h, w = frames.shape
        assert seq == cfg.sequence_len and c == cfg.num_input_channels, (
            f"Expected (B, {cfg.sequence_len}, {cfg.num_input_channels}, H, W), "
            f"got {tuple(frames.shape)}")
        features = self.encoder(frames.reshape(b, seq * c, h, w))
        pooled = features.mean(dim=(2, 3))
        rot = 0.1 * self.fc_rot(pooled)  # rotation scaling for stable training
        trans = self.fc_trans(pooled)
        return torch.cat([trans.reshape(b, cfg.num_out_poses, 3),
                          rot.reshape(b, cfg.num_out_poses, 3)], dim=-1)


POSENET.register("poseresnet", PoseResNet, PoseResNetConfig)
