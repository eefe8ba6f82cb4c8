"""Local-map configs (torch port of the part of
``pylidar_slam_tpu.slam.odometry.local_map`` the ported maps need).

The projective ring-buffer map is ROADMAP.md A.12.
"""
from __future__ import annotations

from dataclasses import dataclass

from pylidar_slam_tpu_torch.config import MISSING


@dataclass
class LocalMapConfig:
    pose: str = "euler"
    type: str = MISSING
