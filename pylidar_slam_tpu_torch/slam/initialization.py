"""Motion-prior (initialization) modules (port of
``pylidar_slam_tpu.slam.initialization``).

Each module writes a (4, 4) relative-pose prior under the ``init_rpose`` key
each frame.  Variants:

* **NI** -- identity prior.
* **CV** -- constant velocity: replays the last estimated relative pose, the
  odometry's device tensor, straight back into the next step (no host
  round trip).
* **EI** -- elevation-image 2D prior by BEV phase correlation
  (``ops/bev.py``).
* **PoseNet** -- a trained checkpoint regresses the prior from the previous
  and current scans (``slam/odometry/posenet_odometry.py``); the prior stays
  on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, Registry


def frame_points(data_dict: dict) -> np.ndarray:
    """The frame's host (N, 3+) cloud: ``numpy_pc``, or the pixels of a
    (H, W, 3) / (3, H, W) ``vertex_map``, numpy or tensor."""
    key = "numpy_pc" if "numpy_pc" in data_dict else "vertex_map"
    data = data_dict[key]
    data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    if data.ndim == 3:
        if data.shape[0] == 3:
            data = data.transpose(1, 2, 0)
        data = data.reshape(-1, 3)
    return data


@dataclass
class InitializationConfig:
    type: str = MISSING


class Initialization:
    """Base class: writes the motion prior under `init_rpose`."""

    def __init__(self, config: InitializationConfig, **kwargs):
        self.config = config

    @staticmethod
    def initial_pose_key() -> str:
        return "init_rpose"

    def init(self):
        pass

    def next_frame(self, data_dict: dict, **kwargs):
        data_dict[self.initial_pose_key()] = self.next_initial_pose(
            data_dict=data_dict, **kwargs)

    def next_initial_pose(self, data_dict: Optional[dict] = None, **kwargs):
        return None

    def save_real_motion(self, relative_pose, data_dict: dict):
        """Feeds back the estimated motion of the registered frame."""


@dataclass
class NIConfig(InitializationConfig):
    type: str = "ni"


class NoInitialization(Initialization):
    """Identity motion prior."""


@dataclass
class CVConfig(InitializationConfig):
    type: str = "cv"


class ConstantVelocityInitialization(Initialization):
    """Constant-velocity prior: replays the last estimated relative pose,
    a device tensor when the odometry gave one."""

    def __init__(self, config: CVConfig, **kwargs):
        super().__init__(config)
        self.initial_estimate = None

    def init(self):
        self.initial_estimate = np.eye(4)

    def next_initial_pose(self, data_dict: Optional[dict] = None, **kwargs):
        return self.initial_estimate

    def save_real_motion(self, relative_pose, data_dict: dict):
        self.initial_estimate = relative_pose


@dataclass
class EIConfig(InitializationConfig):
    """Elevation-image 2D motion prior (dense BEV phase correlation)."""
    type: str = "ei"
    debug: bool = False
    ni_if_failure: bool = False  # fall back to identity when matching fails
    pixel_size: float = 0.3
    im_size: int = 256
    z_min: float = -3.0
    z_max: float = 5.0
    num_yaw_steps: int = 45
    yaw_range: float = 0.35  # radians; inter-frame rotations are small
    min_score: float = 0.05
    # Keep only points this far above the scan's median height (0 disables):
    # single-scan BEV phase correlation locks onto the egocentric ground
    # sampling pattern at zero shift; structures above ground are
    # world-fixed.
    ground_margin: float = 0.5


class ElevationImageInitialization(Initialization):
    """2D (x, y, yaw) prior from registering consecutive BEV images."""

    def __init__(self, config: EIConfig, device="cuda", **kwargs):
        super().__init__(config)
        self.device = torch.device(device)
        self._prev_image = None
        self._last_motion = np.eye(4)

    def init(self):
        self._prev_image = None
        self._last_motion = np.eye(4)

    def _image(self, points: np.ndarray) -> torch.Tensor:
        from pylidar_slam_tpu_torch.ops import bev
        cfg = self.config
        pts = torch.as_tensor(np.ascontiguousarray(points[:, :3], np.float32),
                              device=self.device)
        mask = bev.ground_suppressed_mask(pts, margin=cfg.ground_margin) \
            if float(cfg.ground_margin) > 0 else None
        return bev.build_elevation_image(pts, mask, pixel_size=cfg.pixel_size,
                                         size=cfg.im_size, z_min=cfg.z_min,
                                         z_max=cfg.z_max)

    def next_initial_pose(self, data_dict: Optional[dict] = None, **kwargs):
        from pylidar_slam_tpu_torch.ops import bev
        cfg = self.config
        image = self._image(frame_points(data_dict))
        if self._prev_image is None:
            self._prev_image = image
            return None
        # T maps current-frame coords into previous-frame coords: the
        # relative pose prior the odometry expects
        result = bev.register_bev(self._prev_image, image,
                                  num_yaw_steps=cfg.num_yaw_steps,
                                  yaw_range=cfg.yaw_range)
        self._prev_image = image
        if float(result.score) < cfg.min_score:
            return None if cfg.ni_if_failure else self._last_motion
        estimate = bev.bev_transform_to_se3(result, cfg.pixel_size).cpu().numpy()
        self._last_motion = estimate.astype(np.float64)
        return self._last_motion


@dataclass
class PNConfig(InitializationConfig):
    """PoseNet initialization: a trained checkpoint provides the motion prior."""
    type: str = "posenet"
    train_dir: str = MISSING
    checkpoint_file: str = "checkpoint.ckp"
    train_config_file: str = "config.yaml"
    num_points_padded: int = 131072


class PoseNetInitialization(Initialization):
    """Regresses the prior from the previous and current scans via PoseNet."""

    def __init__(self, config: PNConfig, projector=None, device="cuda", **kwargs):
        super().__init__(config)
        from pylidar_slam_tpu_torch.slam.odometry.posenet_odometry import _PoseNetInference
        self.inference = _PoseNetInference(
            str(config.train_dir), config.train_config_file, config.checkpoint_file,
            projector, torch.device(device), config.num_points_padded)
        self._prev = None

    def init(self):
        self._prev = None

    def next_initial_pose(self, data_dict: Optional[dict] = None, **kwargs):
        pts, mask = self.inference.upload(frame_points(data_dict))
        if self._prev is None:
            self._prev = (pts, mask)
            return None
        _, rpose = self.inference(*self._prev, pts, mask)
        self._prev = (pts, mask)
        return rpose  # a device tensor, used as it is by the odometry


INITIALIZATION = Registry("initialization", type_key="type")
INITIALIZATION.register("ni", NoInitialization, NIConfig)
INITIALIZATION.register("cv", ConstantVelocityInitialization, CVConfig)
INITIALIZATION.register("posenet", PoseNetInitialization, PNConfig)
INITIALIZATION.register("ei", ElevationImageInitialization, EIConfig)
