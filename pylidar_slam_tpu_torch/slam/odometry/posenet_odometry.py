"""PoseNet deep odometry: per-frame relative pose regression from a trained
checkpoint (torch port of ``pylidar_slam_tpu.slam.odometry.posenet_odometry``).

Reads ``{train_dir}/config.yaml`` and ``{train_dir}/checkpoint.ckp`` (the
port's trainer writes both, and so does the JAX package's: its pickled
checkpoint is read without JAX), rebuilds the network and regresses the relative
pose from the previous and current frames rasterized on the device.  Each
frame's pose stays on the device; ``get_relative_poses`` fetches the log
once.
"""
from __future__ import annotations

import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict, load_yaml_file
from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables, read_jax_checkpoint
from pylidar_slam_tpu_torch.ops import projection
from pylidar_slam_tpu_torch.slam.initialization import frame_points
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import OdometryConfig, _pose_matrix_f64
from pylidar_slam_tpu_torch.training.prediction_modules import (PoseNetPredictionModule,
                                                                PredictionConfig)
from pylidar_slam_tpu_torch.utils import assert_debug


@dataclass
class PoseNetOdometryConfig(OdometryConfig):
    algorithm: str = "posenet"
    debug: bool = False
    train_dir: str = MISSING
    train_config_file: str = "config.yaml"
    checkpoint_file: str = "checkpoint.ckp"
    device: str = "tpu"  # the card unless `cpu`
    pose: str = "euler"
    posenet_config: Dict[str, Any] = field(default_factory=dict)
    num_points_padded: int = 131072


class _PoseNetInference:
    """Checkpoint loading and the regression, shared by the odometry and
    the PoseNet initialization."""

    def __init__(self, train_dir: str, train_config_file: str, checkpoint_file: str,
                 projector: Optional[projection.SphericalProjection], device: torch.device,
                 num_points_padded: int):
        tdir = Path(train_dir)
        assert_debug(tdir.exists(), f"train_dir {tdir} does not exist")
        cfg_path, ckpt_path = tdir / train_config_file, tdir / checkpoint_file
        assert_debug(cfg_path.exists(), f"Missing train config {cfg_path}")
        assert_debug(ckpt_path.exists(), f"Missing checkpoint {ckpt_path}")

        train_config = load_yaml_file(cfg_path)
        pred_cfg = dataclass_from_dict(PredictionConfig, dict(train_config.get("prediction", {})))
        self.device = device
        self.prediction = PoseNetPredictionModule(pred_cfg, device=device)
        proj_cfg = train_config.get("projector")
        if projector is None and proj_cfg:
            projector = projection.SphericalProjection(
                height=int(proj_cfg["height"]), width=int(proj_cfg["width"]),
                up_fov=float(proj_cfg["up_fov"]), down_fov=float(proj_cfg["down_fov"]))
        assert_debug(projector is not None, "PoseNet inference needs a projector")
        self.proj = projector
        self.cap = int(num_points_padded)
        if zipfile.is_zipfile(ckpt_path):  # the port's torch.save
            state = torch.load(ckpt_path, map_location=device, weights_only=True)
            self.prediction.module.load_state_dict(state["model"])
        else:  # the JAX trainer's pickle
            state = read_jax_checkpoint(ckpt_path)
            load_jax_variables(self.prediction.module, state["params"], state["batch_stats"])
        self.prediction.module.eval()

    def upload(self, points: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host cloud -> its padded device copy and validity mask (NaN
        rows dropped, at most `num_points_padded` kept)."""
        pts = points[:, :3].astype(np.float32)
        pts = np.ascontiguousarray(pts[~np.isnan(pts).any(axis=1)][:self.cap])
        host = torch.from_numpy(pts)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        n = dev.shape[0]
        dev = torch.cat([dev, dev.new_zeros((self.cap - n, 3))])
        return dev, torch.arange(self.cap, device=self.device) < n

    @torch.no_grad()
    def __call__(self, prev_pts, prev_mask, cur_pts, cur_mask):
        """(pose_params (6,), pose_matrix (4, 4)) of the current frame in the
        previous one, on the device."""
        vmaps = projection.build_vertex_map(torch.stack([prev_pts, cur_pts]), self.proj,
                                            mask=torch.stack([prev_mask, cur_mask]))
        stacked = vmaps.permute(0, 3, 1, 2)[None]  # (1, 2, 3, H, W)
        pose_params, pose_matrix = self.prediction.apply(stacked, train=False)
        return pose_params[0], pose_matrix[0]


class PoseNetOdometry:
    """Pure deep odometry: one forward of the checkpointed network per frame."""

    def __init__(self, config: PoseNetOdometryConfig,
                 projector: Optional[projection.SphericalProjection] = None,
                 device=None, **kwargs):
        if not isinstance(config, PoseNetOdometryConfig):
            config = dataclass_from_dict(PoseNetOdometryConfig, config)
        from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device
        self.config = config
        self.device = torch.device(device) if device is not None else \
            resolve_device(config.device)
        self.inference = _PoseNetInference(
            str(config.train_dir), config.train_config_file, config.checkpoint_file,
            projector, self.device, config.num_points_padded)
        self.init()

    @staticmethod
    def pointcloud_key() -> str:
        return "odometry_pc"

    @staticmethod
    def relative_pose_key() -> str:
        return "odometry_pose"

    def init(self):
        self._prev = None
        self._params_log: list = []
        self._iter = 0
        self.last_rpose_device = None

    def process_next_frame(self, data_dict: dict):
        pts, mask = self.inference.upload(frame_points(data_dict))
        if self._prev is None:
            self.last_rpose_device = torch.eye(4, dtype=torch.float32, device=self.device)
            params = torch.zeros(6, dtype=torch.float32, device=self.device)
        else:
            params, self.last_rpose_device = self.inference(*self._prev, pts, mask)
        self._prev = (pts, mask)
        self._params_log.append(params)
        data_dict[self.relative_pose_key()] = self.last_rpose_device
        self._iter += 1

    def get_relative_poses(self) -> Optional[np.ndarray]:
        if not self._params_log:
            return None
        params = torch.stack(self._params_log).cpu().numpy().astype(np.float64)
        return np.stack([_pose_matrix_f64(p) for p in params]).astype(np.float32)
