"""Ford Campus dataset (.mat scans; port of
``pylidar_slam_tpu.dataset.ford_dataset``).

Scans come from MATLAB .mat files, read with ``scipy.io.loadmat`` (imported
when a frame is read); the sensor->vehicle rotation and the >8 m range
filter match the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import rotation as rot_ops
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.utils import assert_debug

_SENSOR_TO_VEHICLE = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0],
                               [0.0, 0.0, 1.0]], dtype=np.float32)


def _pose_from_params(params: np.ndarray) -> np.ndarray:
    """6-param (tx ty tz ex ey ez) -> (4, 4) (euler xyz convention)."""
    mat = np.eye(4)
    mat[:3, :3] = rot_ops.np_euler_to_mat(params[3:6][None])[0]
    mat[:3, 3] = params[:3]
    return mat


class FordCampusSequence:
    def __init__(self, sequence_dir: str, with_gt: bool = True,
                 pc_channel: str = "numpy_pc",
                 gt_channel: str = "absolute_pose_gt"):
        self.sequence_dir = Path(sequence_dir) / "SCANS"
        assert_debug(self.sequence_dir.exists(),
                     f"Missing SCANS dir {self.sequence_dir}")
        self.list_of_files = sorted(p.name for p in self.sequence_dir.iterdir())
        self._with_gt = with_gt
        self._pc_channel = pc_channel
        self._gt_channel = gt_channel

    def __len__(self):
        return len(self.list_of_files)

    def __getitem__(self, idx) -> dict:
        assert_debug(0 <= idx < len(self))
        from scipy.io import loadmat
        mat_content = loadmat(str(self.sequence_dir / self.list_of_files[idx]))
        scan = mat_content["SCAN"]
        pc_sensor = scan["XYZ"][0, 0].T.astype(np.float32)
        pc_sensor = pc_sensor[np.linalg.norm(pc_sensor, axis=-1) > 8]
        pc_vehicle = pc_sensor @ _SENSOR_TO_VEHICLE.T
        data_dict = {self._pc_channel: pc_vehicle}
        if self._with_gt:
            gt_params = scan["X_wv"][0, 0].T.reshape(-1)
            data_dict[self._gt_channel] = _pose_from_params(
                gt_params.astype(np.float64))
        return data_dict


@dataclass
class FordCampusConfig(DatasetConfig):
    dataset: str = "ford_campus"
    root_dir: str = MISSING
    up_fov: float = 3
    down_fov: float = -25
    lidar_height: int = 64
    lidar_width: int = 720
    train_sequences: List[str] = field(default_factory=lambda: ["dataset-1", "dataset-2"])
    test_sequences: List[str] = field(default_factory=lambda: ["dataset-1", "dataset-2"])
    eval_sequences: List[str] = field(default_factory=list)


class FordCampusDatasetLoader(DatasetLoader):
    def __init__(self, config: FordCampusConfig):
        if not isinstance(config, FordCampusConfig):
            config = dataclass_from_dict(FordCampusConfig, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(), f"Ford root {self.root_dir} missing")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def _make(self, ids):
        if not ids:
            return None
        return [FordCampusSequence(str(self.root_dir / i),
                                   pc_channel=self.config.numpy_pc_key,
                                   gt_channel=self.config.absolute_gt_key)
                for i in ids]

    def sequences(self):
        cfg = self.config
        return ((self._make(cfg.train_sequences), cfg.train_sequences),
                (self._make(cfg.eval_sequences), cfg.eval_sequences),
                (self._make(cfg.test_sequences), cfg.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        gt_file = self.root_dir / sequence_name / "poses_gt.npy"
        if gt_file.exists():
            absolute = np.load(str(gt_file))
            return compute_relative_poses(absolute)
        return None
