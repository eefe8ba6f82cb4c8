"""NHCD (Newer College) dataset (port of
``pylidar_slam_tpu.dataset.nhcd_dataset``), its PCD frames read by the
pure-Python ``pcd_io`` module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.dataset.pcd_io import read_pcd
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import se3
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.utils import assert_debug



def _quat_xyzw_to_mat(q: np.ndarray) -> np.ndarray:
    wxyz = np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)
    return se3.np_quat_to_mat(wxyz)


def read_ground_truth(file_path: str):
    """GT csv (sec, nsec, x, y, z, qx, qy, qz, qw) with the lidar-to-camera
    extrinsic applied (reference nhcd_dataset.py:21-42)."""
    assert_debug(Path(file_path).exists(), f"Missing GT file {file_path}")
    gt = np.genfromtxt(str(file_path), delimiter=",", dtype=np.float64)
    seconds = gt[:, 0]
    nano_seconds = gt[:, 1]
    xyz = gt[:, 2:5]
    qxyzw = gt[:, 5:9]

    num_poses = qxyzw.shape[0]
    poses = np.tile(np.eye(4), (num_poses, 1, 1))
    poses[:, :3, :3] = _quat_xyzw_to_mat(qxyzw)
    poses[:, :3, 3] = xyz

    t_cl = np.eye(4)
    t_cl[:3, :3] = _quat_xyzw_to_mat(np.array([0.0, 0.0, 0.924, 0.383]))
    t_cl[:3, 3] = [-0.084, -0.025, 0.050]
    poses = poses @ t_cl
    poses_timestamps = seconds * 10e9 + nano_seconds
    poses = np.linalg.inv(poses[0]) @ poses
    return poses, poses_timestamps


def pointcloud_poses(poses, poses_timestamps, filenames):
    """Nearest-timestamp pose association (reference nhcd:45-59)."""
    timestamps = []
    for filename in filenames:
        tokens = filename.replace(".", "_ ").split("_")
        secs = float(tokens[1])
        nsecs = float(tokens[2])
        timestamps.append(secs * 10e9 + nsecs)
    file_timestamps = np.array(timestamps)
    file_indices = np.clip(np.searchsorted(poses_timestamps, file_timestamps),
                           0, len(poses) - 1)
    return poses[file_indices]


class NHCDOdometrySequence:
    _NUM_FRAMES = {"01_short_experiment": 15301, "02_long_experiment": 26000}

    def __init__(self, sequences_root_dir: str, sequence_id: str,
                 pointcloud_channel: str = "numpy_pc",
                 ground_truth_channel: Optional[str] = "absolute_pose_gt"):
        self.root = Path(sequences_root_dir) / sequence_id
        self.pcd_paths = self.root / "raw_format" / "ouster_scan"
        assert_debug(self.pcd_paths.exists(), f"Missing {self.pcd_paths}")
        self.pointcloud_channel = pointcloud_channel
        self.ground_truth_channel = ground_truth_channel
        self.file_names = sorted(p.name for p in self.pcd_paths.iterdir()
                                 if p.suffix == ".pcd")
        cap = self._NUM_FRAMES.get(sequence_id, len(self.file_names))
        self._size = min(len(self.file_names), cap)

        self.has_gt = False
        self.poses = None
        gt_file = self.root / "ground_truth" / "registered_poses.csv"
        if ground_truth_channel and gt_file.exists():
            poses, ts = read_ground_truth(str(gt_file))
            self.poses = pointcloud_poses(poses, ts, self.file_names[:self._size])
            self.has_gt = True

    def __len__(self):
        return self._size

    def __getitem__(self, idx) -> dict:
        assert_debug(idx < self._size)
        xyz = read_pcd(str(self.pcd_paths / self.file_names[idx]))
        data_dict = {self.pointcloud_channel: xyz}
        # Synthetic row timestamps (64-beam Ouster, reference nhcd:140-146)
        n_rows = max(int(xyz.shape[0] / 64), 1)
        timestamps = np.arange(n_rows).reshape(n_rows, 1).repeat(64, axis=1)
        timestamps = timestamps.reshape(-1).astype(np.float64)[: xyz.shape[0]]
        span = max(timestamps.max() - timestamps.min(), 1.0)
        data_dict[f"{self.pointcloud_channel}_timestamps"] = \
            (timestamps - timestamps.min()) / span + idx
        if self.has_gt:
            data_dict[self.ground_truth_channel] = self.poses[idx]
        return data_dict


@dataclass
class NHCDConfig(DatasetConfig):
    dataset: str = "nhcd"
    root_dir: str = MISSING
    lidar_height: int = 64
    lidar_width: int = 1024
    up_fov: float = 16.6
    down_fov: float = -16.6
    train_sequences: List[str] = field(default_factory=lambda: ["01_short_experiment"])
    test_sequences: List[str] = field(default_factory=lambda: ["02_long_experiment"])
    eval_sequences: List[str] = field(default_factory=list)


class NHCDDatasetLoader(DatasetLoader):
    def __init__(self, config: NHCDConfig):
        if not isinstance(config, NHCDConfig):
            config = dataclass_from_dict(NHCDConfig, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(), f"NHCD root {self.root_dir} missing")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def _make(self, ids):
        if not ids:
            return None
        return [NHCDOdometrySequence(str(self.root_dir), i,
                                     pointcloud_channel=self.config.numpy_pc_key,
                                     ground_truth_channel=self.config.absolute_gt_key)
                for i in ids]

    def sequences(self):
        cfg = self.config
        return ((self._make(cfg.train_sequences), cfg.train_sequences),
                (self._make(cfg.eval_sequences), cfg.eval_sequences),
                (self._make(cfg.test_sequences), cfg.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        seq = NHCDOdometrySequence(str(self.root_dir), sequence_name)
        if seq.has_gt:
            return compute_relative_poses(seq.poses)
        return None
