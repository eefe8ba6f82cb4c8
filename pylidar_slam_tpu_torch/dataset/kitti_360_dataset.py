"""KITTI-360 dataset (port of ``pylidar_slam_tpu.dataset.kitti_360_dataset``).

Raw .bin velodyne scans; the sparse camera-frame GT poses are slerp/lerp
interpolated onto per-scan timestamps and conjugated through the fixed
cam0->pose and velo->cam0 calibrations into the LiDAR frame.  The timestamps
are parsed by numpy (the JAX package uses pandas, which the card's machine
lacks).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import projection as proj_ops
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.ops.se3 import PosesInterpolator
from pylidar_slam_tpu_torch.utils import assert_debug

logger = logging.getLogger(__name__)

CAM0_TO_POSE = np.array([
    [0.0371783278, -0.0986182135, 0.9944306009, 1.5752681039],
    [0.9992675562, -0.0053553387, -0.0378902567, 0.0043914093],
    [0.0090621821, 0.9951109327, 0.0983468786, -0.6500000000],
    [0, 0, 0, 1]], dtype=np.float64)

VELO_TO_CAM0 = np.linalg.inv(np.array([
    [0.04307104361, -0.08829286498, 0.995162929, 0.8043914418],
    [-0.999004371, 0.007784614041, 0.04392796942, 0.2993489574],
    [-0.01162548558, -0.9960641394, -0.08786966659, -0.1770225824],
    [0, 0, 0, 1]], dtype=np.float64))

SEQUENCE_SIZES = {0: 11518, 2: 19240, 3: 1031, 4: 11587, 5: 6743, 6: 9699,
                  7: 3396, 9: 14056, 10: 3836}


def drive_foldername(drive_id: int) -> str:
    return f"2013_05_28_drive_{drive_id:04}_sync"


def kitti_360_poses(file_path: str):
    """poses.txt rows: frame_index + 12 floats -> (indices, (N, 4, 4))."""
    poses = np.loadtxt(file_path).reshape(-1, 13)
    frame_indices = poses[:, 0].astype(np.int32)
    pose_data = poses[:, 1:]
    n = pose_data.shape[0]
    pose_data = np.concatenate(
        [pose_data, np.zeros((n, 3)), np.ones((n, 1))], axis=1)
    return frame_indices, pose_data.reshape(n, 4, 4)


def read_timestamps(file_path: str) -> np.ndarray:
    """ISO instants, one per line (``2013-05-28 08:46:02.802247461``, naive
    times read as UTC) -> float64 nanoseconds since the epoch."""
    with open(file_path, "r") as f:
        instants = [line.strip() for line in f if line.strip()]
    return np.array(instants, dtype="datetime64[ns]").astype(np.int64).astype(np.float64)


def get_sequence_poses(root_dir: str, drive_id: int) -> Optional[np.ndarray]:
    assert_debug(drive_id in SEQUENCE_SIZES, f"Unknown drive {drive_id}")
    root = Path(root_dir)
    folder = drive_foldername(drive_id)
    timestamps_path = root / "data_3d_raw" / folder / "velodyne_points" / "timestamps.txt"
    gt_file = root / "data_poses" / folder / "poses.txt"
    if not gt_file.exists():
        logger.warning("[KITTI-360] missing GT file %s", gt_file)
        return None
    index_frames, poses = kitti_360_poses(str(gt_file))
    timestamps = read_timestamps(str(timestamps_path))
    key_times = timestamps[index_frames]
    interp = PosesInterpolator(poses, key_times)
    gt_poses = interp(np.clip(timestamps, key_times.min(), key_times.max()))
    return gt_poses @ (CAM0_TO_POSE @ VELO_TO_CAM0)


class KITTI360Sequence:
    def __init__(self, root_dir: str, drive_id: int,
                 numpy_pc_key: str = "numpy_pc",
                 gt_key: str = "absolute_pose_gt"):
        self.root_dir = Path(root_dir)
        self.drive_id = drive_id
        self.numpy_pc_key = numpy_pc_key
        self.gt_key = gt_key
        folder = drive_foldername(drive_id)
        self.velodyne_path = (self.root_dir / "data_3d_raw" / folder /
                              "velodyne_points" / "data")
        assert_debug(self.velodyne_path.exists(),
                     f"Missing velodyne dir {self.velodyne_path}")
        self.size = SEQUENCE_SIZES[drive_id]
        self.gt_poses = get_sequence_poses(root_dir, drive_id)

    def __len__(self):
        return self.size

    def __getitem__(self, idx) -> dict:
        assert_debug(idx < self.size)
        scan_file = self.velodyne_path / f"{idx:010}.bin"
        scan = np.fromfile(str(scan_file), dtype=np.float32).reshape(-1, 4)[:, :3]
        data_dict = {self.numpy_pc_key: scan}
        # Azimuth-estimated timestamps
        ts = proj_ops.np_estimate_timestamps(scan, clockwise=True,
                                             phi_0=np.pi)
        data_dict[f"{self.numpy_pc_key}_timestamps"] = ts
        if self.gt_poses is not None:
            data_dict[self.gt_key] = self.gt_poses[idx]
        return data_dict


@dataclass
class KITTI360Config(DatasetConfig):
    dataset: str = "kitti_360"
    root_dir: str = MISSING
    lidar_height: int = 64
    lidar_width: int = 1024
    up_fov: float = 3
    down_fov: float = -24
    train_sequences: List[int] = field(default_factory=lambda: [0, 2, 3, 4, 5, 6, 7, 9, 10])
    test_sequences: List[int] = field(default_factory=lambda: [0])
    eval_sequences: List[int] = field(default_factory=list)


class KITTI360DatasetLoader(DatasetLoader):
    def __init__(self, config: KITTI360Config):
        if not isinstance(config, KITTI360Config):
            config = dataclass_from_dict(KITTI360Config, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(),
                     f"KITTI-360 root {self.root_dir} missing")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def _make(self, ids):
        if not ids:
            return None
        return [KITTI360Sequence(str(self.root_dir), int(i),
                                 numpy_pc_key=self.config.numpy_pc_key,
                                 gt_key=self.config.absolute_gt_key) for i in ids]

    def sequences(self):
        cfg = self.config
        names = [str(i) for i in cfg.train_sequences]
        return ((self._make(cfg.train_sequences), names),
                (self._make(cfg.eval_sequences), [str(i) for i in cfg.eval_sequences]),
                (self._make(cfg.test_sequences), [str(i) for i in cfg.test_sequences]),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        poses = get_sequence_poses(str(self.root_dir), int(sequence_name))
        if poses is None:
            return None
        return compute_relative_poses(poses)
