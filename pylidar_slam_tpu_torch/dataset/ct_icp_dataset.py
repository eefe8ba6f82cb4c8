"""CT-ICP-format datasets: directories of PLY frames with per-point
timestamps (port of ``pylidar_slam_tpu.dataset.ct_icp_dataset``).

Pure Python/numpy readers over the published CT-ICP disk layout:

    <root_dir>/<sequence>/frames/*.ply     (or <root_dir>/<sequence>/*.ply)
    <root_dir>/<sequence>/trajectory.txt   optional KITTI 12-col GT

Each PLY frame carries x/y/z (+ optional timestamp property, surfaced under
``<numpy_pc_key>_timestamps`` for the Distortion filter / elastic ICP).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.dataset.ply_io import ply_to_pointcloud, read_ply_fields
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.utils import assert_debug


class CTICPSequence:
    """Map-style dataset over a directory of PLY frames."""

    def __init__(self, root: str, sequence_id: str,
                 numpy_pc_key: str = "numpy_pc",
                 ground_truth_channel: Optional[str] = "absolute_pose_gt"):
        self.id = sequence_id
        self.numpy_pc_key = numpy_pc_key
        self.ground_truth_channel = ground_truth_channel
        seq_dir = Path(root) / sequence_id
        frames_dir = seq_dir / "frames"
        if not frames_dir.is_dir():
            frames_dir = seq_dir
        assert_debug(frames_dir.is_dir(), f"Missing {frames_dir}")
        self.files = sorted(p for p in frames_dir.iterdir()
                            if p.suffix.lower() == ".ply")
        assert_debug(len(self.files) > 0, f"No PLY frames in {frames_dir}")

        self.poses_gt: Optional[np.ndarray] = None
        for gt_name in ("trajectory.txt", f"{sequence_id}_gt.txt",
                        "poses_gt.txt"):
            gt_file = seq_dir / gt_name
            if gt_file.exists():
                flat = np.loadtxt(str(gt_file), dtype=np.float64)
                poses = np.tile(np.eye(4), (flat.shape[0], 1, 1))
                poses[:, :3, :4] = flat[:, :12].reshape(-1, 3, 4)
                self.poses_gt = poses
                break

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx) -> dict:
        assert_debug(idx < len(self.files))
        pts, ts = ply_to_pointcloud(read_ply_fields(str(self.files[idx])))
        data_dict = {self.numpy_pc_key: pts}
        if ts is not None:
            span = ts.max() - ts.min()
            # normalize to [0, 1] + frame index (Distortion filter contract)
            data_dict[f"{self.numpy_pc_key}_timestamps"] = \
                (ts - ts.min()) / max(span, 1e-12) + idx
        if self.ground_truth_channel and self.poses_gt is not None and \
                idx < len(self.poses_gt):
            data_dict[self.ground_truth_channel] = self.poses_gt[idx]
        return data_dict


@dataclass
class CTICPConfig(DatasetConfig):
    dataset: str = "ct_icp"
    root_dir: str = MISSING
    lidar_height: int = 64
    lidar_width: int = 1024
    up_fov: float = 3.0
    down_fov: float = -24.0
    train_sequences: List[str] = field(default_factory=list)
    eval_sequences: List[str] = field(default_factory=list)
    test_sequences: List[str] = field(default_factory=list)


class CTICPDatasetLoader(DatasetLoader):
    def __init__(self, config: CTICPConfig):
        if not isinstance(config, CTICPConfig):
            config = dataclass_from_dict(CTICPConfig, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(),
                     f"CT-ICP root {self.root_dir} missing")
        # Default: every subdirectory holding PLYs is a train sequence.
        if not config.train_sequences:
            config.train_sequences = sorted(
                p.name for p in self.root_dir.iterdir() if p.is_dir())

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height),
                                   int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def _make(self, ids):
        if not ids:
            return None
        return [CTICPSequence(str(self.root_dir), i,
                              numpy_pc_key=self.config.numpy_pc_key,
                              ground_truth_channel=self.config.absolute_gt_key)
                for i in ids]

    def sequences(self):
        cfg = self.config
        return ((self._make(cfg.train_sequences), cfg.train_sequences),
                (self._make(cfg.eval_sequences), cfg.eval_sequences),
                (self._make(cfg.test_sequences), cfg.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        seq = CTICPSequence(str(self.root_dir), sequence_name)
        if seq.poses_gt is not None:
            return compute_relative_poses(seq.poses_gt)
        return None
