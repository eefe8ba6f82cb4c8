"""NCLT dataset (University of Michigan North Campus Long-Term dataset; port
of ``pylidar_slam_tpu.dataset.nclt_dataset``).

Faithful to the reference reader: int16 binary
velodyne files decoded as ``value * 0.005 - 100``, z-flip into an upward
frame, 100 m range crop, GT csv interpolated onto scan timestamps with
body/velodyne/velodyne_inverted frame conjugations.
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
from pylidar_slam_tpu_torch.ops.se3 import PosesInterpolator
from pylidar_slam_tpu_torch.utils import assert_debug

_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])
_VELO_ROT = np.array([[0.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def nclt_convert(x_s, y_s, z_s):
    """NCLT int16 -> meters: value * 0.005 - 100 (reference nclt:26-33)."""
    scaling = 0.005
    offset = -100.0
    return x_s * scaling + offset, y_s * scaling + offset, z_s * scaling + offset


def read_velodyne_file(file: str) -> np.ndarray:
    binary = np.fromfile(file, dtype=np.int16)
    x = binary[::4].astype(np.float32)
    y = binary[1::4].astype(np.float32)
    z = binary[2::4].astype(np.float32)
    x, y, z = nclt_convert(x, y, z)
    # Flip to have z pointing up
    return np.stack([x, -y, -z], axis=1)


def _euler_zyx_to_mat(euler_rph: np.ndarray) -> np.ndarray:
    """NCLT GT euler (r, p, h) -> rotation Rz(h) Ry(p) Rx(r) (batched)."""
    return rot_ops.np_euler_to_mat(euler_rph)


def interpolate_ground_truth(ground_truth: np.ndarray, timestamps: np.ndarray,
                             reference_frame: str = "velodyne_inverted") -> np.ndarray:
    """GT csv rows (t, x, y, z, r, p, h) -> (N, 4, 4) poses at `timestamps`."""
    assert_debug(reference_frame in ["body", "velodyne", "velodyne_inverted"])
    gt_t = ground_truth[:, 0]
    ok = ~np.isnan(gt_t)
    gt_t = gt_t[ok]
    gt = ground_truth[ok, 1:]
    nan_rows = np.isnan(gt).any(axis=1)
    gt_t, gt = gt_t[~nan_rows], gt[~nan_rows]

    poses = np.tile(np.eye(4), (gt.shape[0], 1, 1))
    poses[:, :3, :3] = _euler_zyx_to_mat(gt[:, 3:6])
    poses[:, :3, 3] = gt[:, :3]

    if reference_frame == "velodyne_inverted":
        poses = _FLIP_YZ @ poses @ _FLIP_YZ
    elif reference_frame == "velodyne":
        poses = np.linalg.inv(_VELO_ROT) @ poses @ _VELO_ROT

    interp = PosesInterpolator(poses, gt_t)
    return interp(np.clip(timestamps, gt_t.min(), gt_t.max()))


class NCLTSequence:
    def __init__(self, root_dir: str, sequence_id: str,
                 numpy_pc_key: str = "numpy_pc",
                 gt_key: str = "absolute_pose_gt"):
        self.sequence_dir = Path(root_dir) / sequence_id
        self.numpy_pc_key = numpy_pc_key
        self.gt_key = gt_key
        velodyne_dir = self.sequence_dir / "velodyne_sync"
        assert_debug(velodyne_dir.exists(), f"Missing {velodyne_dir}")
        self.velodyne_files = sorted(p.name for p in velodyne_dir.iterdir()
                                     if p.suffix == ".bin")
        self.timestamps = np.array([float(Path(f).stem)
                                    for f in self.velodyne_files])
        self._size = len(self.velodyne_files)

        self._gt = None
        gt_file = self.sequence_dir / f"groundtruth_{sequence_id}.csv"
        if gt_file.exists():
            gt = np.genfromtxt(str(gt_file), delimiter=",", dtype=np.float64)
            self._gt = interpolate_ground_truth(gt, self.timestamps)

    def __len__(self):
        return self._size

    def __getitem__(self, idx: int) -> dict:
        assert_debug(0 <= idx < self._size)
        pc_file = self.sequence_dir / "velodyne_sync" / self.velodyne_files[idx]
        numpy_pc = read_velodyne_file(str(pc_file))
        numpy_pc = numpy_pc[np.linalg.norm(numpy_pc, axis=-1) < 100.0]
        data_dict = {self.numpy_pc_key: numpy_pc}
        if self._gt is not None:
            data_dict[self.gt_key] = self._gt[idx]
        return data_dict


@dataclass
class NCLTConfig(DatasetConfig):
    dataset: str = "nclt"
    root_dir: str = MISSING
    lidar_height: int = 40
    lidar_width: int = 720
    up_fov: float = 30
    down_fov: float = -5
    train_sequences: List[str] = field(default_factory=lambda: [
        "2012-01-22", "2012-02-02", "2012-02-04", "2012-02-05", "2012-02-12",
        "2012-02-18", "2012-02-19", "2012-03-17", "2012-03-25", "2012-03-31"])
    test_sequences: List[str] = field(default_factory=lambda: [
        "2012-01-08", "2012-01-15"])
    eval_sequences: List[str] = field(default_factory=list)


class NCLTDatasetLoader(DatasetLoader):
    def __init__(self, config: NCLTConfig):
        if not isinstance(config, NCLTConfig):
            config = dataclass_from_dict(NCLTConfig, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(), f"NCLT root {self.root_dir} missing")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def _make(self, ids):
        if not ids:
            return None
        return [NCLTSequence(str(self.root_dir), i,
                             numpy_pc_key=self.config.numpy_pc_key,
                             gt_key=self.config.absolute_gt_key) for i in ids]

    def sequences(self):
        cfg = self.config
        return ((self._make(cfg.train_sequences), cfg.train_sequences),
                (self._make(cfg.eval_sequences), cfg.eval_sequences),
                (self._make(cfg.test_sequences), cfg.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        seq = NCLTSequence(str(self.root_dir), sequence_name)
        if seq._gt is None:
            return None
        return compute_relative_poses(seq._gt)
