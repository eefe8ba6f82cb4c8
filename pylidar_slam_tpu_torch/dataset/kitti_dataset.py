"""KITTI odometry benchmark dataset (port of
``pylidar_slam_tpu.dataset.kitti_dataset``; a numpy host reader).

.bin float32 (N, 4) scans, the 0.205-degree per-point vertical-angle
de-calibration, and the ``Tr`` calib conjugation of camera-frame GT poses into
the LiDAR frame.  Scans go through the native one-pass reader
(``utils/native.load_kitti_scan``: read, correct in float32, drop NaN rows)
and through numpy's ``correct_scan`` (which keeps NaN rows) only where the
native library cannot be built.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import projection as proj_ops
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.utils import assert_debug, native


def kitti_read_scan(file_path: str) -> np.ndarray:
    """Reads a KITTI .bin scan -> (N, 4) float32 [x, y, z, reflectance]."""
    scan = np.fromfile(file_path, dtype=np.float32)
    return scan.reshape((-1, 4))


def read_calib_file(file_path: str) -> dict:
    """KITTI calib.txt -> {key: np.ndarray of floats}."""
    calib_dict = {}
    with open(file_path, "r") as calib_file:
        for line in calib_file.readlines():
            tokens = line.split(" ")
            if tokens[0] == "calib_time:":
                continue
            if len(tokens) > 0:
                values = np.array([float(t) for t in tokens[1:]], dtype=np.float32)
                calib_dict[tokens[0].rstrip(":")] = values
    return calib_dict


def read_ground_truth_file(file_path: str) -> np.ndarray:
    """KITTI poses txt (N x 12) -> (N, 4, 4)."""
    poses = np.loadtxt(file_path).reshape(-1, 12)
    n = poses.shape[0]
    poses = np.concatenate(
        [poses, np.zeros((n, 3), poses.dtype), np.ones((n, 1), poses.dtype)], axis=1)
    return poses.reshape(n, 4, 4)


def correct_scan(scan: np.ndarray) -> np.ndarray:
    """Corrects KITTI HDL-64 intrinsic calibration: rotates each point by
    0.205 deg about the axis (point x z) (vectorized Rodrigues)."""
    xyz = scan[:, :3]
    n = scan.shape[0]
    z_axis = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
    axes = np.cross(xyz, np.broadcast_to(z_axis, (n, 3)))
    norms = np.linalg.norm(axes, axis=1, keepdims=True)
    axes = axes / np.where(norms > 0, norms, 1.0)
    theta = 0.205 * np.pi / 180.0
    c, s = np.cos(theta), np.sin(theta)
    dot = np.einsum("ni,ni->n", axes, xyz)
    crossed = np.cross(axes, xyz)
    # Rodrigues: R p = c p + s (a x p) + (1-c) (a.p) a
    return (c * xyz + s * crossed + (1 - c) * dot[:, None] * axes).astype(np.float32)


KITTI_SEQUENCE_INFO = {
    # '<seq_id>': ('<raw_drive_folder>', raw_start, size)
    "00": ("2011_10_03/2011_10_03_drive_0027", 0, 4541),
    "01": ("2011_10_03/2011_10_03_drive_0042", 0, 1101),
    "02": ("2011_10_03/2011_10_03_drive_0034", 0, 4661),
    "03": (None, 0, 801),
    "04": ("2011_09_30/2011_09_30_drive_0016", 0, 271),
    "05": ("2011_09_30/2011_09_30_drive_0018", 0, 2761),
    "06": ("2011_09_30/2011_09_30_drive_0020", 0, 1101),
    "07": ("2011_09_30/2011_09_30_drive_0027", 0, 1101),
    "08": ("2011_09_30/2011_09_30_drive_0028", 1100, 4071),
    "09": ("2011_09_30/2011_09_30_drive_0033", 0, 1591),
    "10": ("2011_09_30/2011_09_30_drive_0034", 0, 1201),
    "11": (None, 0, 921), "12": (None, 0, 1061), "13": (None, 0, 3281),
    "14": (None, 0, 631), "15": (None, 0, 1901), "16": (None, 0, 1731),
    "17": (None, 0, 491), "18": (None, 0, 1801), "19": (None, 0, 4981),
    "20": (None, 0, 831), "21": (None, 0, 2721),
}


class KITTIOdometrySequence:
    """Map-style dataset for one KITTI odometry sequence."""

    def __init__(self, sequences_root_dir: str, sequence_id: str,
                 numpy_pc_key: str = "numpy_pc",
                 ground_truth_channel: Optional[str] = "absolute_pose_gt",
                 with_numpy_pc: bool = True,
                 raw_dir: Optional[str] = None):
        self.sequence_dir = Path(sequences_root_dir)
        self.sequence_id = sequence_id
        self.id = sequence_id
        self.numpy_pc_key = numpy_pc_key
        self.ground_truth_channel = ground_truth_channel
        drive, self.raw_start, self.size = KITTI_SEQUENCE_INFO[sequence_id]
        # Partial downloads / fabricated micro-sequences: trust the files on
        # disk over the canonical size table when they disagree.
        vel = Path(sequences_root_dir) / "sequences" / sequence_id / "velodyne"
        if vel.exists():
            n_files = len(list(vel.glob("*.bin")))
            if n_files and n_files != self.size:
                self.size = n_files
        self.velodyne_path = self.sequence_dir / "sequences" / sequence_id / "velodyne"

        # Raw-drive track: unrectified scans + synthetic azimuth timestamps
        # for de-skew experiments.
        self.raw_velodyne_path: Optional[Path] = None
        if raw_dir is not None and drive is not None:
            candidate = Path(str(raw_dir)) / drive / "velodyne_points" / "data"
            if not candidate.exists():
                candidate = Path(str(raw_dir)) / f"{drive}_sync" / \
                    "velodyne_points" / "data"
            if candidate.exists():
                self.raw_velodyne_path = candidate

        calib_path = self.sequence_dir / "sequences" / sequence_id / "calib.txt"
        self.calib_tr: Optional[np.ndarray] = None
        if calib_path.exists():
            calib = read_calib_file(str(calib_path))
            if "Tr" in calib:
                tr = np.eye(4, dtype=np.float64)
                tr[:3, :4] = calib["Tr"].reshape(3, 4)
                self.calib_tr = tr

        self.poses_gt: Optional[np.ndarray] = None
        if self.ground_truth_channel:
            gt_file = self.sequence_dir / "poses" / f"{sequence_id}.txt"
            if gt_file.exists():
                poses = read_ground_truth_file(str(gt_file)).astype(np.float64)
                self.poses_gt = self._lidar_pose_gt(poses)

    def _lidar_pose_gt(self, poses_gt: np.ndarray) -> np.ndarray:
        if self.calib_tr is not None:
            tr = self.calib_tr
            return np.linalg.inv(tr) @ poses_gt @ tr
        return poses_gt

    def __len__(self):
        return self.size

    def __getitem__(self, idx) -> dict:
        assert_debug(idx < self.size)
        data_dict = {}
        scan_path = self.velodyne_path / f"{idx:06}.bin"
        assert_debug(scan_path.exists(), f"Scan file {scan_path} does not exist")
        # Native one-pass read+correct+scrub (utils/native.py); numpy fallback.
        loaded = native.load_kitti_scan(str(scan_path), 200000)
        if loaded is not None:
            out, n = loaded
            data_dict[self.numpy_pc_key] = out[:n]
        else:
            scan = kitti_read_scan(str(scan_path))
            data_dict[self.numpy_pc_key] = correct_scan(scan)
        if self.raw_velodyne_path is not None:
            raw = self._read_raw_scan(idx)
            if raw is not None:
                data_dict["raw_numpy_pc"] = raw
                # Synthetic per-point timestamps in [-0.5, 0.5] around
                # mid-scan, from the azimuth.
                data_dict["raw_numpy_pc_timestamps"] = (
                    proj_ops.np_estimate_timestamps(
                        raw, clockwise=True, phi_0=np.pi) - 0.5
                ).astype(np.float32)
        if self.ground_truth_channel and self.poses_gt is not None:
            data_dict[self.ground_truth_channel] = self.poses_gt[idx]
        return data_dict

    def _read_raw_scan(self, idx: int) -> Optional[np.ndarray]:
        """Unrectified raw-drive scan (txt or bin, whichever the raw dump
        provides)."""
        stem = f"{self.raw_start + idx:010}"
        txt = self.raw_velodyne_path / f"{stem}.txt"
        if txt.exists():
            return np.loadtxt(str(txt), dtype=np.float32)[:, :3]
        binf = self.raw_velodyne_path / f"{stem}.bin"
        if binf.exists():
            return np.fromfile(str(binf),
                               dtype=np.float32).reshape(-1, 4)[:, :3]
        return None


@dataclass
class KITTIConfig(DatasetConfig):
    dataset: str = "kitti"
    kitti_sequence_dir: str = MISSING
    kitti_raw_dir: Optional[str] = None
    lidar_key: str = "vertex_map"
    lidar_height: int = 64
    lidar_width: int = 1024
    up_fov: float = 3
    down_fov: float = -24
    train_sequences: list = field(default_factory=lambda: [
        "00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"])
    test_sequences: list = field(default_factory=lambda: [f"{i:02}" for i in range(22)])
    eval_sequences: list = field(default_factory=lambda: ["09", "10"])


class KITTIDatasetLoader(DatasetLoader):
    def __init__(self, config: KITTIConfig):
        if not isinstance(config, KITTIConfig):
            config = dataclass_from_dict(KITTIConfig, config)
        super().__init__(config)
        self.odometry_sequence_dir = Path(str(self.config.kitti_sequence_dir))
        assert_debug(self.odometry_sequence_dir.exists(),
                     f"KITTI root {self.odometry_sequence_dir} does not exist")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(height=int(cfg.lidar_height),
                                   width=int(cfg.lidar_width),
                                   up_fov=float(cfg.up_fov),
                                   down_fov=float(cfg.down_fov))

    def get_ground_truth(self, sequence_name):
        if sequence_name in [f"{i:02}" for i in range(11)]:
            poses = read_ground_truth_file(
                str(self.odometry_sequence_dir / "poses" / f"{sequence_name}.txt")
            ).astype(np.float64)
            calib = read_calib_file(
                str(self.odometry_sequence_dir / "sequences" / sequence_name / "calib.txt"))
            tr = np.eye(4, dtype=np.float64)
            tr[:3, :4] = calib["Tr"].reshape(3, 4)
            absolute = np.linalg.inv(tr) @ poses @ tr
            return compute_relative_poses(absolute)
        return None

    def _make(self, sequence_ids):
        if not sequence_ids:
            return None
        return [KITTIOdometrySequence(
            str(self.odometry_sequence_dir), seq_id,
            numpy_pc_key=self.config.numpy_pc_key,
            ground_truth_channel=self.config.absolute_gt_key,
            with_numpy_pc=self.config.with_numpy_pc,
            raw_dir=self.config.kitti_raw_dir) for seq_id in sequence_ids]

    def sequences(self):
        train, evals, test = (self.config.train_sequences,
                              self.config.eval_sequences,
                              self.config.test_sequences)
        return ((self._make(train), train), (self._make(evals), evals),
                (self._make(test), test), lambda x: x)
