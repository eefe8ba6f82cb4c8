"""UrbanLoco dataset (port of ``pylidar_slam_tpu.dataset.urban_loco_dataset``):
rosbag-based sequences with ring-id reconstruction, azimuth-synchronized
frame re-cutting, and GPS (INSPVAX) -> ENU ground-truth generation.

The numba kernels are replaced by vectorized numpy (ring ids) and a plain
host loop (packet ids -- offline GT path only); the rosbag layer is the
pure-Python reader.
"""
from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.dataset.rosbag_dataset import RosbagConfig, RosbagDataset
from pylidar_slam_tpu_torch.dataset.rosbag_reader import BagReader
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import rotation as rot_ops
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.ops.se3 import PosesInterpolator
from pylidar_slam_tpu_torch.utils import assert_debug

logger = logging.getLogger(__name__)

CALIFORNIA_EXT_TO_LIDAR = np.array([[0., -1., 0., -5.245e-01],
                                    [-1., 0., 0., 1.06045],
                                    [0., 0., -1., 7.98576e-01],
                                    [0, 0, 0, 1]], dtype=np.float64)

HK_BODY_TO_LIDAR = np.array([[2.67949e-08, -1, 0, 0],
                             [1, 2.67949e-08, 0, 0],
                             [0, 0, 1, -0.28],
                             [0., 0., 0., 1]], dtype=np.float64)

HK_BODY_TO_SPAN = np.array([[2.67949e-08, -1, 0, 0],
                            [1, 2.67949e-08, 0, 0],
                            [0, 0, 1, -0.36],
                            [0., 0., 0., 1]], dtype=np.float64)

HK_SPAN_TO_LIDAR = HK_BODY_TO_LIDAR @ np.linalg.inv(HK_BODY_TO_SPAN)


def compute_ring_ids(theta_bins: np.ndarray, unique: np.ndarray) -> np.ndarray:
    """Maps polar-angle bins to ring ids (vectorized; reference :38-50)."""
    ring_ids = -np.ones_like(theta_bins, dtype=np.int64)
    for rid in range(min(len(unique), 32)):
        ring_ids[theta_bins == unique[rid]] = rid
    return ring_ids


def packet_ids(ring_ids: np.ndarray) -> np.ndarray:
    """Velodyne packet ids from the ring-id stream (exact sequential
    reconstruction; offline GT path only, reference :54-74)."""
    out = -np.ones((ring_ids.shape[0],), dtype=np.int64)
    seen = set()
    packet_id = 0
    col_id = 0
    for idx in range(ring_ids.shape[0]):
        ring_id = int(ring_ids[idx])
        if ring_id < 0:
            continue
        if ring_id in seen:
            col_id += 1
            seen.clear()
            if col_id == 12:
                col_id = 0
                packet_id += 1
        seen.add(ring_id)
        out[idx] = packet_id
    return out


def llu_to_ecef(llu: np.ndarray) -> np.ndarray:
    """(lon, lat, alt) degrees/meters -> ECEF (reference :123-138)."""
    a = 6378137.0
    b = 6356752.314
    lon = llu[0] * np.pi / 180.0
    lat = llu[1] * np.pi / 180.0
    alt = llu[2]
    n = a * a / np.sqrt(a * a * np.cos(lat) ** 2 + b * b * np.sin(lat) ** 2)
    return np.array([
        (n + alt) * np.cos(lat) * np.cos(lon),
        (n + alt) * np.cos(lat) * np.sin(lon),
        (b * b / (a * a) * n + alt) * np.sin(lat)])


def ecef_to_enu(origin_llu: np.ndarray, ecef: np.ndarray) -> np.ndarray:
    """ECEF -> local ENU around origin (reference :141-174)."""
    oxyz = llu_to_ecef(origin_llu)
    d = ecef - oxyz
    lon = origin_llu[0] * np.pi / 180.0
    lat = origin_llu[1] * np.pi / 180.0
    return np.array([
        -np.sin(lon) * d[0] + np.cos(lon) * d[1],
        -np.sin(lat) * np.cos(lon) * d[0] - np.sin(lat) * np.sin(lon) * d[1]
        + np.cos(lat) * d[2],
        np.cos(lat) * np.cos(lon) * d[0] + np.cos(lat) * np.sin(lon) * d[1]
        + np.sin(lat) * d[2]])


def nwu_pose_from_gps(llu: np.ndarray, ypr_deg: np.ndarray,
                      init_llu: np.ndarray,
                      init_enu: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """GPS LLU + yaw/pitch/roll -> NWU pose (reference :460-492).

    Returns (pose (4, 4), enu position) -- pass the first enu back as
    `init_enu` for subsequent calls.
    """
    yaw, pitch, roll = np.deg2rad(ypr_deg)
    # R_enu = Rz(-yaw) Ry(pitch) Rx(roll)
    r_enu = rot_ops.np_euler_to_mat(np.array([[roll, pitch, -yaw]]))[0]
    ecef = llu_to_ecef(llu)
    enu = ecef_to_enu(init_llu, ecef)
    if init_enu is None:
        init_enu = enu
    pose = np.eye(4)
    pose[:3, 3] = enu - init_enu
    pose[:3, :3] = r_enu
    enu_to_nwu = np.array([[0.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    return enu_to_nwu @ pose @ np.linalg.inv(enu_to_nwu), enu


def decode_inspvax(raw: bytes) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Best-effort novatel_msgs/INSPVAX decode.

    Layout follows the novatel_span_driver message definition (std Header +
    novatel common header + int32 status/type + float64 lat/lon/alt ...).
    Returns (stamp_seconds, llu (lon, lat, alt), ypr_degrees) or None.
    Validated offsets may need adjustment against real UrbanLoco bags.
    """
    try:
        offset = 0
        (_seq, secs, nsecs) = struct.unpack_from("<III", raw, offset)
        offset += 12
        (frame_len,) = struct.unpack_from("<I", raw, offset)
        offset += 4 + frame_len
        # novatel CommonHeader: message_name (string), port (string),
        # sequence_num u32, percent_idle_time f32, gps_week_num u32,
        # gps_seconds f64, receiver_status u32, reserved u32, sw_version u32
        for _ in range(2):  # two strings
            (s_len,) = struct.unpack_from("<I", raw, offset)
            offset += 4 + s_len
        offset += 4 + 4 + 4 + 8 + 4 + 4 + 4
        offset += 8  # ins_status int32 + position_type int32
        latitude, longitude, altitude = struct.unpack_from("<ddd", raw, offset)
        offset += 24
        offset += 4  # undulation float32
        offset += 24  # north/east/up velocities float64 x3
        roll, pitch, azimuth = struct.unpack_from("<ddd", raw, offset)
        stamp = secs + nsecs * 1e-9
        return stamp, np.array([longitude, latitude, altitude]), \
            np.array([azimuth, pitch, roll])
    except (struct.error, IndexError):
        return None


class Acquisition(Enum):
    HONG_KONG = 0
    CALIFORNIA = 1


SEQNAME_TO_FILENAME = {
    "CABayBridge": "CA-20190828151211_blur_align.bag",
    "CAMarketStreet": "CA-20190828155828_blur_align.bag",
    "CARussianHill": "CA-20190828173350_blur_align.bag",
    "CAChinaTown": "CA-20190828180248_blur_align.bag",
    "CAColiTower": "CA-20190828184706_blur_align.bag",
    "CAGoldenBridge": "CA-20190828190411_blur_align.bag",
    "HK-Data20190426-2": "20190331WH.bag",
    "HK-Data20190426-1": "20190331HH.bag",
    "HK-Data20190316-2": "20190331_NJ_LL.bag",
    "HK-Data20190316-1": "20190331_NJ_SL.bag",
}

SEQNAME_TO_ACQUISITION = {
    name: (Acquisition.CALIFORNIA if name.startswith("CA")
           else Acquisition.HONG_KONG) for name in SEQNAME_TO_FILENAME
}


class UrbanLocoDataset(RosbagDataset):
    """Rosbag sequence with azimuth-synchronized frame re-cutting: residual
    points past the cut azimuth are carried into the next frame so that every
    emitted frame covers one full revolution (reference :257-340)."""

    def __init__(self, config: RosbagConfig, acquisition: Acquisition,
                 file_path: str, absolute_gt_poses: Optional[np.ndarray] = None,
                 synchronise_azimuth: bool = True, azimuth_bin: int = -179):
        super().__init__(config, file_path)
        self.acquisition = acquisition
        self.synchronise_azimuth = synchronise_azimuth
        self.azimuth_bin = azimuth_bin
        self.absolute_gt_poses = absolute_gt_poses
        self._carry: Optional[np.ndarray] = None
        self._frame_counter = 0

    @staticmethod
    def inspvax_topic() -> str:
        return "/novatel_data/inspvax"

    def _frames(self):
        for data_dict in super()._frames():
            key = self.topic_mapping[self.config.main_topic]
            pc = data_dict.get(key)
            if pc is None:
                yield data_dict
                continue
            if self.synchronise_azimuth:
                if self._carry is not None:
                    pc = np.concatenate([self._carry, pc])
                azimuths = (np.arctan2(pc[:, 1], pc[:, 0]) * 180 / np.pi) \
                    .astype(np.int64)
                hits = np.nonzero(azimuths == self.azimuth_bin)[0]
                cut = None
                min_points = pc.shape[0] // 2
                for h in hits:
                    if h > min_points:
                        cut = int(h)
                        break
                if cut is None:
                    self._carry = pc
                    continue
                frame_pc, self._carry = pc[:cut], pc[cut:]
            else:
                frame_pc = pc
            out = dict(data_dict)
            out[key] = frame_pc
            if self.absolute_gt_poses is not None and \
                    self._frame_counter < len(self.absolute_gt_poses):
                out["absolute_pose_gt"] = self.absolute_gt_poses[self._frame_counter]
            self._frame_counter += 1
            yield out


@dataclass
class UrbanLocoConfig(DatasetConfig):
    dataset: str = "urban_loco"
    root_dir: str = MISSING
    lidar_height: int = 32
    lidar_width: int = 720
    up_fov: float = 25
    down_fov: float = -25
    train_sequences: List[str] = field(default_factory=lambda: list(SEQNAME_TO_FILENAME))
    test_sequences: List[str] = field(default_factory=list)
    eval_sequences: List[str] = field(default_factory=list)


class UrbanLocoDatasetLoader(DatasetLoader):
    @classmethod
    def max_num_workers(cls) -> int:
        return 1

    def __init__(self, config: UrbanLocoConfig):
        if not isinstance(config, UrbanLocoConfig):
            config = dataclass_from_dict(UrbanLocoConfig, config)
        super().__init__(config)
        self.root_dir = Path(str(config.root_dir))
        assert_debug(self.root_dir.exists(),
                     f"UrbanLoco root {self.root_dir} missing")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def groundtruth_filename(self, sequence: str) -> str:
        assert_debug(sequence in SEQNAME_TO_FILENAME,
                     f"Unknown UrbanLoco sequence {sequence}")
        return f"{sequence}.poses.txt"

    def _rosbag_config(self, sequence: str) -> RosbagConfig:
        acquisition = SEQNAME_TO_ACQUISITION[sequence]
        main_topic = ("/velodyne_points" if acquisition == Acquisition.CALIFORNIA
                      else "/velodyne_points_0")
        return dataclass_from_dict(RosbagConfig, {
            "dataset": "rosbag",
            "file_path": str(self.root_dir / SEQNAME_TO_FILENAME[sequence]),
            "main_topic": main_topic,
            "frame_size": 1,
            "numpy_pc_key": self.config.numpy_pc_key,
        })

    def _make(self, sequences):
        if not sequences:
            return None
        datasets = []
        for seq in sequences:
            gt = None
            gt_file = self.root_dir / self.groundtruth_filename(seq)
            if gt_file.exists():
                gt = np.loadtxt(str(gt_file)).reshape(-1, 3, 4)
                gt = np.concatenate([gt, np.tile([[[0, 0, 0, 1.0]]],
                                                 (len(gt), 1, 1))], axis=1)
            cfg = self._rosbag_config(seq)
            datasets.append(UrbanLocoDataset(
                cfg, SEQNAME_TO_ACQUISITION[seq], cfg.file_path,
                absolute_gt_poses=gt))
        return datasets

    def sequences(self):
        cfg = self.config
        return ((self._make(cfg.train_sequences), cfg.train_sequences),
                (self._make(cfg.eval_sequences), cfg.eval_sequences),
                (self._make(cfg.test_sequences), cfg.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        gt_file = self.root_dir / self.groundtruth_filename(sequence_name)
        if gt_file.exists():
            gt = np.loadtxt(str(gt_file)).reshape(-1, 3, 4)
            gt = np.concatenate([gt, np.tile([[[0, 0, 0, 1.0]]],
                                             (len(gt), 1, 1))], axis=1)
            return compute_relative_poses(gt)
        return None

    def generate_ground_truth(self, sequences: List[str]):
        """Walks each bag, converts INSPVAX GPS poses to ENU/NWU LiDAR poses,
        interpolates onto scan timestamps, writes <seq>.poses.txt
        (reference :432+, driven by scripts/generate_urban_loco_gt.py)."""
        for sequence in sequences:
            bag_path = self.root_dir / SEQNAME_TO_FILENAME[sequence]
            if not bag_path.exists():
                logger.warning("Missing rosbag %s", bag_path)
                continue
            acquisition = SEQNAME_TO_ACQUISITION[sequence]
            cfg = self._rosbag_config(sequence)
            span_to_lidar = (CALIFORNIA_EXT_TO_LIDAR
                             if acquisition == Acquisition.CALIFORNIA
                             else HK_SPAN_TO_LIDAR)

            gps_times, gps_poses = [], []
            scan_times = []
            init_llu, init_enu = None, None
            reader = BagReader(str(bag_path))
            for topic, msg_type, time_ns, raw in reader.messages(
                    topics=[cfg.main_topic, self.inspvax_topic()]):
                if "INSPVAX" in msg_type.upper() or "inspvax" in topic:
                    decoded = decode_inspvax(raw)
                    if decoded is None:
                        continue
                    stamp, llu, ypr = decoded
                    if init_llu is None:
                        init_llu = llu
                    pose, enu = nwu_pose_from_gps(llu, ypr, init_llu, init_enu)
                    if init_enu is None:
                        init_enu = enu
                    gps_times.append(stamp)
                    gps_poses.append(pose)
                elif "PointCloud2" in msg_type:
                    scan_times.append(time_ns * 1e-9)

            if len(gps_poses) < 2 or not scan_times:
                logger.warning("Not enough GPS poses in %s", bag_path)
                continue
            interp = PosesInterpolator(np.stack(gps_poses), np.array(gps_times))
            lidar_poses = interp(np.array(scan_times))
            lidar_poses = np.linalg.inv(lidar_poses[0]) @ lidar_poses
            lidar_poses = lidar_poses @ span_to_lidar
            out = lidar_poses[:, :3, :4].reshape(len(lidar_poses), 12)
            np.savetxt(str(self.root_dir / self.groundtruth_filename(sequence)),
                       out)

    @staticmethod
    def inspvax_topic() -> str:
        return UrbanLocoDataset.inspvax_topic()
