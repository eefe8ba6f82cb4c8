"""Generic rosbag dataset (port of ``pylidar_slam_tpu.dataset.rosbag_dataset``):
sequential-access-only iterable over PointCloud2 messages, accumulating
``frame_size`` messages per emitted frame, with a topic->key mapping.

Uses the pure-Python bag reader (rosbag_reader.py); no ROS installation.
Sequential access: ``max_num_workers()`` is 1, so the runner's prefetcher
reads it on one thread, in order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.dataset.rosbag_reader import BagReader, decode_pointcloud2
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.utils import assert_debug


@dataclass
class RosbagConfig(DatasetConfig):
    dataset: str = "rosbag"
    file_path: str = MISSING
    main_topic: str = "velodyne_points"
    accumulate_scans: bool = False
    frame_size: int = 1  # number of PointCloud2 messages per emitted frame
    topic_mapping: Dict[str, str] = field(default_factory=dict)
    lidar_height: int = 64
    lidar_width: int = 720
    up_fov: float = 25.0
    down_fov: float = -25.0


class RosbagDataset:
    """Sequential-access map-style facade over a bag (index must advance by 1,
    mirroring reference rosbag_dataset.py:133)."""

    def __init__(self, config: RosbagConfig, file_path: str):
        self.config = config
        self.file_path = file_path
        self._idx = 0
        self._iterator: Optional[Iterator] = None
        topic_mapping = dict(config.topic_mapping or {})
        if config.main_topic not in topic_mapping:
            topic_mapping[config.main_topic] = config.numpy_pc_key
        self.topic_mapping = topic_mapping
        self._frames_cache: Optional[int] = None

    def _frames(self) -> Iterator[dict]:
        reader = BagReader(self.file_path)
        main_key = self.topic_mapping[self.config.main_topic]
        accumulated: List[np.ndarray] = []
        times: List[np.ndarray] = []
        for topic, msg_type, time_ns, raw in reader.messages(
                topics=list(self.topic_mapping)):
            if "PointCloud2" not in msg_type:
                continue
            decoded = decode_pointcloud2(raw)
            xyz = decoded.get("xyz")
            if xyz is None:
                continue
            key = self.topic_mapping[topic]
            if topic != self.config.main_topic:
                yield {key: xyz}
                continue
            accumulated.append(xyz)
            ts = decoded.get("t", decoded.get("time",
                                              np.full(len(xyz), float(time_ns))))
            times.append(np.asarray(ts, np.float64).reshape(-1))
            if len(accumulated) >= max(int(self.config.frame_size), 1):
                pc = np.concatenate(accumulated)
                tstamps = np.concatenate(times)
                accumulated, times = [], []
                span = max(tstamps.max() - tstamps.min(), 1.0)
                data_dict = {
                    main_key: pc,
                    f"{main_key}_timestamps": (tstamps - tstamps.min()) / span,
                }
                yield data_dict

    def __len__(self):
        if self._frames_cache is None:
            # one full pass to count frames (cached)
            self._frames_cache = sum(1 for _ in self._frames())
        return self._frames_cache

    def __getitem__(self, idx) -> dict:
        assert_debug(idx == self._idx,
                     f"Rosbag datasets are sequential-access-only "
                     f"(asked {idx}, expected {self._idx})")
        if self._iterator is None:
            self._iterator = self._frames()
        self._idx += 1
        return next(self._iterator)

    def rewind(self):
        self._idx = 0
        self._iterator = None


class RosbagDatasetLoader(DatasetLoader):
    @classmethod
    def max_num_workers(cls) -> int:
        return 1  # sequential access only (reference rosbag_dataset.py:188)

    def __init__(self, config: RosbagConfig):
        if not isinstance(config, RosbagConfig):
            config = dataclass_from_dict(RosbagConfig, config)
        super().__init__(config)
        self.file_path = Path(str(config.file_path))
        assert_debug(self.file_path.exists(),
                     f"Bag file {self.file_path} does not exist")

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(int(cfg.lidar_height), int(cfg.lidar_width),
                                   float(cfg.up_fov), float(cfg.down_fov))

    def sequences(self):
        name = self.file_path.stem
        datasets = [RosbagDataset(self.config, str(self.file_path))]
        return ((datasets, [name]), (None, []), (None, []), lambda x: x)

    def get_ground_truth(self, sequence_name):
        return None
