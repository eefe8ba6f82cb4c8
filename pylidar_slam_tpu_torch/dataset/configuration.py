"""Dataset loader contract (port of ``pylidar_slam_tpu.dataset.configuration``).

A ``DatasetLoader`` exposes ``projector()`` (the dataset-tuned spherical
projector), ``sequences()`` (train/eval/test lists of map-style sequences
emitting ``data_dict``s) and ``get_ground_truth(seq)`` (relative GT poses).
Loaders are numpy; the odometry uploads what it needs.
"""
from __future__ import annotations

from dataclasses import dataclass

from pylidar_slam_tpu_torch.config import MISSING
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection


@dataclass
class DatasetConfig:
    dataset: str = MISSING
    sequence_len: int = 2

    # Default item keys in the data_dict
    vertex_map_key: str = "vertex_map"
    numpy_pc_key: str = "numpy_pc"
    absolute_gt_key: str = "absolute_pose_gt"
    with_numpy_pc: bool = True


class DatasetLoader:
    @classmethod
    def max_num_workers(cls) -> int:
        return 20

    @staticmethod
    def absolute_gt_key() -> str:
        return "absolute_pose_gt"

    @staticmethod
    def numpy_pc_key() -> str:
        return "numpy_pc"

    def __init__(self, config: DatasetConfig):
        self.config = config

    def projector(self) -> SphericalProjection:
        raise NotImplementedError("")

    @property
    def grid_regular(self) -> bool:
        """True iff the sensor fires exactly on the projector's regular grid,
        where the rimg8 upload (mean angular offset planes) is exact.  Real
        sensors' per-beam de-calibration needs per-pixel offsets, so only
        loaders that know their pattern is regular opt in."""
        return False

    def sequences(self):
        """Returns ((train_datasets, names), (eval_datasets, names),
        (test_datasets, names), transform)."""
        raise NotImplementedError("")

    def get_ground_truth(self, sequence_name):
        return None
