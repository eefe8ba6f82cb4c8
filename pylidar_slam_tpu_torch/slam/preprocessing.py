"""Preprocessing filter chain (port of ``pylidar_slam_tpu.slam.preprocessing``).

Filters are applied in key-sorted order over the per-frame ``data_dict``.
Host-side array plumbing stays in numpy; variable-size filter outputs are
fine, the odometry pads what it uploads.

Registered filters: ``distortion`` (slerp de-skew), ``voxelization``
(per-voxel stats), ``grid_sample`` (1 point per voxel), ``to_tensor``
(key rename / device placement).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.ops import se3
from pylidar_slam_tpu_torch.slam.initialization import Initialization
from pylidar_slam_tpu_torch.utils import assert_debug, check_tensor, native

HASH_PRIMES = (73856093, 19349669, 83492791)


def np_voxelise(points: np.ndarray, voxel_size: float) -> np.ndarray:
    return np.round(points / voxel_size).astype(np.int64)


def np_voxel_hash(coords: np.ndarray) -> np.ndarray:
    return (HASH_PRIMES[0] * coords[:, 0] + HASH_PRIMES[1] * coords[:, 1]
            + HASH_PRIMES[2] * coords[:, 2])


def np_grid_sample(points: np.ndarray, voxel_size: float):
    """One point per voxel (first occurrence)."""
    hashes = np_voxel_hash(np_voxelise(points, voxel_size))
    _, indices = np.unique(hashes, return_index=True)
    indices = np.sort(indices)
    return points[indices], indices


def np_voxel_normal_distribution(points: np.ndarray, hashes: np.ndarray):
    """Per-voxel sizes/means/covariances + per-point voxel ids, voxels in
    ascending hash order."""
    uniq, inverse, counts = np.unique(hashes, return_inverse=True,
                                      return_counts=True)
    v = uniq.shape[0]
    sums = np.zeros((v, 3), dtype=np.float64)
    np.add.at(sums, inverse, points.astype(np.float64))
    means = sums / counts[:, None]
    centered = points - means[inverse]
    outer = centered[:, :, None] * centered[:, None, :]
    covs = np.zeros((v, 3, 3), dtype=np.float64)
    np.add.at(covs, inverse, outer)
    return (counts.astype(np.int64), means.astype(points.dtype),
            covs.astype(points.dtype), inverse.astype(np.int64))


# ----------------------------------------------------------------------------
# Filters
# ----------------------------------------------------------------------------

@dataclass
class FilterConfig:
    filter_name: str = MISSING
    input_channel: str = MISSING


class Filter:
    # Filters that read only the frame's own data may run out of frame
    # order in prefetch workers (SLAM.host_prepare); filters that consume
    # upstream per-frame state (the initialization prior) may not.
    worker_safe = True

    def __init__(self, config: FilterConfig, **kwargs):
        # kwargs: pipeline context (projector, pose, device) some filters use
        self.config = config

    def filter(self, data_dict: dict):
        raise NotImplementedError("")


@dataclass
class VoxelizationConfig(FilterConfig):
    filter_name: str = "voxelization"
    input_channel: str = "numpy_pc"
    voxel_covariances_key: str = "voxel_covariances"
    voxel_means_key: str = "voxel_means"
    voxel_size_key: str = "voxel_sizes"
    voxel_indices_key: str = "voxel_indices"
    voxel_hashes_key: str = "voxel_hashes"
    voxel_coordinates_key: str = "voxel_coordinates"
    with_normal_distribution: bool = True
    voxel_size: float = 0.2


class Voxelization(Filter):
    """Voxel stats filter."""

    def filter(self, data_dict: dict):
        cfg = self.config
        assert_debug(cfg.input_channel in data_dict,
                     f"Missing input channel {cfg.input_channel}")
        pc = data_dict[cfg.input_channel]
        check_tensor(pc, [-1, 3], np.ndarray)
        coords = np_voxelise(pc, cfg.voxel_size)
        hashes = np_voxel_hash(coords)
        data_dict[cfg.voxel_hashes_key] = hashes
        data_dict[cfg.voxel_coordinates_key] = coords
        if cfg.with_normal_distribution:
            sizes, means, covs, ids = np_voxel_normal_distribution(pc, hashes)
            data_dict[cfg.voxel_means_key] = means
            data_dict[cfg.voxel_covariances_key] = covs
            data_dict[cfg.voxel_size_key] = sizes
            data_dict[cfg.voxel_indices_key] = ids


@dataclass
class ToTensorConfig(FilterConfig):
    filter_name: str = "to_tensor"
    device: str = "tpu"
    keys: Dict[str, str] = field(default_factory=dict)


class ToTensor(Filter):
    """Key rename + placement of numpy arrays as torch tensors on the
    runner's device."""

    def __init__(self, config: ToTensorConfig, device="cuda", **kwargs):
        super().__init__(config)
        self.device = torch.device(device)

    def filter(self, data_dict: dict):
        for old_key, new_key in (self.config.keys or {}).items():
            assert_debug(old_key in data_dict, f"Missing key {old_key}")
            value = data_dict[old_key]
            if isinstance(value, np.ndarray):
                value = torch.as_tensor(value, device=self.device)
            data_dict[new_key] = value


@dataclass
class DistortionConfig(FilterConfig):
    filter_name: str = "distortion"
    pointcloud_key: str = "numpy_pc"
    timestamps_key: str = "numpy_pc_timestamps"
    pose_key: str = Initialization.initial_pose_key()
    output_key: str = "input_data"
    force: bool = False
    activate: bool = True


class Distortion(Filter):
    """Motion de-skew: each point moved by the slerp of the initial pose at
    its timestamp's fraction of the sweep (``se3.interpolate_pose`` and
    ``se3.warp_points``, on the host: input and output are numpy)."""

    worker_safe = False  # reads the initialization prior (pose_key)

    def filter(self, data_dict: dict):
        cfg = self.config
        pc = data_dict[cfg.pointcloud_key]
        check_tensor(pc, [-1, 3], np.ndarray)

        no_distortion = (not cfg.activate) or (cfg.timestamps_key not in data_dict)
        no_distortion = no_distortion or (
            data_dict.get(cfg.pose_key, None) is None
            if cfg.pose_key in data_dict else False)
        if no_distortion:
            if cfg.force and cfg.timestamps_key not in data_dict:
                assert_debug(False, f"Missing timestamps key {cfg.timestamps_key}")
            data_dict[cfg.output_key] = pc
            return

        rpose = data_dict[cfg.pose_key]
        rpose = rpose.cpu() if isinstance(rpose, torch.Tensor) else np.asarray(rpose)
        check_tensor(rpose, [4, 4])
        timestamps = np.asarray(data_dict[cfg.timestamps_key]).reshape(-1)
        check_tensor(timestamps, [pc.shape[0]])

        diff = timestamps.max() - timestamps.min()
        alphas = (np.zeros_like(timestamps) if diff == 0.0
                  else (timestamps - timestamps.min()) / diff)
        rots, trs = se3.interpolate_pose(torch.as_tensor(rpose, dtype=torch.float32),
                                         torch.as_tensor(alphas, dtype=torch.float32))
        points = torch.from_numpy(np.ascontiguousarray(pc, np.float32))
        valid = torch.ones((points.shape[0],), dtype=torch.bool)
        data_dict[cfg.output_key] = se3.warp_points(rots, trs, points, valid).numpy()


@dataclass
class GridSampleConfig(FilterConfig):
    filter_name: str = "grid_sample"
    voxel_size: float = 0.3
    pointcloud_key: str = "numpy_pc"
    output_indices_key: str = "sample_indices"
    output_sample_key: str = "sample_points"


class GridSample(Filter):
    """1 point per voxel subsampling."""

    def filter(self, data_dict: dict):
        cfg = self.config
        pc = data_dict[cfg.pointcloud_key]
        check_tensor(pc, [-1, 3], np.ndarray)
        # the native O(n) hash table, or numpy's unique sweep (same winners)
        keep = native.grid_sample_mask(pc, cfg.voxel_size)
        if keep is not None:
            indices = np.flatnonzero(keep)
            sample = pc[indices]
        else:
            sample, indices = np_grid_sample(pc, cfg.voxel_size)
        data_dict[cfg.output_sample_key] = sample
        data_dict[cfg.output_indices_key] = indices


_FILTERS = {
    "distortion": (Distortion, DistortionConfig),
    "voxelization": (Voxelization, VoxelizationConfig),
    "grid_sample": (GridSample, GridSampleConfig),
    "to_tensor": (ToTensor, ToTensorConfig),
}


def load_filter(config: dict, **kwargs) -> Filter:
    assert_debug("filter_name" in config, f"Filter config misses filter_name: {config}")
    name = config["filter_name"]
    assert_debug(name in _FILTERS, f"Unknown filter {name}")
    cls, cfg_cls = _FILTERS[name]
    return cls(dataclass_from_dict(cfg_cls, config), **kwargs)


@dataclass
class PreprocessingConfig:
    filters: Optional[Dict[str, Any]] = None


class Preprocessing:
    """Applies filters in key-sorted order."""

    def __init__(self, config, **kwargs):
        if not isinstance(config, PreprocessingConfig):
            config = dataclass_from_dict(PreprocessingConfig, config)
        self.config = config
        self.filters = []
        filters_config = self.config.filters
        if isinstance(filters_config, dict):
            for key in sorted(filters_config.keys()):
                self.filters.append(load_filter(dict(filters_config[key]), **kwargs))

    @property
    def worker_safe(self) -> bool:
        return all(getattr(f, "worker_safe", False) for f in self.filters)

    def forward(self, data_dict: dict):
        for f in self.filters:
            f.filter(data_dict)
