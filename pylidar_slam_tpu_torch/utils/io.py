"""Pose-file IO (torch port of ``pylidar_slam_tpu.utils.io``), without
pandas (the card's machine has none).

Poses persist as CSV rows of the flattened first 3 rows of the 4x4 matrix
(the KITTI poses layout) under a ``0,...,11`` header: the bytes of pandas'
``DataFrame.to_csv(index=False)``, which the JAX package writes, and which
its ``read_poses_from_disk`` reads.  Plain-text KITTI ``poses.txt`` helpers
too.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from pylidar_slam_tpu_torch.eval.eval_odometry import write_poses
from pylidar_slam_tpu_torch.utils import assert_debug, check_tensor


def delimiter() -> str:
    return ","


def rows_to_poses(array: np.ndarray) -> np.ndarray:
    """(N, 12) flattened 3x4 rows -> (N, 4, 4) float64 poses."""
    array = np.asarray(array, np.float64).reshape(len(array), -1)
    assert_debug(array.shape[1] == 12, f"Expected 12 columns, got {array.shape}")
    n = array.shape[0]
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (n, 1, 1))
    return np.concatenate([array.reshape(n, 3, 4), bottom], axis=1)


def write_poses_to_disk(file_path: str, poses: np.ndarray):
    check_tensor(poses, [-1, 4, 4])
    assert_debug(Path(file_path).parent.exists(), f"Parent dir of {file_path} missing")
    write_poses(file_path, poses)


def read_poses_from_disk(file_path: str, _delimiter: str = ",") -> np.ndarray:
    path = Path(file_path)
    assert_debug(path.exists() and path.is_file(), f"Missing {file_path}")
    flat = np.loadtxt(path, delimiter=_delimiter, skiprows=1, dtype=np.float64, ndmin=2)
    return rows_to_poses(flat)


def write_kitti_poses(file_path: str, poses: np.ndarray):
    """Space-separated KITTI poses.txt (no header)."""
    check_tensor(poses, [-1, 4, 4])
    np.savetxt(file_path, poses[:, :3, :].reshape(len(poses), 12))


def read_kitti_poses(file_path: str) -> np.ndarray:
    return rows_to_poses(np.loadtxt(file_path).reshape(-1, 12))
