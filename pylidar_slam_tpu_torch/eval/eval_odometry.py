"""Trajectory evaluation: KITTI relative errors and ATE (numpy port of
``pylidar_slam_tpu.eval.eval_odometry``, numerically identical).

* KITTI metric: per-(start, segment in {100..800 m}) windows over cumulative
  GT arc length, pose error inv(delta_traj) @ delta_gt, rotation via
  trace-acos, translation norm, averaged.
* ATE: mean +- std of per-frame relative translation differences.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

DEFAULT_SEGMENTS = [100, 200, 300, 400, 500, 600, 700, 800]


def shift_poses(poses: np.ndarray) -> np.ndarray:
    shifted = poses[:-1, :4, :4]
    return np.concatenate([np.expand_dims(np.eye(4), axis=0), shifted], axis=0)


def compute_relative_poses(poses: np.ndarray) -> np.ndarray:
    return np.linalg.inv(shift_poses(poses)) @ poses


def compute_absolute_poses(relative_poses: np.ndarray) -> np.ndarray:
    absolute = relative_poses.copy()
    for i in range(absolute.shape[0] - 1):
        absolute[i + 1] = absolute[i] @ relative_poses[i + 1]
    return absolute


def compute_cumulative_trajectory_length(trajectory: np.ndarray) -> np.ndarray:
    shifted = shift_poses(trajectory)
    lengths = np.linalg.norm(shifted[:, :3, 3] - trajectory[:, :3, 3], axis=1)
    return np.cumsum(lengths)


def rotation_error(pose_err: np.ndarray) -> np.ndarray:
    d = 0.5 * (pose_err[..., 0, 0] + pose_err[..., 1, 1] + pose_err[..., 2, 2] - 1.0)
    return np.arccos(np.clip(d, -1.0, 1.0))


def translation_error(pose_err: np.ndarray) -> np.ndarray:
    return np.linalg.norm(pose_err[..., :3, 3], axis=-1)


def last_frame_from_segment_length(dist: np.ndarray, first_frame: int,
                                   segment: float) -> int:
    for i in range(first_frame, len(dist)):
        if dist[i] > dist[first_frame] + segment:
            return i
    return -1


def calc_sequence_errors(trajectory: np.ndarray, ground_truth: np.ndarray,
                         all_segments=DEFAULT_SEGMENTS,
                         step_size: int = 10) -> List[dict]:
    dist = compute_cumulative_trajectory_length(ground_truth)
    errors = []
    for first_frame in range(0, ground_truth.shape[0], step_size):
        for segment_len in all_segments:
            last_frame = last_frame_from_segment_length(dist, first_frame, segment_len)
            if last_frame == -1:
                continue
            delta_gt = np.linalg.inv(ground_truth[first_frame]) @ ground_truth[last_frame]
            delta_traj = np.linalg.inv(trajectory[first_frame]) @ trajectory[last_frame]
            pose_err = np.linalg.inv(delta_traj) @ delta_gt
            num_frames = last_frame - first_frame + 1
            errors.append({
                "tr_err": float(translation_error(pose_err)) / segment_len,
                "r_err": float(rotation_error(pose_err)) / segment_len,
                "segment": segment_len,
                "speed": segment_len / (0.1 * num_frames),
                "first_frame": first_frame,
                "last_frame": last_frame,
            })
    return errors


def compute_kitti_metrics(trajectory: np.ndarray, ground_truth: np.ndarray,
                          segments_sizes=DEFAULT_SEGMENTS) -> tuple:
    """(tr_err, rot_err, per-window errors) over absolute trajectories;
    (None, None, []) when no segment fits."""
    errors = calc_sequence_errors(trajectory, ground_truth, segments_sizes)
    if len(errors) > 0:
        tr_err = sum(e["tr_err"] for e in errors) / len(errors)
        rot_err = sum(e["r_err"] for e in errors) / len(errors)
        return tr_err, rot_err, errors
    return None, None, []


def compute_ate(relative_predicted: np.ndarray,
                relative_ground_truth: np.ndarray) -> Tuple[float, float]:
    tr_err = np.linalg.norm(relative_predicted[:, :3, 3]
                            - relative_ground_truth[:, :3, 3], axis=1)
    ate = tr_err.mean()
    std_dev = np.sqrt(np.power(tr_err - ate, 2).mean())
    return float(ate), float(std_dev)
