"""Trajectory evaluation: KITTI relative errors, ATE/ARE and the results
files (numpy port of ``pylidar_slam_tpu.eval.eval_odometry``, numerically
identical).

* KITTI metric: per-(start, segment in {100..800 m}) windows over cumulative
  GT arc length, pose error inv(delta_traj) @ delta_gt, rotation via
  trace-acos, translation norm, averaged.
* ATE/ARE: mean +- std of per-frame relative translation/rotation diffs.
* ``OdometryResults`` writes ``metrics.yaml`` and the ``poses.txt`` files
  without PyYAML or pandas, in the layouts those libraries write; the
  trajectory plots need matplotlib and are not drawn (ROADMAP.md A.19).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from pylidar_slam_tpu_torch.config import dump_yaml
from pylidar_slam_tpu_torch.utils import assert_debug, check_tensor

logger = logging.getLogger(__name__)

DEFAULT_SEGMENTS = [100, 200, 300, 400, 500, 600, 700, 800]


def list_poses_to_poses_array(poses_list: list) -> np.ndarray:
    return np.concatenate([np.expand_dims(p, axis=0) for p in poses_list], axis=0)


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


def compute_are(relative_trajectory: np.ndarray,
                relative_ground_truth: np.ndarray) -> Tuple[float, float]:
    diff = np.linalg.inv(relative_ground_truth[:, :3, :3]) @ \
        relative_trajectory[:, :3, :3] - np.eye(3)
    r_err = np.linalg.norm(diff, axis=(1, 2))
    are = r_err.mean()
    std_dev = np.sqrt(np.power(r_err - are, 2).mean())
    return float(are), float(std_dev)


def rescale_prediction(sequence_pred: np.ndarray,
                       sequence_gt: np.ndarray) -> np.ndarray:
    """Scale-aligns per-frame translations (for scale-free deep odometry)."""
    check_tensor(sequence_pred, [-1, 4, 4])
    check_tensor(sequence_gt, [-1, 4, 4])
    rescaled = []
    for pred, gt in zip(sequence_pred, sequence_gt):
        norm_pred = np.linalg.norm(pred[:3, -1])
        norm_gt = np.linalg.norm(gt[:3, -1])
        scale = (norm_gt / norm_pred) if norm_pred > 1e-6 else 1.0
        new_pose = pred.copy()
        new_pose[:3, -1] *= scale
        rescaled.append(new_pose)
    return list_poses_to_poses_array(rescaled)


def write_csv(path: str, header: List[str], rows) -> None:
    """Comma-separated rows with a header line, each float in its shortest
    round-trip form: the bytes pandas' ``DataFrame.to_csv`` writes."""
    def cell(v):
        return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(cell(v) for v in row) + "\n")


def write_poses(path: str, poses: np.ndarray) -> None:
    """(N, 4, 4) poses as KITTI's flattened 3x4 rows under a ``0..11``
    header: ``pd.read_csv(path)`` reads them back."""
    flat = np.asarray(poses, np.float64)[:, :3, :4].reshape(-1, 12)
    write_csv(path, [str(i) for i in range(12)], flat.tolist())


class OdometryResults:
    """Aggregates sequence results: metrics.yaml and the poses files."""

    def __init__(self, log_dir: str):
        self.log_dir_path = Path(log_dir)
        self.log_dir_path.mkdir(parents=True, exist_ok=True)
        self.metrics: Dict[str, dict] = {}

    def add_sequence(self, sequence_id: str,
                     relative_prediction: Union[np.ndarray, List],
                     relative_ground_truth: Optional[Union[np.ndarray, List]],
                     elapsed: Optional[float] = None,
                     mode: str = "normal"):
        if isinstance(relative_prediction, list):
            relative_prediction = list_poses_to_poses_array(relative_prediction)
        with_gt = relative_ground_truth is not None
        if with_gt:
            if isinstance(relative_ground_truth, list):
                relative_ground_truth = list_poses_to_poses_array(relative_ground_truth)
            if mode == "rescale_simple":
                relative_prediction = rescale_prediction(relative_prediction,
                                                         relative_ground_truth)
            elif mode == "eval_rotation":
                relative_prediction[:, :3, 3] = relative_ground_truth[:, :3, 3]
            elif mode == "eval_translation":
                relative_prediction[:, :3, :3] = relative_ground_truth[:, :3, :3]
            assert_debug(list(relative_ground_truth.shape) ==
                         list(relative_prediction.shape))

        absolute_pred = compute_absolute_poses(relative_prediction)
        write_poses(str(self.log_dir_path / f"{sequence_id}.poses.txt"), absolute_pred)
        logger.info("Trajectory plots need matplotlib: not drawn (ROADMAP.md A.19)")

        if with_gt:
            absolute_gt = compute_absolute_poses(relative_ground_truth)
            write_poses(str(self.log_dir_path / f"{sequence_id}_gt.poses.txt"), absolute_gt)
            tr_err, rot_err, _ = compute_kitti_metrics(absolute_pred, absolute_gt)
            # ATE/ARE for any length; the KITTI errors need >= 100 m of travel
            ate, std_ate = compute_ate(relative_prediction, relative_ground_truth)
            are, std_are = compute_are(relative_prediction, relative_ground_truth)
            self.metrics[sequence_id] = {"ATE": float(ate), "STD_ATE": float(std_ate),
                                         "ARE": float(are), "STD_ARE": float(std_are)}
            if tr_err is not None and rot_err is not None:
                self.metrics[sequence_id]["tr_err"] = float(tr_err)
                self.metrics[sequence_id]["rot_err"] = float(rot_err)
            if elapsed is not None:
                self.metrics[sequence_id]["nsecs_per_frame"] = \
                    float(elapsed / absolute_gt.shape[0])
            self.save_metrics()

    def _add_mean_metrics(self):
        # each key averaged over the sequences that report it (short
        # sequences carry ATE/ARE but no tr_err/rot_err)
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for seq_id, metrics in self.metrics.items():
            if seq_id != "AVG":
                for key, value in metrics.items():
                    sums[key] = sums.get(key, 0.0) + value
                    counts[key] = counts.get(key, 0) + 1
        if counts:
            self.metrics["AVG"] = {k: sums[k] / counts[k] for k in sums}

    def save_metrics(self, filename: str = "metrics.yaml"):
        (self.log_dir_path / filename).write_text(dump_yaml(self.metrics))

    def close(self):
        self._add_mean_metrics()
        self.save_metrics()
