"""The SLAM orchestrator: Initialization -> Preprocessing -> Odometry ->
Loop Closure -> Backend (port of ``pylidar_slam_tpu.slam.slam``).

Composes the five modules from a ``SLAMConfig`` and drives them per frame
over the ``data_dict`` key protocol.  The float64 absolute-pose ledger with
rotation re-projection lives here; device state stays inside each module.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_absolute_poses, write_csv
from pylidar_slam_tpu_torch.slam.initialization import INITIALIZATION
from pylidar_slam_tpu_torch.slam.odometry import ODOMETRY
from pylidar_slam_tpu_torch.slam.preprocessing import Preprocessing
from pylidar_slam_tpu_torch.utils import assert_debug


@dataclass
class SLAMConfig:
    initialization: Optional[Any] = None
    preprocessing: Optional[Any] = None
    odometry: Optional[Any] = None
    loop_closure: Optional[Any] = None
    backend: Optional[Any] = None


def _is_none_config(cfg) -> bool:
    """True for absent configs and for explicit `type: none` group choices."""
    if cfg is None:
        return True
    if isinstance(cfg, dict):
        return cfg.get("type", None) in ("none", None) and "filters" not in cfg
    return False


def _reproject_rotation(pose: np.ndarray) -> np.ndarray:
    """Float64 + SO(3) re-projection of the rotation block (SVD)."""
    pose = pose.astype(np.float64)
    u, _, vt = np.linalg.svd(pose[:3, :3])
    d = np.diag([1.0, 1.0, np.linalg.det(u @ vt)])
    pose[:3, :3] = u @ d @ vt
    return pose


def _host(value) -> np.ndarray:
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _config_field(cfg, name, default=None):
    if isinstance(cfg, dict):
        return cfg.get(name, default)
    return getattr(cfg, name, default) if cfg is not None else default


class SLAM:
    """Drives the five pipeline modules over the data_dict protocol.

    kwargs (``projector``, ``pose``, ``device``) go to every module."""

    def __init__(self, config: SLAMConfig, **kwargs):
        if not isinstance(config, SLAMConfig):
            config = dataclass_from_dict(SLAMConfig, config)
        self.config = config
        self.initialization = None
        self.preprocessing = None
        self.odometry = None
        self.loop_closure = None
        self.backend = None
        self._frame_idx = 0

        self.elapsed_odometry = []
        self.elapsed_loop_closure = []
        self.elapsed_backend = []
        # Batched odometry: frames whose pose arrives with a later device
        # flush wait here as (frame_idx, data_dict); their downstream stages
        # (loop closure, backend) run when the odometry hands over the
        # batch's poses -- the same constraints as at batch size 1.
        self._deferred_frames: list = []
        self.__kwargs = kwargs

    def init(self):
        """(Re)initializes all modules at the start of a sequence."""
        self._frame_idx = 0
        cfg = self.config

        self.initialization = None
        if not _is_none_config(cfg.initialization):
            self.initialization = INITIALIZATION.load(cfg.initialization, **self.__kwargs)
            if self.initialization is not None:
                self.initialization.init()

        self.preprocessing = None
        if cfg.preprocessing is not None:
            self.preprocessing = Preprocessing(cfg.preprocessing, **self.__kwargs)

        if self.odometry is None:
            assert_debug(cfg.odometry is not None, "A SLAM requires an odometry config")
            self.odometry = ODOMETRY.load(cfg.odometry, **self.__kwargs)
        self.odometry.init()

        if self.loop_closure is None and not _is_none_config(cfg.loop_closure):
            from pylidar_slam_tpu_torch.slam.loop_closure import LOOP_CLOSURE
            self.loop_closure = LOOP_CLOSURE.load(cfg.loop_closure, **self.__kwargs)
        if self.loop_closure is not None:
            self.loop_closure.init()
            if not _is_none_config(cfg.backend):
                from pylidar_slam_tpu_torch.slam.backend import BACKEND
                self.backend = BACKEND.load(cfg.backend, **self.__kwargs)
            if self.backend is not None:
                self.backend.init()
            else:
                logging.warning("[SLAM] Loop closure configured without a backend")

        # Batched odometry chains constant-velocity priors on the device and
        # never reads per-frame `init_rpose`: an initialization computing
        # real per-frame priors (EI, PoseNet) would be silently ignored.
        batch_size = int(_config_field(cfg.odometry, "batch_size", 1) or 1)
        init_type = _config_field(cfg.initialization, "type")
        if batch_size > 1 and init_type in ("ei", "posenet"):
            raise ValueError(
                f"slam.odometry.batch_size={batch_size} ignores per-frame "
                f"initialization priors; initialization '{init_type}' "
                f"computes real priors that would be silently dropped. Use "
                f"batch_size=1 or initialization CV/NI.")

        self._deferred_frames = []
        # Batched odometry hands per-frame poses over (one host copy per
        # flush) only when a downstream stage consumes them.
        if hasattr(self.odometry, "emit_batch_poses"):
            self.odometry.emit_batch_poses = (
                self.loop_closure is not None or self.backend is not None)

    def host_prepare(self, data_dict: dict):
        """Order-independent host-side stages, safe in prefetch workers: the
        stateless preprocessing filters, the batched odometry's upload
        encoding and the loop closure's per-frame grid sample.  Stateful
        stages still run in frame order in :meth:`process_next_frame`."""
        if self.preprocessing is not None:
            if not self.preprocessing.worker_safe:
                # stateful preprocessing (Distortion reads the init prior)
                # waits for process_next_frame, and so does everything that
                # consumes its output
                return
            self.preprocessing.forward(data_dict)
            data_dict["_host_prepared"] = True
        odom = self.odometry
        raw = data_dict.get(getattr(odom.config, "data_key", None))
        arr = None
        if raw is not None and not isinstance(raw, torch.Tensor):
            a = np.asarray(raw)
            if a.ndim == 2 and a.shape[1] >= 3:
                arr = a
        if (arr is not None
                and getattr(odom, "encode_upload", None) is not None
                and int(getattr(odom.config, "batch_size", 1) or 1) > 1
                and getattr(odom, "_mode", "") in ("aggregated_local_map",
                                                   "kdtree_local_map")):
            data_dict["encoded_upload"] = odom.encode_upload(arr)
        if arr is not None and self.loop_closure is not None and \
                hasattr(self.loop_closure, "_subsample"):
            # the cloud the odometry hands downstream (meters, after
            # preprocessing), grid-sampled here in the worker
            data_dict["lc_pointcloud_sampled"] = self.loop_closure._subsample(
                arr[:, :3].astype(np.float32, copy=False),
                self.loop_closure.config.icp_num_points)

    def process_next_frame(self, data_dict: dict):
        beginning = time.time()

        if self.initialization is not None:
            self.initialization.next_frame(data_dict)
        if self.preprocessing is not None and \
                not data_dict.pop("_host_prepared", False):
            self.preprocessing.forward(data_dict)

        self.odometry.process_next_frame(data_dict)
        step_odometry = time.time()
        self.elapsed_odometry.append(step_odometry - beginning)

        pose_key = self.odometry.relative_pose_key()
        if pose_key in data_dict:
            odometry_pose = data_dict[pose_key]
            if self.initialization is not None:
                # CV feeds the device tensor straight back into the next step
                self.initialization.save_real_motion(odometry_pose, data_dict)
            if self.loop_closure is not None or self.backend is not None:
                # fetched to the host only when a downstream stage needs it
                odometry_pose = _reproject_rotation(_host(odometry_pose))
            else:
                odometry_pose = None
            self._run_downstream(odometry_pose, data_dict, self._frame_idx, step_odometry)
        elif self.loop_closure is not None or self.backend is not None:
            # batched odometry: the pose arrives with a later flush
            self._deferred_frames.append((self._frame_idx, data_dict))
            self._drain_deferred()

        self._frame_idx += 1

    def _run_downstream(self, odometry_pose: Optional[np.ndarray],
                        data_dict: dict, frame_idx: int, step_odometry: float):
        """Loop closure + backend for one frame with a known odometry pose."""
        if self.loop_closure is not None:
            if odometry_pose is not None:
                data_dict[self.loop_closure.relative_pose_key()] = odometry_pose
            pc_key = self.odometry.pointcloud_key()
            if "lc_pointcloud_sampled" in data_dict:
                data_dict[self.loop_closure.pointcloud_key()] = \
                    data_dict["lc_pointcloud_sampled"]
            elif pc_key in data_dict:
                value = _host(data_dict[pc_key])
                if value.ndim == 3:  # (H, W, 3) vertex map -> point list
                    value = value.reshape(-1, 3)
                    value = value[np.abs(value).max(axis=1) > 0]
                data_dict[self.loop_closure.pointcloud_key()] = value
            self.loop_closure.process_next_frame(data_dict)
            self.elapsed_loop_closure.append(time.time() - step_odometry)

        if self.backend is not None:
            if odometry_pose is not None:
                data_dict[self.backend.se3_odometry_constraint(frame_idx - 1)] = \
                    (odometry_pose, None)
            init_step = time.time()
            self.backend.next_frame(data_dict)
            step_backend = time.time()
            if self.backend.need_to_update_pose:
                self.loop_closure.update_positions(self.backend.absolute_poses())
                self.backend.need_to_update_pose = False
            self.elapsed_backend.append(step_backend - init_step)

    def _drain_deferred(self, final: bool = False):
        """Runs the downstream stages of deferred frames whose batched
        odometry poses have reached the host (the constraint stream of
        batch size 1)."""
        if not hasattr(self.odometry, "drain_batch_results"):
            return
        for rpose in self.odometry.drain_batch_results(final=final):
            assert_debug(len(self._deferred_frames) > 0,
                         "Drained more batched poses than deferred frames")
            frame_idx, data_dict = self._deferred_frames.pop(0)
            data_dict[self.odometry.relative_pose_key()] = rpose
            if self.initialization is not None:
                self.initialization.save_real_motion(rpose, data_dict)
            self._run_downstream(_reproject_rotation(np.asarray(rpose)), data_dict,
                                 frame_idx, time.time())

    def finish(self):
        """Flushes batched odometry state at the sequence's end, completes
        the downstream stages of still-deferred frames and registers the
        candidate matches still in flight."""
        if hasattr(self.odometry, "finish"):
            self.odometry.finish()
        self._drain_deferred(final=True)
        if self.loop_closure is not None and \
                getattr(self.loop_closure, "_pending_matches", None):
            late = {}
            self.loop_closure.drain_pending(late)
            if late and self.backend is not None:
                self.backend.next_frame(late)
                if self.backend.need_to_update_pose:
                    self.loop_closure.update_positions(self.backend.absolute_poses())
                    self.backend.need_to_update_pose = False

    def get_relative_poses(self):
        if self.backend is not None:
            return self.backend.relative_odometry_poses()
        return self.odometry.get_relative_poses()

    def get_absolute_poses(self):
        if self.backend is not None:
            return self.backend.absolute_poses()
        return compute_absolute_poses(self.odometry.get_relative_poses())

    # -- constraint dump -----------------------------------------------------

    def dump_all_constraints(self, log_dir: str):
        if self.backend is None:
            return
        dir_path = Path(log_dir)
        dir_path.mkdir(parents=True, exist_ok=True)
        self.save_constraints(
            [(c[0], c[0] + 1, c[1]) for c in self.backend.registered_odometry_constraints()],
            str(dir_path / "odometry_constraints.txt"))
        self.save_constraints(
            [(c[0], c[0], c[1]) for c in self.backend.registered_absolute_constraints()],
            str(dir_path / "absolute_constraints.txt"))
        self.save_constraints(
            [(c[0], c[1], c[2]) for c in self.backend.registered_loop_constraints()],
            str(dir_path / "loop_constraints.txt"))

    @staticmethod
    def save_constraints(constraints, file_path: str):
        """(src, tgt, 4x4) rows in pandas' indexed CSV layout: a leading
        row-number column, then src, tgt and the 16 matrix entries."""
        rows = [(k, int(c[0]), int(c[1]),
                 *np.asarray(c[2], np.float64).flatten().tolist())
                for k, c in enumerate(constraints)]
        write_csv(file_path, ["", "src", "tgt", *[str(i) for i in range(16)]], rows)

    @staticmethod
    def load_constraints(file_path: str):
        """The rows of :meth:`save_constraints` (row number first)."""
        data = np.loadtxt(file_path, delimiter=",", skiprows=1, ndmin=2)
        return data.tolist()
