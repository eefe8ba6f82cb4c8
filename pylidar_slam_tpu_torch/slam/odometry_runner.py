"""SLAM runner: drives the SLAM pipeline over dataset sequences and
evaluates (port of ``pylidar_slam_tpu.slam.odometry_runner``).

Per-sequence frame loop with timing, failure dumping (the partial
trajectory saved on an exception), results + metrics via
``OdometryResults``, and the composed config stamped with the git hash.
Frames are loaded by background threads one step ahead of the device.

The run goes on the card unless ``device=cpu`` is asked for: ``cuda``,
``gpu`` and the shared config's ``tpu`` all name the card, and without one
the runner raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import dataclass_from_dict, dump_yaml
from pylidar_slam_tpu_torch.dataset import DATASET
from pylidar_slam_tpu_torch.eval.eval_odometry import OdometryResults
from pylidar_slam_tpu_torch.slam.slam import SLAM, SLAMConfig
from pylidar_slam_tpu_torch.utils import assert_debug

logger = logging.getLogger(__name__)

# The names of the card in configs: the shared config tree says `tpu`.
_CARD_NAMES = ("cuda", "gpu", "tpu")


def resolve_device(name: Optional[str]) -> torch.device:
    """The torch device a config's `device` names: the CPU only for an
    explicit ``cpu``, else the card (``cuda[:k]``, ``gpu``, ``tpu`` or
    none); raises when the card is asked for and there is none."""
    name = str(name or "cuda").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    base, _, index = name.partition(":")
    if base not in _CARD_NAMES:
        raise ValueError(f"Unknown device '{name}': use cpu or cuda[:index]")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={name} needs a CUDA card and none is available; "
                           f"pass device=cpu to run on the CPU")
    return torch.device("cuda", int(index) if index else torch.cuda.current_device())


@dataclass
class SLAMRunnerConfig:
    slam: Any = None
    dataset: Any = None
    max_num_frames: int = -1
    save_results: bool = True
    pose: str = "euler"
    device: str = "cuda"
    num_workers: int = 2  # prefetch threads (clamped to loader.max_num_workers)
    pin_memory: bool = True  # accepted for CLI compatibility
    log_dir: str = "."
    fail_dir: str = ""
    move_if_fail: bool = False
    eval_mode: str = "normal"
    # the registered map's PLY and rendered views (ROADMAP.md A.19)
    save_map: bool = False
    save_map_voxel_size: float = 0.3


def _git_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


class _Prefetcher:
    """Background frame prefetcher with ordered delivery.

    ``num_workers`` threads load frames concurrently; frames are yielded in
    index order and at most ``depth`` loads run ahead of consumption.
    """

    def __init__(self, dataset, depth: int = 4, max_frames: int = -1,
                 num_workers: int = 1, transform=None):
        self.dataset = dataset
        self.transform = transform
        self.n = len(dataset) if max_frames < 0 else min(len(dataset), max_frames)
        self.num_workers = max(1, int(num_workers))
        self._sem = threading.Semaphore(max(depth, self.num_workers))
        self._next_load = 0
        self._results: dict = {}
        self._cond = threading.Condition()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _claim(self) -> int:
        with self._cond:
            i = self._next_load
            self._next_load += 1
            return i

    def _worker(self):
        while True:
            self._sem.acquire()
            i = self._claim()
            if i >= self.n:
                with self._cond:
                    self._results.setdefault(i, ("done", None))
                    self._cond.notify_all()
                return
            try:
                d = self.dataset[i]
                if self.transform is not None:
                    self.transform(d)
                item = ("ok", d)
            except Exception as e:  # surfaced on the consumer thread
                item = ("err", e)
            with self._cond:
                self._results[i] = item
                self._cond.notify_all()

    def __iter__(self):
        for i in range(self.n):
            with self._cond:
                while i not in self._results:
                    self._cond.wait()
                kind, item = self._results.pop(i)
            self._sem.release()
            if kind == "err":
                raise item
            yield item


class SLAMRunner:
    """Runs the SLAM over every sequence of the configured dataset."""

    def __init__(self, config: SLAMRunnerConfig):
        if isinstance(config, dict):
            config = dataclass_from_dict(SLAMRunnerConfig, config)
        self.config = config
        if bool(config.save_map):
            raise NotImplementedError("save_map (the map's PLY and rendered views) "
                                      "is not ported yet: ROADMAP.md A.19")
        self.device = resolve_device(config.device)
        self.log_dir = Path(config.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)

        assert_debug(config.dataset is not None, "A dataset config is required")
        self.dataset_loader = DATASET.load(dict(config.dataset))
        self.projector = self.dataset_loader.projector()

        slam_cfg = config.slam if config.slam is not None else {}
        self.slam_config = dataclass_from_dict(SLAMConfig, dict(slam_cfg))

        # the composed config and the git hash, for reproducibility
        (self.log_dir / "config.yaml").write_text(dump_yaml(
            {"git_hash": _git_hash(), "config": _to_plain(config)}))

    def load_slam_algorithm(self) -> SLAM:
        slam = SLAM(self.slam_config, projector=self.projector,
                    pose=self.config.pose, device=self.device)
        slam.init()
        return slam

    def ground_truth(self, sequence_name: str) -> Optional[np.ndarray]:
        return self.dataset_loader.get_ground_truth(sequence_name)

    def run_odometry(self) -> Dict[str, dict]:
        """Runs SLAM over all train sequences; returns metrics per sequence."""
        (datasets, names), _, _, _ = self.dataset_loader.sequences()
        results = OdometryResults(str(self.log_dir)) if self.config.save_results else None
        all_metrics: Dict[str, dict] = {}

        for seq_name, dataset in zip(names, datasets):
            logger.info("Running SLAM on sequence %s (%d frames) on %s",
                        seq_name, len(dataset), self.device)
            slam = self.load_slam_algorithm()
            start = time.time()
            frame_count = 0
            try:
                workers = min(int(self.config.num_workers or 1),
                              self.dataset_loader.max_num_workers())
                for data_dict in _Prefetcher(dataset,
                                             max_frames=self.config.max_num_frames,
                                             num_workers=workers,
                                             transform=slam.host_prepare):
                    slam.process_next_frame(data_dict)
                    frame_count += 1
            except (Exception, KeyboardInterrupt) as e:
                # save the partial trajectory, then re-raise
                logger.error("SLAM failed at frame %d of %s: %s", frame_count, seq_name, e)
                self._dump_partial(slam, seq_name)
                if self.config.move_if_fail and self.config.fail_dir:
                    self._move_to_fail_dir()
                raise
            slam.finish()  # flush batched odometry + deferred downstream work
            elapsed = time.time() - start

            relative = slam.get_relative_poses()
            ground_truth = self.ground_truth(seq_name)
            if ground_truth is not None and self.config.max_num_frames > 0:
                ground_truth = ground_truth[:frame_count]
            if results is not None:
                results.add_sequence(seq_name, relative, ground_truth,
                                     elapsed=elapsed, mode=self.config.eval_mode)
                if seq_name in results.metrics:
                    all_metrics[seq_name] = dict(results.metrics[seq_name])
            logger.info("Sequence %s: %d frames in %.1fs (%.1f scans/s)", seq_name,
                        frame_count, elapsed, frame_count / max(elapsed, 1e-9))
            if slam.backend is not None:
                slam.dump_all_constraints(str(self.log_dir / f"constraints_{seq_name}"))
            if slam.loop_closure is not None and \
                    hasattr(slam.loop_closure, "save_state") and self.config.save_results:
                # the submap state next to the results, to resume the run
                slam.loop_closure.save_state(
                    str(self.log_dir / f"loop_closure_{seq_name}.npz"))

        if results is not None:
            results.close()
            if "AVG" in results.metrics:
                all_metrics["AVG"] = results.metrics["AVG"]
        return all_metrics

    def _dump_partial(self, slam: SLAM, seq_name: str):
        try:
            relative = slam.get_relative_poses()
            if relative is not None and len(relative) > 0:
                np.savetxt(str(self.log_dir / f"{seq_name}.partial_poses.txt"),
                           relative[:, :3, :].reshape(len(relative), 12))
        except Exception as dump_err:
            logger.error("Could not dump partial trajectory: %s", dump_err)

    def _move_to_fail_dir(self):
        fail_dir = Path(self.config.fail_dir)
        fail_dir.mkdir(parents=True, exist_ok=True)
        target = fail_dir / self.log_dir.name
        shutil.move(str(self.log_dir), str(target))
        logger.error("Moved failed run dir to %s", target)


def _to_plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
