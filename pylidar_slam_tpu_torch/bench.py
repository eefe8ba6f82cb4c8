"""Benchmark: ICP frame-to-model odometry throughput (scans/s on one card),
the port of the repository's root ``bench.py``.

    python -m pylidar_slam_tpu_torch.bench

Runs the recorded bench configuration (by default the aggregated champion,
``eval.acceptance.champion_configs()["aggregated"]``, on kernel B1) over
KITTI-resolution scans (64 x 1024, 253 synthetic frames, or KITTI sequence
00 when ``$KITTI_ODOM_ROOT`` is mounted) and prints ONE JSON line with the
root bench's keys:

  {"metric", "value", "unit", "vs_baseline", "median_value", "rates",
   "batch", "stages", "phases"}

``value`` is the best of the repeats, ``median_value`` their median; every
repeat ends in ``torch.cuda.synchronize()``.  Baseline: the reference's
best-accuracy configuration runs at 5.34 scans/s (187.256 ms/frame,
BASELINE.md).

Environment: the root bench's ``BENCH_FRAMES`` (253), ``BENCH_BATCH`` (12),
``BENCH_WARMUP`` (batch + 1), ``BENCH_VOXEL`` (0: no host grid sample),
``BENCH_WORKERS`` (3 prep threads), ``BENCH_REPEATS`` (5), ``BENCH_MAP``
(aggregated, kdtree or voxel), ``BENCH_FORMAT`` (rimg8 on a grid-regular
loader, else rimg; or f32, packed, rimg16, rimg12), ``BENCH_QUANT`` (int16 upload
step in meters, 0 = off), ``BENCH_ITERS``, ``BENCH_REASSOC``,
``BENCH_REASSOC_MOTION``, ``BENCH_SCHEME``, ``BENCH_SIGMA``, ``BENCH_CAP``
(66,560 for rimg8 and rimg12, else 65,536), ``BENCH_MODEL_NORMALS``; and
``BENCH_DEVICE=cpu``, the only way to run on the CPU.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device

REFERENCE_SCANS_PER_SEC = 1000.0 / 187.256  # 5.34 scans/s (BASELINE.md)


@dataclass
class Settings:
    """The bench's environment, read once."""
    frames: int = 253
    batch: int = 12
    warmup: int = 13
    voxel: float = 0.0
    workers: int = 3
    repeats: int = 5
    bench_map: str = "aggregated"
    bench_format: str = ""  # "" = the loader's default
    device: str = "cuda"

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ
        batch = int(env.get("BENCH_BATCH", "12"))
        return cls(frames=int(env.get("BENCH_FRAMES", "253")), batch=batch,
                   warmup=int(env.get("BENCH_WARMUP", str(batch + 1))),
                   voxel=float(env.get("BENCH_VOXEL", "0.0")),
                   workers=max(1, int(env.get("BENCH_WORKERS", "3"))),
                   repeats=int(env.get("BENCH_REPEATS", "5")),
                   bench_map=env.get("BENCH_MAP", "aggregated"),
                   bench_format=env.get("BENCH_FORMAT", ""),
                   device=env.get("BENCH_DEVICE", "cuda"))


def generate(seq, n: int) -> list:
    """The first `n` items of a synthetic sequence, raycast in threads
    (each frame seeds its own noise; numpy's array passes release the
    interpreter lock)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(seq.__getitem__, range(n)))


def load_frames(num_frames: int):
    """(frames, loader, source): KITTI sequence 00 if mounted, else the
    synthetic 64x1024 sequence (40 walls, 25 pillars)."""
    kitti_root = os.environ.get("KITTI_ODOM_ROOT")
    if kitti_root and Path(kitti_root).exists():
        from pylidar_slam_tpu_torch.dataset.kitti_dataset import (
            KITTIConfig, KITTIDatasetLoader)
        loader = KITTIDatasetLoader(KITTIConfig(kitti_sequence_dir=kitti_root,
                                                train_sequences=["00"]))
        seq = loader.sequences()[0][0][0]
        frames = [seq[i]["numpy_pc"][:, :3] for i in range(num_frames)]
        return frames, loader, "kitti-00"
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticDatasetLoader)
    loader = SyntheticDatasetLoader(SyntheticConfig(
        lidar_height=64, lidar_width=1024, num_frames=num_frames, num_walls=40,
        num_pillars=25))
    seq = loader.sequences()[0][0][0]
    frames = [f["numpy_pc"] for f in generate(seq, num_frames)]
    return frames, loader, "synthetic-kitti64x1024"


def build_icp_config(bench_map: str, bench_format: str):
    """The recorded bench configuration, field for field the root
    ``bench.build_icp_config``'s; with the defaults,
    ``build_icp_config("aggregated", "rimg8")`` is the aggregated champion
    (a test holds both equalities)."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import \
        ICPFrameToModelConfig
    env = os.environ
    if bench_map == "kdtree":
        local_map = {"type": "kdtree_local_map",
                     "local_map_size": 30, "points_per_frame": 4096,
                     "sample_voxel_size": 0.3, "target_samples": 16384,
                     "target_voxel_size": 0.4, "max_neighbor_dist": 1.0,
                     "nn_backend": "hash", "hash_capacity": 32,
                     "normals_mode": "knn"}
    elif bench_map == "voxel":
        local_map = {"type": "voxel_local_map", "local_map_size": 30,
                     "map_voxel": 0.4, "max_neighbor_dist": 0.4,
                     "table_slots": 262144, "target_samples": 8192}
    elif bench_map == "aggregated":
        local_map = {"type": "aggregated_local_map", "local_map_size": 20,
                     "window_rows": 1, "window_cols": 2,
                     "max_neighbor_dist": 0.6}
        # added only when set, so the default compares equal to the champion
        if env.get("BENCH_MODEL_NORMALS", "0") == "1":
            local_map["model_normals"] = True
    else:
        raise ValueError(f"BENCH_MAP={bench_map}: aggregated, kdtree or voxel")
    return ICPFrameToModelConfig(
        max_num_alignments=int(env.get("BENCH_ITERS", "8")),
        reassoc_every=int(env.get("BENCH_REASSOC", "8")),
        reassoc_motion_m=float(env.get("BENCH_REASSOC_MOTION", "0.2")),
        local_map=local_map,
        alignment={"gauss_newton_config": {
            "scheme": env.get("BENCH_SCHEME",
                              "neighborhood" if bench_map == "kdtree" else "geman_mcclure"),
            "sigma": float(env.get("BENCH_SIGMA",
                                   "0.2" if bench_map == "kdtree" else "0.4")),
            "max_iters": 1}},
        # rimg8 buffers carry (H+W)/2 plane rows past H*W; rimg12's decode
        # to 66,560 points at 64x1024
        num_points_padded=int(env.get(
            "BENCH_CAP", "66560" if bench_format in ("rimg8", "rimg12") else "65536")),
        data_key="numpy_pc",
        batch_size=int(env.get("BENCH_BATCH", "12")),
        upload_quantization=float(env.get("BENCH_QUANT", "0.0")),
        upload_format=bench_format)


def synchronize(device: torch.device) -> None:
    """Waits for the device's queued work (CPU ops run synchronously)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grid_sample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host grid-sample preprocessing (first point per voxel)."""
    if voxel <= 0.0:
        return points
    from pylidar_slam_tpu_torch.utils import native
    keep = native.grid_sample_mask(points, voxel)
    if keep is None:  # no native library: hash + first occurrence in numpy
        q = np.floor(points[:, :3] / voxel).astype(np.int64)
        h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349669) ^ (q[:, 2] * 83492791)
        _, idx = np.unique(h, return_index=True)
        return points[np.sort(idx)]
    return points[keep]


def _clone_state(state):
    """A copy of a map state (a NamedTuple of tensors, possibly nested)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        return type(state)(*(_clone_state(x) for x in state))
    return state


def _start_prep(odom, frame_list, workers: int, batch: int, voxel: float):
    """Grid-sample and upload-encode in `workers` strided threads; the
    iterator hands the (points, encoded) pairs over in frame order."""
    qs = [queue.Queue(maxsize=batch) for _ in range(workers)]

    def worker(j):
        # an exception reaches the consumer as a marker, so it never waits
        # on a dead worker
        try:
            for f in frame_list[j::workers]:
                g = grid_sample(f, voxel)
                qs[j].put((g, odom.encode_upload(g)))
        except BaseException as exc:  # noqa: BLE001 - re-raised in the iterator
            qs[j].put(("__prep_error__", exc))

    for j in range(workers):
        threading.Thread(target=worker, args=(j,), daemon=True).start()

    def items():
        for i in range(len(frame_list)):
            item = qs[i % workers].get()
            if isinstance(item[0], str) and item[0] == "__prep_error__":
                raise item[1]
            yield item

    return items()


def stage_probes(odom, frames, s: Settings, device: torch.device) -> dict:
    """Host encode, pinned upload and device step per frame, measured apart
    from the pipelined loop: the batched step chained 4 times on a clone of
    the map state and a device-resident batch."""
    stages = {}
    probe = [grid_sample(f, s.voxel) for f in frames[:s.batch]]
    t0 = time.perf_counter()
    bufs = [odom._compact_host_buffer(f) for f in probe]
    stages["host_encode_ms_per_frame"] = round(
        (time.perf_counter() - t0) / len(probe) * 1000, 2)
    stacked = odom._stack(bufs)
    host = torch.from_numpy(stacked)
    if device.type == "cuda":
        host = host.pin_memory()
    up_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        host.to(device, non_blocking=True)
        synchronize(device)
        up_times.append(time.perf_counter() - t0)
    stages["upload_ms_per_frame"] = round(min(up_times) / len(bufs) * 1000, 2)
    stages["upload_mb_per_frame"] = round(stacked.nbytes / len(bufs) / 1e6, 3)
    pts = odom._upload(stacked)
    msks = odom._ones_mask(len(bufs))
    state = _clone_state(odom._map_state)
    delta = torch.eye(4, dtype=torch.float32, device=device)
    rpose = torch.eye(4, dtype=torch.float32, device=device)
    state, delta, rpose, _, _ = odom._map.batch_step(state, delta, rpose, pts, msks)  # warm
    synchronize(device)
    n_chain = 4
    t0 = time.perf_counter()
    for _ in range(n_chain):
        state, delta, rpose, _, _ = odom._map.batch_step(state, delta, rpose, pts, msks)
    synchronize(device)
    stages["device_ms_per_frame"] = round(
        (time.perf_counter() - t0) / (n_chain * len(bufs)) * 1000, 2)
    return stages


def timed_frames(frames: list, s: Settings) -> list:
    """The frames after the warm-up, trimmed to whole batches."""
    bench_frames = frames[s.warmup:] if len(frames) > s.warmup else frames
    return bench_frames[:max(s.batch, len(bench_frames) // s.batch * s.batch)]


def run(s: Settings, frames: list, loader, source: str) -> dict:
    """The bench over `frames` with settings `s`; returns the JSON line's
    object."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    device = resolve_device(s.device)
    # rimg8's per-row / per-column mean offsets are exact only on a
    # grid-regular firing pattern: another loader's default is per-pixel rimg
    bench_format = s.bench_format or ("rimg8" if loader.grid_regular else "rimg")
    icp_cfg = build_icp_config(s.bench_map, bench_format)
    odom = ICPFrameToModel(icp_cfg, projector=loader.projector(), device=device)
    last_rpose = np.eye(4, dtype=np.float32)

    def run_frame(points, encoded=None):
        nonlocal last_rpose
        d = {"numpy_pc": points, "init_rpose": last_rpose}
        if encoded is not None:
            d["encoded_upload"] = encoded
        odom.process_next_frame(d)
        last_rpose = d.get("odometry_pose", last_rpose)

    # warm-up: map fill and the first batched step, drained before timing
    for i in range(s.warmup):
        run_frame(grid_sample(frames[i % len(frames)], s.voxel))
    odom.finish()
    synchronize(device)

    bench_frames = timed_frames(frames, s)
    rates, phase_stats = [], []
    for _ in range(s.repeats):
        items = _start_prep(odom, bench_frames, s.workers, s.batch, s.voxel)
        base = dict(odom.pipe_stats)
        q_wait = 0.0
        t0 = time.perf_counter()
        for _i in range(len(bench_frames)):
            tq = time.perf_counter()
            item = next(items)
            q_wait += time.perf_counter() - tq
            run_frame(*item)
        tf = time.perf_counter()
        odom.finish()  # the partial batch, if any
        synchronize(device)
        t_end = time.perf_counter()
        n = len(bench_frames)
        rates.append(n / (t_end - t0))
        phase_stats.append({
            "queue_wait_ms_per_frame": round(q_wait / n * 1000, 2),
            "upload_wait_ms_per_frame": round(
                (odom.pipe_stats["upload_wait_s"] - base["upload_wait_s"]) / n * 1000, 2),
            "dispatch_ms_per_frame": round(
                (odom.pipe_stats["dispatch_s"] - base["dispatch_s"]) / n * 1000, 2),
            "final_sync_ms_per_frame": round((t_end - tf) / n * 1000, 2),
            "total_ms_per_frame": round((t_end - t0) / n * 1000, 2),
        })
    scans_per_sec = max(rates)
    try:
        stages = stage_probes(odom, frames, s, device)
    except Exception as exc:  # noqa: BLE001 - probes are telemetry; the line says why
        stages = {"probe_error": f"{type(exc).__name__}: {exc}"[:200]}
    proj = odom.projector
    return {
        "metric": f"ICP odometry throughput ({source}, {proj.height}x{proj.width}, "
                  f"map={s.bench_map}, upload={icp_cfg.upload_format}, accuracy config)",
        "value": round(scans_per_sec, 2),
        "unit": "scans/sec",
        "vs_baseline": round(scans_per_sec / REFERENCE_SCANS_PER_SEC, 2),
        "median_value": round(sorted(rates)[len(rates) // 2], 2),
        "rates": [round(r, 2) for r in rates],
        "batch": s.batch,
        "stages": stages,
        # the best repeat's breakdown of the pipeline thread's time:
        # queue_wait = prep starvation, upload_wait = staging + enqueueing
        # the upload, dispatch = the batched step's enqueue, final_sync =
        # the device's tail
        "phases": phase_stats[int(np.argmax(rates))] if phase_stats else {},
    }


def main() -> dict:
    s = Settings.from_env()
    resolve_device(s.device)  # fail before generating frames
    frames, loader, source = load_frames(s.frames)
    result = run(s, frames, loader, source)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
