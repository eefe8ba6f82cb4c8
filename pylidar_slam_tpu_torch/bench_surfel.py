"""Throughput and accuracy of the surfel ("kdtree") map in one run (the port
of ``scripts/bench_surfel.py``).

    python -m pylidar_slam_tpu_torch.bench_surfel

One pass over the acceptance sequence scores tr_err (and warms up), then
``SF_REPEATS`` timed passes from a fresh map give scans/s; each pass ends in
a fetch of the pose log, which waits for the device.  Prints one JSON line
with the JAX script's keys: ``metric``, ``value`` (best pass), ``unit``,
``vs_baseline``, ``tr_err``, ``rot_err``, ``timed_frames``, ``batch``,
``rates``, ``config``, ``total_wall_s``.

Environment (the JAX script's): ``SF_ITERS`` (10), ``SF_BATCH`` (8),
``SF_NN`` (hash; ``exact`` runs kernel B2), ``SF_REASSOC`` (100),
``SF_REASSOC_MOTION`` (0.2), ``SF_FORMAT`` (rimg8; any upload format, padded
to 66,560 points for rimg8 and rimg12, else 65,536), ``SF_FRAMES`` (140),
``SF_NORMALS`` (knn), ``SF_POINTS`` (4096), ``SF_MAP`` (30), ``SF_VOXEL``,
``SF_TGT``, ``SF_REANCHOR``, ``SF_THRESH_TRANS``, ``SF_THRESH_ROT``,
``SF_REPEATS`` (3), ``SF_MAP_TYPE`` (kdtree or voxel) with ``SF_ND`` and
``SF_SLOTS``; ``BENCH_DEVICE=cpu`` runs on the CPU.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time

import numpy as np

from pylidar_slam_tpu_torch.bench import REFERENCE_SCANS_PER_SEC, synchronize
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device


def build_config(env=os.environ):
    """The surfel (or voxel) bench configuration from the ``SF_*`` variables."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import \
        ICPFrameToModelConfig
    fmt = env.get("SF_FORMAT", "rimg8")
    if env.get("SF_MAP_TYPE", "kdtree") == "voxel":
        local_map = {"type": "voxel_local_map",
                     "local_map_size": int(env.get("SF_MAP", "30")),
                     "map_voxel": float(env.get("SF_VOXEL", "0.4")),
                     "max_neighbor_dist": float(env.get("SF_ND", "0.4")),
                     "table_slots": int(env.get("SF_SLOTS", "262144")),
                     "target_samples": int(env.get("SF_TGT", "8192"))}
    else:
        local_map = {"type": "kdtree_local_map",
                     "local_map_size": int(env.get("SF_MAP", "30")),
                     "points_per_frame": int(env.get("SF_POINTS", "4096")),
                     "sample_voxel_size": float(env.get("SF_VOXEL", "0.3")),
                     "target_samples": int(env.get("SF_TGT", "16384")),
                     "levenberg_damping": 0.0,
                     "normals_mode": env.get("SF_NORMALS", "knn"),
                     "nn_backend": env.get("SF_NN", "hash"),
                     "reanchor_dist": float(env.get("SF_REANCHOR", "20"))}
    return ICPFrameToModelConfig(
        max_num_alignments=int(env.get("SF_ITERS", "10")),
        reassoc_every=int(env.get("SF_REASSOC", "100")),
        reassoc_motion_m=float(env.get("SF_REASSOC_MOTION", "0.2")),
        # insert spacing: thresholds above the per-frame motion space the
        # ring's inserts out
        threshold_trans=float(env.get("SF_THRESH_TRANS", "0.1")),
        threshold_rot=float(env.get("SF_THRESH_ROT", "0.3")),
        local_map=local_map,
        alignment={"gauss_newton_config": {"scheme": "neighborhood",
                                           "sigma": 0.2, "max_iters": 1}},
        num_points_padded=66560 if fmt in ("rimg8", "rimg12") else 65536,
        data_key="numpy_pc",
        upload_format=fmt, batch_size=int(env.get("SF_BATCH", "8")))


def feed(odom, frames: list, batch: int, time_all: bool, device) -> tuple:
    """One pass over the frames, encoded ahead in a thread; returns
    (scans/s, relative poses).  Untimed passes start the clock after the
    first frame and one batch."""
    q: queue.Queue = queue.Queue(maxsize=2 * batch)

    def producer():
        for pc in frames:
            q.put((pc, odom.encode_upload(pc)))

    threading.Thread(target=producer, daemon=True).start()
    last = np.eye(4, dtype=np.float32)
    warm = 0 if time_all else batch + 1
    t0 = time.perf_counter()
    for i in range(len(frames)):
        pc, enc = q.get()
        d = {"numpy_pc": pc, "encoded_upload": enc, "init_rpose": last}
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
        if not time_all and i + 1 == warm:
            odom.finish()
            synchronize(device)
            t0 = time.perf_counter()
    rel = odom.get_relative_poses()  # flushes, then one fetch of the log
    return (len(frames) - warm) / (time.perf_counter() - t0), rel


def run(frames: list, gt: np.ndarray, projector, env=os.environ) -> dict:
    from pylidar_slam_tpu_torch.eval.eval_odometry import (
        compute_absolute_poses, compute_kitti_metrics)
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    device = resolve_device(env.get("BENCH_DEVICE"))
    icp_cfg = build_config(env)
    batch = int(icp_cfg.batch_size)
    odom = ICPFrameToModel(icp_cfg, projector=projector, device=device)
    t_start = time.perf_counter()
    _, rel = feed(odom, frames, batch, False, device)
    tr_err, rot_err, _ = compute_kitti_metrics(compute_absolute_poses(rel), gt)
    rates = []
    for _ in range(int(env.get("SF_REPEATS", "3"))):
        odom.init()  # a fresh map
        rates.append(feed(odom, frames, batch, True, device)[0])
    rate = max(rates) if rates else float("nan")
    return {
        "metric": "surfel (kdtree) champion throughput + accuracy",
        "value": round(rate, 2), "unit": "scans/sec",
        "vs_baseline": round(rate / REFERENCE_SCANS_PER_SEC, 2),
        "tr_err": None if tr_err is None else round(float(tr_err), 6),
        "rot_err": None if rot_err is None else round(float(rot_err), 8),
        "timed_frames": len(frames), "batch": batch,
        "rates": [round(r, 2) for r in rates],
        "config": {"iters": icp_cfg.max_num_alignments,
                   "nn": env.get("SF_NN", "hash"),
                   "normals": env.get("SF_NORMALS", "knn"),
                   "format": icp_cfg.upload_format,
                   "reassoc_motion_m": icp_cfg.reassoc_motion_m},
        "total_wall_s": round(time.perf_counter() - t_start, 1),
    }


def main() -> dict:
    from pylidar_slam_tpu_torch.eval import acceptance
    from pylidar_slam_tpu_torch.eval.record_e2e import acceptance_sequence
    from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
    resolve_device(os.environ.get("BENCH_DEVICE"))  # fail before raycasting
    frames, gt, cfg = acceptance_sequence(num_frames=int(os.environ.get("SF_FRAMES", "140")))
    proj = SphericalProjection(cfg.lidar_height, cfg.lidar_width, acceptance.UP_FOV,
                               acceptance.DOWN_FOV)
    result = run(frames, gt, proj)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
