"""Steady-state throughput of the whole pipeline: odometry, elevation-image
loop closure (its ICP refine on kernel B2) and the pose-graph backend (the
port of ``scripts/bench_full_pipeline.py``).

    python -m pylidar_slam_tpu_torch.bench_pipeline

``SLAM`` runs the aggregated map with batched rimg8 uploads at the bench
champion's schedule; frames are raycast before the clock starts and
prepared (``host_prepare``) in a thread ahead of the pipeline.  The window
is the middle of the run: ``FP_WARMUP_FRAMES`` lead (first uses and the
pipeline's fill), ``FP_COOLDOWN_FRAMES`` trail (processed in order, but the
final drain is not billed).  Prints one JSON line with the JAX script's
keys: ``metric``, ``value`` (the median run), ``unit``, ``timed_frames``,
``batch``, ``stages_ms_per_frame``, ``pipeline_ms_per_flush``,
``loop_ms_per_frame``, ``runs``, ``repeats``.

Environment (the JAX script's): ``FP_FRAMES`` (250), ``FP_BATCH`` (12),
``FP_WARMUP_FRAMES`` (48), ``FP_COOLDOWN_FRAMES`` (48), ``FP_SPEED`` (0.5,
which keeps 250 frames inside the 120 m wall field), ``FP_ITERS``,
``FP_REASSOC``, ``FP_MOTION``, ``FP_SIGMA``, ``FP_LC``, ``FP_BACKEND``,
``FP_REPEATS`` (5), ``FP_OUT`` (also write the JSON to this path);
``BENCH_DEVICE=cpu`` runs on the CPU.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np

from pylidar_slam_tpu_torch.bench import synchronize
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"


def slam_config(batch: int, env=os.environ) -> dict:
    from pylidar_slam_tpu_torch.config import compose
    return compose(str(CONFIG_DIR), "slam", [
        "dataset=synthetic",
        f"slam/loop_closure={env.get('FP_LC', 'elevation_image')}",
        f"slam/backend={env.get('FP_BACKEND', 'graph_slam')}",
        "slam/odometry/local_map=aggregated",
        "slam.odometry.local_map.max_neighbor_dist=0.6",
        f"slam.odometry.batch_size={batch}",
        "slam.odometry.upload_format=rimg8",
        "slam.odometry.num_points_padded=66560",
        # the bench champion's schedule: 8 GN trips, re-rasterized on 0.2 m
        # of motion, geman_mcclure sigma 0.4
        f"slam.odometry.reassoc_every={env.get('FP_REASSOC', '8')}",
        f"slam.odometry.max_num_alignments={env.get('FP_ITERS', '8')}",
        f"slam.odometry.reassoc_motion_m={env.get('FP_MOTION', '0.2')}",
        "slam.odometry.alignment.gauss_newton_config.scheme=geman_mcclure",
        "slam.odometry.alignment.gauss_newton_config.sigma=" + env.get("FP_SIGMA", "0.4"),
    ])["slam"]


def run_once(seq: list, projector, env=os.environ) -> dict:
    """One pipeline run over the prepared frames."""
    from pylidar_slam_tpu_torch.slam.slam import SLAM
    device = resolve_device(env.get("BENCH_DEVICE"))
    frames = len(seq)
    batch = int(env.get("FP_BATCH", "12"))
    warmup = int(env.get("FP_WARMUP_FRAMES", "48"))
    cooldown = int(env.get("FP_COOLDOWN_FRAMES", "48"))
    slam = SLAM(slam_config(batch, env), projector=projector, device=device)
    slam.init()
    q: queue.Queue = queue.Queue(maxsize=2 * batch)

    def producer():
        for f in seq:
            frame = dict(f)
            slam.host_prepare(frame)
            q.put(frame)

    threading.Thread(target=producer, daemon=True).start()
    t_mark = t_cool = None
    cool_at = frames - cooldown
    t_qget = t_proc = 0.0
    n_odo = n_lc = n_be = 0
    for i in range(frames):
        tq = time.perf_counter()
        frame = q.get()
        tp = time.perf_counter()
        slam.process_next_frame(frame)
        tdone = time.perf_counter()
        if t_mark is not None and t_cool is None:
            t_qget += tp - tq
            t_proc += tdone - tp
        if i + 1 == cool_at and t_mark is not None:
            t_cool = time.perf_counter()
        if i + 1 == warmup:
            synchronize(device)
            t_mark = time.perf_counter()
            n_odo, n_lc, n_be = (len(slam.elapsed_odometry), len(slam.elapsed_loop_closure),
                                 len(slam.elapsed_backend))
    t_fin = time.perf_counter()
    slam.finish()
    synchronize(device)
    t_finish = time.perf_counter() - t_fin
    if t_cool is None:  # the cooldown covers the window: bill up to the loop's end
        t_cool, cool_at = t_fin, frames
    timed = cool_at - warmup
    rate = timed / (t_cool - t_mark)

    def mean_ms(xs, start):
        return 1e3 * float(np.mean(xs[start:])) if len(xs) > start else 0.0

    pipe = dict(getattr(slam.odometry, "pipe_stats", {}))
    n_fl = max(1, int(pipe.get("flushes", 0)))
    return {
        "metric": "full pipeline (odometry+LC+backend) steady-state",
        "value": round(rate, 1), "unit": "scans/sec",
        "timed_frames": timed, "batch": batch,
        "stages_ms_per_frame": {
            "odometry_submit": round(mean_ms(slam.elapsed_odometry, n_odo), 2),
            "loop_closure": round(mean_ms(slam.elapsed_loop_closure, n_lc), 2),
            "backend": round(mean_ms(slam.elapsed_backend, n_be), 2)},
        # whole-run means (warm-up included) per flush of the odometry
        "pipeline_ms_per_flush": {
            "upload_wait": round(1e3 * pipe.get("upload_wait_s", 0.0) / n_fl, 2),
            "dispatch": round(1e3 * pipe.get("dispatch_s", 0.0) / n_fl, 2)},
        # the window's split: waiting on the prep thread, in-order
        # processing, and the final drain (outside the window)
        "loop_ms_per_frame": {"qget": round(1e3 * t_qget / timed, 2),
                              "process": round(1e3 * t_proc / timed, 2),
                              "cooldown_frames": frames - cool_at,
                              "finish_total_s": round(t_finish, 2)},
    }


def run(seq: list, projector, env=os.environ) -> dict:
    """``FP_REPEATS`` runs; the summary is the median run's, with every
    run's rate."""
    repeats = int(env.get("FP_REPEATS", "5"))
    runs = [run_once(seq, projector, env) for _ in range(repeats)]
    rates = sorted(r["value"] for r in runs)
    median = rates[len(rates) // 2] if repeats % 2 else round(
        0.5 * (rates[repeats // 2 - 1] + rates[repeats // 2]), 1)
    summary = dict(min(runs, key=lambda r: abs(r["value"] - median)))
    summary["value"] = median
    summary["runs"] = [r["value"] for r in runs]
    summary["repeats"] = repeats
    return summary


def load(env=os.environ) -> tuple:
    """(frames, projector): ``FP_FRAMES`` synthetic 64x1024 frames at
    ``FP_SPEED``, raycast before the clock starts (the raycaster is slower
    than the pipeline)."""
    from pylidar_slam_tpu_torch.bench import generate
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticDatasetLoader)
    frames = int(env.get("FP_FRAMES", "250"))
    loader = SyntheticDatasetLoader(SyntheticConfig(
        lidar_height=64, lidar_width=1024, num_frames=frames, num_walls=40,
        num_pillars=25, speed=float(env.get("FP_SPEED", "0.5"))))
    return generate(loader.sequences()[0][0][0], frames), loader.projector()


def main() -> dict:
    env = os.environ
    resolve_device(env.get("BENCH_DEVICE"))  # fail before raycasting
    summary = run(*load(env), env)
    out = env.get("FP_OUT", "")
    if out:
        Path(out).write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
