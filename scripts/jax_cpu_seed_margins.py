"""The JAX package's aggregated champion on the CPU over the acceptance
sequence drawn from other ``SyntheticConfig`` seeds: the figures beside
which the PyTorch port's card runs of ``python -m
pylidar_slam_tpu_torch.eval.record_e2e --margin-seeds ...`` are read.

The champion is ``eval/acceptance.champion_configs()["aggregated"]`` (the
root bench's configuration: batch 12, rimg8) over the 140 frames of
``acceptance.SEQ_KW`` with ``seed`` set, fed as ``scripts/record_e2e_ours.py``
feeds it.  The surfel champion is left out: its exact 1-NN takes hours a
sequence on the CPU.

Run from the repository root (a few minutes a seed on the CPU):

    python scripts/jax_cpu_seed_margins.py [SEED ...]   # default 0 1 2 3

Prints one JSON line per seed.
"""
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.chdir(REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def aggregated(seed: int) -> dict:
    from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticSequence
    from pylidar_slam_tpu.eval import acceptance
    from pylidar_slam_tpu.eval.eval_odometry import (compute_absolute_poses,
                                                     compute_kitti_metrics)

    cfg = SyntheticConfig(**dict(acceptance.SEQ_KW, seed=seed))
    seq = SyntheticSequence(cfg, "synth_00", seed=cfg.seed)
    frames = [np.asarray(seq[i]["numpy_pc"], np.float32) for i in range(cfg.num_frames)]
    gt = np.stack([np.asarray(seq[i]["absolute_pose_gt"], np.float64)
                   for i in range(cfg.num_frames)])
    gt = np.linalg.inv(gt[0]) @ gt
    odom = acceptance.build_odometry("aggregated")
    odom.init()
    last = np.eye(4, dtype=np.float32)
    t0 = time.perf_counter()
    for pc in frames:
        d = {"numpy_pc": pc, "init_rpose": last}
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
    odom.finish()
    traj = compute_absolute_poses(odom.get_relative_poses())
    tr_err, rot_err, _ = compute_kitti_metrics(traj, gt)
    return {"seed": seed, "champion": "aggregated", "platform": "cpu", "tr_err": tr_err,
            "rot_err": rot_err, "seconds": time.perf_counter() - t0}


def main():
    for seed in [int(s) for s in sys.argv[1:]] or [0, 1, 2, 3]:
        print(json.dumps(aggregated(seed)), flush=True)


if __name__ == "__main__":
    main()
