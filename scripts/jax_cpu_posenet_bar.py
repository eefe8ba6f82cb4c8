"""The JAX package's own learning check of the deep track on the CPU, at the
size the PyTorch port's card run uses: the figure ``chip_smoke.py``'s
``posenet`` phase prints beside its own.

The recipe is ``tests/test_training.py::test_posenet_odometry_beats_identity_baseline``
(supervised PoseResNet-18, 8 epochs at batch 8 over 40 synthetic frames,
then the deep odometry over the same frames; its ATE must beat the identity
trajectory's by 3x), run here at 64x1024 with the published 131,072 padded
points unless told otherwise:

    python scripts/jax_cpu_posenet_bar.py [--height 64 --width 1024 --points 131072]

Run from the repository root. Prints one JSON line: the absolute-trajectory
ATE of the deep odometry and of the identity trajectory (the pin's metric),
their ratio, and the per-frame relative ATE of both (``compute_ate``, the
metric of a SLAM run's ``metrics.yaml``).
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.chdir(REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--height", type=int, default=64)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--points", type=int, default=131072)
    parser.add_argument("--frames", type=int, default=40)
    parser.add_argument("--epochs", type=int, default=8)
    args = parser.parse_args()

    import train as train_mod
    from pylidar_slam_tpu.config import compose
    from pylidar_slam_tpu.eval import eval_odometry as ev
    from pylidar_slam_tpu.slam.odometry.posenet_odometry import (PoseNetOdometry,
                                                                 PoseNetOdometryConfig)

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["dataset=synthetic", f"dataset.num_frames={args.frames}",
                f"dataset.lidar_height={args.height}", f"dataset.lidar_width={args.width}",
                f"num_epochs={args.epochs}", "batch_size=8",
                f"num_points_padded={args.points}", "average_meter_frequency=5",
                "with_tensorboard=false"]
        t0 = time.perf_counter()
        trainer = train_mod.build_trainer(compose("config", "train_posenet",
                                                  argv + [f"train_dir={tmp}/train"]))
        trainer.init()
        trainer.train(args.epochs)
        train_s = time.perf_counter() - t0

        seq = trainer.dataset_loader.sequences()[0][0][0]
        frames = [seq[i] for i in range(args.frames)]
        odom = PoseNetOdometry(PoseNetOdometryConfig(train_dir=f"{tmp}/train",
                                                     num_points_padded=args.points))
        odom.init()
        for f in frames:
            odom.process_next_frame({"numpy_pc": np.asarray(f["numpy_pc"], np.float32)})
        rel = odom.get_relative_poses().astype(np.float64)

    gt = np.stack([np.asarray(f["absolute_pose_gt"], np.float64) for f in frames])
    gt = np.linalg.inv(gt[0]) @ gt
    traj = ev.compute_absolute_poses(rel)

    def ate(t):
        return float(np.linalg.norm(t[:, :3, 3] - gt[:, :3, 3], axis=1).mean())

    identity = np.broadcast_to(np.eye(4), gt.shape)
    gt_rel = ev.compute_relative_poses(gt)
    out = {"argv": argv, "posenet_ate_m": ate(traj), "identity_ate_m": ate(identity),
           "relative_ate_m": ev.compute_ate(rel, gt_rel)[0],
           "identity_relative_ate_m": ev.compute_ate(np.array(identity), gt_rel)[0],
           "train_seconds": train_s}
    out["ratio"] = out["identity_ate_m"] / out["posenet_ate_m"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
