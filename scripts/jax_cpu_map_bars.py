"""The JAX package's own accuracy on the CPU for the projective and the
voxel-table maps: the figures the PyTorch port's card runs are held to
(``chip_smoke.py``'s ``projective`` and ``voxel`` phases: tr_err at most
this + 0.1 pt, ATE below 0.05 m).

- projective: ``run.py dataset=synthetic dataset.num_frames=130
  dataset.speed=1.3 slam/odometry/local_map=projective`` (the verify
  recipe on the projective map);
- voxel: ``bench.build_icp_config("voxel", "rimg8")`` with the bench's
  defaults, at batch 1, over the 140-frame acceptance sequence
  (``eval/acceptance.SEQ_KW``), each frame fed the previous pose as prior.

Run from the repository root (about a minute each on one CPU core):

    python scripts/jax_cpu_map_bars.py [projective] [voxel]

Prints one JSON line per run.
"""
import dataclasses
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

PROJECTIVE = ["dataset=synthetic", "dataset.num_frames=130", "dataset.speed=1.3",
              "slam/odometry/local_map=projective"]


def projective():
    import yaml
    import run
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run.main(PROJECTIVE + [f"log_dir={tmp}"])
        seconds = time.perf_counter() - t0
        m = yaml.safe_load((Path(tmp) / "metrics.yaml").read_text())["synth_00"]
    return {"run": "projective", "argv": PROJECTIVE, "tr_err": m["tr_err"],
            "ate_m": m["ATE"], "seconds": seconds}


def voxel():
    import bench
    from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
    from pylidar_slam_tpu.eval import acceptance
    from pylidar_slam_tpu.eval import eval_odometry as ev
    from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel

    cfg = dataclasses.replace(bench.build_icp_config("voxel", "rimg8"), batch_size=1)
    loader = SyntheticDatasetLoader(SyntheticConfig(**acceptance.SEQ_KW))
    ds = loader.sequences()[0][0][0]
    odom = ICPFrameToModel(cfg, projector=loader.projector())
    odom.init()
    t0 = time.perf_counter()
    last = None
    for i in range(len(ds)):
        d = dict(ds[i]) if last is None else dict(ds[i], init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose")
    rel = odom.get_relative_poses()
    seconds = time.perf_counter() - t0
    gt = loader.get_ground_truth("synth_00")[:len(rel)]
    ate, _ = ev.compute_ate(rel, gt)
    tr_err, _, _ = ev.compute_kitti_metrics(ev.compute_absolute_poses(rel),
                                            ev.compute_absolute_poses(gt))
    return {"run": "voxel", "frames": len(rel), "batch_size": 1, "tr_err": tr_err,
            "ate_m": float(ate), "seconds": seconds}


def main():
    runs = sys.argv[1:] or ["projective", "voxel"]
    for name in runs:
        print(json.dumps({"projective": projective, "voxel": voxel}[name]()), flush=True)


if __name__ == "__main__":
    main()
