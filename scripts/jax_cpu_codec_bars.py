"""The JAX package's own accuracy on the CPU under each upload codec: the
figures the PyTorch port's card runs are held to (``chip_smoke.py``'s
``codecs`` phase: tr_err at most this + 0.1 pt, ATE below 0.05 m).

Every run goes over the 140-frame acceptance sequence on de-calibrated
beams (``eval/acceptance.SEQ_KW`` with ``beam_jitter_deg=0.1``, 64x1024),
each frame fed the previous pose as its prior:

- ``aggregated_<codec>``: ``champion_configs()["aggregated"]`` (batch 12,
  66,560 points) with ``upload_format`` rimg, rimg16, rimg12 or packed;
  ``aggregated_int16``: f32 uploads quantized to 4 mm int16 steps
  (``upload_quantization=0.004``), and ``aggregated_int16_dither`` the same
  with ``upload_dither``;
- ``surfel_rimg``: ``champion_configs()["surfel"]`` (exact NN) with rimg.

Run from the repository root (a few minutes a run on the CPU; the surfel
run longest):

    python scripts/jax_cpu_codec_bars.py [run ...]

Prints one JSON line per run.
"""
import dataclasses
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

JITTER_DEG = 0.1
# run -> (champion, the config fields it overrides); chip_smoke.CODEC_RUNS
RUNS = {
    "aggregated_rimg": ("aggregated", {"upload_format": "rimg"}),
    "aggregated_rimg16": ("aggregated", {"upload_format": "rimg16"}),
    "aggregated_rimg12": ("aggregated", {"upload_format": "rimg12"}),
    "aggregated_packed": ("aggregated", {"upload_format": "packed"}),
    "aggregated_int16": ("aggregated", {"upload_format": "f32", "upload_quantization": 0.004}),
    "aggregated_int16_dither": ("aggregated", {"upload_format": "f32",
                                               "upload_quantization": 0.004,
                                               "upload_dither": True}),
    "surfel_rimg": ("surfel", {"upload_format": "rimg"}),
}


def run(name):
    from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
    from pylidar_slam_tpu.eval import acceptance
    from pylidar_slam_tpu.eval import eval_odometry as ev
    from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel

    champion, over = RUNS[name]
    cfg = dataclasses.replace(acceptance.champion_configs()[champion], **over)
    loader = SyntheticDatasetLoader(SyntheticConfig(**dict(acceptance.SEQ_KW,
                                                           beam_jitter_deg=JITTER_DEG)))
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
    return {"run": name, "overrides": over, "frames": len(rel), "tr_err": tr_err,
            "ate_m": float(ate), "seconds": seconds}


def main():
    for name in sys.argv[1:] or list(RUNS):
        print(json.dumps(run(name)), flush=True)


if __name__ == "__main__":
    main()
