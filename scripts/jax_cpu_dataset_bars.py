"""The JAX package's own accuracy on the CPU over the fabricated on-disk
sequences (``scripts/fabricate_datasets.py``): the figures the PyTorch
port's card runs are held to (``chip_smoke.py``'s ``datasets`` phase:
tr_err at most this + 0.1 pt).

- kitti: ``run.py dataset=kitti dataset.train_sequences='["00"]'
  slam/odometry/local_map=aggregated`` over the KITTI-format sequence (140
  frames at 64 x 2,048 rays, 0.05 degree beam jitter);
- kitti_default: the same with ``config/slam.yaml``'s defaults (the surfel
  map with hash NN);
- ct_icp_files: ``run.py dataset=ct_icp slam/odometry=ct_icp`` over the 100
  rolling-shutter frames written as PLY.

Run from the repository root (a few minutes each on the CPU):

    python scripts/jax_cpu_dataset_bars.py [kitti] [kitti_default] [ct_icp_files]

The sequences are written once under ``build/chip_datasets/``.  Prints one
JSON line per run, with the digest of the files it read.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))
os.chdir(REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import fabricate_datasets as fab  # noqa: E402

DATA = REPO / "build" / "chip_datasets"
KITTI = ["dataset=kitti", 'dataset.train_sequences=["00"]']
RUNS = {
    "kitti": ("KITTI_ODOM_ROOT", fab.kitti_sequence,
              KITTI + ["slam/odometry/local_map=aggregated"]),
    "kitti_default": ("KITTI_ODOM_ROOT", fab.kitti_sequence, KITTI),
    "ct_icp_files": ("CT_ICP_ROOT", fab.ct_icp_sequence,
                     ["dataset=ct_icp", "slam/odometry=ct_icp"]),
}


def bar(name):
    import yaml
    import run
    env, make, argv = RUNS[name]
    root = make(DATA)
    os.environ[env] = str(root)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run.main(argv + [f"log_dir={tmp}"])
        seconds = time.perf_counter() - t0
        metrics = yaml.safe_load((Path(tmp) / "metrics.yaml").read_text())
    (seq, m), = ((k, v) for k, v in metrics.items() if k != "AVG")
    return {"run": name, "argv": argv, "sequence": seq, "tr_err": m["tr_err"],
            "ate_m": m["ATE"], "seconds": seconds, "digest": fab.digest(root)}


def main():
    for name in sys.argv[1:] or list(RUNS):
        print(json.dumps(bar(name)), flush=True)


if __name__ == "__main__":
    main()
