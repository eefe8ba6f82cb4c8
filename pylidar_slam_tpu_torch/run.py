"""SLAM entry point of the port: ``run.py``'s command line on the card.

Usage (the override grammar of ``run.py``, composing the shared
``config/`` tree):

    python -m pylidar_slam_tpu_torch.run dataset=synthetic \\
        dataset.num_frames=130 dataset.speed=1.3 log_dir=/tmp/run

runs on the CUDA card (``device=cpu`` runs it on the CPU).  ``-m`` sweeps
the cartesian product of comma-separated values, each job in a numbered
directory under ``log_dir``; ``parallel_jobs=N`` (``auto``: one per card)
runs N jobs at a time in threads, job i on card ``i % device_count``, each
thread on a CUDA stream of its own.  Point-sharded surfel odometry runs
one process per rank:

    torchrun --nproc_per_node S -m pylidar_slam_tpu_torch.run ... \
        slam.odometry.shard_points=S
"""
from __future__ import annotations

import concurrent.futures
import datetime
import itertools
import logging
import sys
from pathlib import Path

import torch

from pylidar_slam_tpu_torch.config import compose, dataclass_from_dict, dump_yaml
from pylidar_slam_tpu_torch.slam.odometry_runner import (SLAMRunner, SLAMRunnerConfig,
                                                         resolve_device)
from pylidar_slam_tpu_torch.utils.build import REPO_ROOT

CONFIG_DIR = REPO_ROOT / "config"


def run_slam(cfg: dict):
    runner = SLAMRunner(dataclass_from_dict(SLAMRunnerConfig, cfg))
    metrics = runner.run_odometry()
    for seq, m in metrics.items():
        print(f"[{seq}] " + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    return metrics


def _stamp_hydra_dir(log_dir: str, overrides: list):
    """Writes .hydra/overrides.yaml, the job's command line, as hydra does."""
    hydra_dir = Path(log_dir) / ".hydra"
    hydra_dir.mkdir(parents=True, exist_ok=True)
    (hydra_dir / "overrides.yaml").write_text(dump_yaml(list(overrides)))


def _split_sweep(argv: list):
    """Separates sweep overrides (key=v1,v2,...) from fixed ones."""
    keys, value_sets, fixed = [], [], []
    for ov in argv:
        if "=" not in ov:
            raise ValueError(f"Malformed override '{ov}' (expected key=value)")
        key, value = ov.split("=", 1)
        if "," in value and not value.startswith(("[", "{", '"', "'")):
            keys.append(key)
            value_sets.append(value.split(","))
        else:
            fixed.append(ov)
    return keys, value_sets, fixed


def _run_on_card(cfg: dict, index: int):
    """Runs the job on card `index % device_count` under a CUDA stream of
    its own (two job threads on one card then do not serialize on the
    default stream); a CPU job runs as it is."""
    if resolve_device(cfg.get("device")).type != "cuda":
        return run_slam(cfg)
    device = torch.device("cuda", index % torch.cuda.device_count())
    cfg = dict(cfg, device=str(device))
    with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
        return run_slam(cfg)


def run_multirun(config_dir: Path, argv: list):
    """The `-m` sweep: one job per combination of the comma-separated
    override values, each in `log_dir`/<job index>; `parallel_jobs=N|auto`
    runs min(N, jobs) of them at a time (``_run_on_card``)."""
    keys, value_sets, fixed = _split_sweep(argv)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d/%H-%M-%S")
    sweep_root = Path(".outputs/multirun") / stamp
    parallel_jobs = 1
    for ov in list(fixed):
        if ov.startswith("log_dir="):
            sweep_root = Path(ov.split("=", 1)[1])
            fixed.remove(ov)
        elif ov.startswith("parallel_jobs="):
            value = ov.split("=", 1)[1]
            parallel_jobs = 0 if value == "auto" else int(value)
            fixed.remove(ov)

    combos = list(itertools.product(*value_sets)) if keys else [()]
    print(f"[multirun] {len(combos)} jobs -> {sweep_root}")

    def one_job(idx, combo, parallel):
        job_overrides = fixed + [f"{k}={v}" for k, v in zip(keys, combo)]
        job_dir = sweep_root / str(idx)
        cfg = compose(str(config_dir), "slam", job_overrides + [f"log_dir={job_dir}"])
        _stamp_hydra_dir(str(job_dir), job_overrides)
        print(f"[multirun] job {idx}: {' '.join(job_overrides)}")
        return _run_on_card(cfg, idx) if parallel else run_slam(cfg)

    if parallel_jobs == 1 or len(combos) == 1:
        return [one_job(i, c, False) for i, c in enumerate(combos)]
    devices = max(torch.cuda.device_count(), 1)
    n_workers = min(devices if parallel_jobs == 0 else parallel_jobs, len(combos))
    print(f"[multirun] {n_workers} parallel workers over {devices} device(s)")
    with concurrent.futures.ThreadPoolExecutor(n_workers) as pool:
        futures = [pool.submit(one_job, i, c, True) for i, c in enumerate(combos)]
        return [f.result() for f in futures]


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    multirun = False
    for flag in ("-m", "--multirun"):
        while flag in argv:
            argv.remove(flag)
            multirun = True
    if multirun:
        return run_multirun(CONFIG_DIR, argv)
    cfg = compose(str(CONFIG_DIR), "slam", argv)
    _stamp_hydra_dir(str(cfg.get("log_dir", ".")), argv)
    return run_slam(cfg)


if __name__ == "__main__":
    main()
