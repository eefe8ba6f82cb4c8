"""SLAM entry point of the port: ``run.py``'s command line on the card.

Usage (the override grammar of ``run.py``, composing the shared
``config/`` tree):

    python -m pylidar_slam_tpu_torch.run dataset=synthetic \\
        dataset.num_frames=130 dataset.speed=1.3 log_dir=/tmp/run

runs on the CUDA card (``device=cpu`` runs it on the CPU).  ``-m`` sweeps
the cartesian product of comma-separated values, one job after another,
each in a numbered directory under ``log_dir``.
"""
from __future__ import annotations

import datetime
import itertools
import logging
import sys
from pathlib import Path

from pylidar_slam_tpu_torch.config import compose, dataclass_from_dict, dump_yaml
from pylidar_slam_tpu_torch.slam.odometry_runner import SLAMRunner, SLAMRunnerConfig
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


def run_multirun(config_dir: Path, argv: list):
    """The `-m` sweep: one job per combination of the comma-separated
    override values, run in turn, each in `log_dir`/<job index>."""
    keys, value_sets, fixed = _split_sweep(argv)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d/%H-%M-%S")
    sweep_root = Path(".outputs/multirun") / stamp
    for ov in list(fixed):
        if ov.startswith("log_dir="):
            sweep_root = Path(ov.split("=", 1)[1])
            fixed.remove(ov)
        elif ov.startswith("parallel_jobs="):
            value = ov.split("=", 1)[1]
            fixed.remove(ov)
            if value != "1":
                raise NotImplementedError(
                    f"parallel_jobs={value}: jobs on several cards are not ported "
                    f"(one card): ROADMAP.md A.18")

    combos = list(itertools.product(*value_sets)) if keys else [()]
    print(f"[multirun] {len(combos)} jobs -> {sweep_root}")
    out = []
    for idx, combo in enumerate(combos):
        job_overrides = fixed + [f"{k}={v}" for k, v in zip(keys, combo)]
        job_dir = sweep_root / str(idx)
        cfg = compose(str(config_dir), "slam", job_overrides + [f"log_dir={job_dir}"])
        _stamp_hydra_dir(str(job_dir), job_overrides)
        print(f"[multirun] job {idx}: {' '.join(job_overrides)}")
        out.append(run_slam(cfg))
    return out


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
