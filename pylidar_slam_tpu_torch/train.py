"""PoseNet training entry point of the port: ``train.py``'s command line on
the card.

    python -m pylidar_slam_tpu_torch.train dataset=synthetic \\
        training/loss=supervised train_dir=.train num_epochs=100

composes ``config/train_posenet.yaml`` with the same overrides as
``train.py`` and trains on the CUDA card (``device=cpu`` trains on the CPU).
"""
from __future__ import annotations

import logging
import sys

from pylidar_slam_tpu_torch.config import compose, dataclass_from_dict
from pylidar_slam_tpu_torch.dataset import DATASET
from pylidar_slam_tpu_torch.training.loss_modules import (PointToPlaneLossConfig,
                                                          SupervisedLossConfig)
from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig
from pylidar_slam_tpu_torch.training.trainer import ATrainerConfig, PoseNetTrainer
from pylidar_slam_tpu_torch.utils.build import REPO_ROOT

CONFIG_DIR = REPO_ROOT / "config"


def build_trainer(cfg: dict) -> PoseNetTrainer:
    dataset_loader = DATASET.load(dict(cfg["dataset"]))
    training = cfg.get("training", {})
    loss_dict = dict(training.get("loss", {}) or {})
    mode = loss_dict.get("mode", "supervised")
    loss_cls = SupervisedLossConfig if mode == "supervised" else PointToPlaneLossConfig
    loss_cfg = dataclass_from_dict(loss_cls, loss_dict)
    pred_cfg = dataclass_from_dict(PredictionConfig,
                                   dict(training.get("prediction", {}) or {}))
    trainer_cfg = dataclass_from_dict(ATrainerConfig, cfg)
    return PoseNetTrainer(trainer_cfg, pred_cfg, loss_cfg, dataset_loader)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(str(CONFIG_DIR), "train_posenet", argv)
    trainer = build_trainer(cfg)
    trainer.init()
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
