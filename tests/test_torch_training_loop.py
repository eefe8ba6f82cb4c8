"""The port's PoseNet trainer around its step, against the JAX package's
on the CPU: the same windows in the same order (``_batches``, bit for bit),
the learning-rate schedule, checkpoint resume, and the training entry point
(composed as ``train.py`` composes, and run as a module)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import train as jtrain_mod
from pylidar_slam_tpu import config as jconfig
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.training import loss_modules as jloss
from pylidar_slam_tpu.training import trainer as jtrainer
from pylidar_slam_tpu.training.prediction_modules import PredictionConfig as JPred

from test_torch_odometry import _one_torch_thread  # noqa: F401
from test_torch_training import H, N_PTS, PROJ, REPO, _batches, _Loader
from pylidar_slam_tpu_torch import config as tconfig
from pylidar_slam_tpu_torch import train as ttrain_mod
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.training import loss_modules as tloss
from pylidar_slam_tpu_torch.training import trainer as ttrainer
from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig as TPred


# ----------------------------------------------------------------------------
# Epochs, schedule, checkpoints
# ----------------------------------------------------------------------------

def _sequence(seed=0, frames=7):
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(frames):
        pts = rng.normal(size=(int(rng.integers(300, 700)), 4)).astype(np.float32) * 10
        pts[rng.uniform(size=len(pts)) < 0.05, 1] = np.nan
        pose = np.eye(4)
        pose[:3, 3] = [i * 1.1, 0.0, 0.0]
        seq.append({"numpy_pc": pts, "absolute_pose_gt": pose})
    return seq


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_match_jax(shuffle, tmp_path):
    seqs = [_sequence(0), _sequence(1, 5)]
    jcfg = jtrainer.ATrainerConfig(train_dir=str(tmp_path / "j"), num_points_padded=N_PTS)
    tcfg = ttrainer.ATrainerConfig(train_dir=str(tmp_path / "t"), num_points_padded=N_PTS,
                                   device="cpu", num_workers=3)
    jtr = jtrainer.PoseNetTrainer(jcfg, JPred(), jloss.SupervisedLossConfig(),
                                  _Loader(jproj.SphericalProjection(*PROJ)))
    ttr = ttrainer.PoseNetTrainer(tcfg, TPred(), tloss.SupervisedLossConfig(),
                                  _Loader(tproj.SphericalProjection(*PROJ)))
    ours = list(ttr._batches(seqs, 3, shuffle, np.random.default_rng(5)))
    ref = list(jtr._batches(seqs, 3, shuffle, np.random.default_rng(5)))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


class _SeqLoader(_Loader):
    def __init__(self):
        super().__init__(tproj.SphericalProjection(*PROJ))

    def sequences(self):
        return (([_sequence(0, 5)], ["s"]), ([_sequence(1, 3)], ["s"]), (None, None),
                lambda x: x)


def _tiny_trainer(train_dir, **kw):
    cfg = ttrainer.ATrainerConfig(train_dir=str(train_dir), batch_size=2, eval_batch_size=2,
                                  num_points_padded=N_PTS, with_tensorboard=False,
                                  device="cpu", average_meter_frequency=1, **kw)
    return ttrainer.PoseNetTrainer(cfg, TPred(), tloss.SupervisedLossConfig(
        with_exp_weights=True), _SeqLoader())


def test_learning_rate_follows_the_schedule(tmp_path, monkeypatch):
    tr = _tiny_trainer(tmp_path, optimizer_scheduler_milestones=2, do_eval=False)
    tr.init()
    seen = []
    monkeypatch.setattr(tr, "_train_step", lambda *a: (
        seen.append(tr.optimizer.param_groups[0]["lr"]) or (torch.ones(()), {})))
    tr.train(5)
    lr_for_epoch = jtrainer.make_optimizer(jtrainer.ATrainerConfig(
        optimizer_scheduler_milestones=2)).lr_for_epoch
    expected = [lr_for_epoch(e) for e in range(5) for _ in range(2)]  # 2 steps per epoch
    assert seen == pytest.approx(expected, rel=1e-12)
    assert expected[0] == 1e-4 and expected[-1] == 2.5e-5


def test_checkpoint_resume(tmp_path):
    tr = _tiny_trainer(tmp_path)
    tr.init()
    tr.train(1)
    assert (tmp_path / "checkpoint.ckp").exists()
    cfg = tconfig.load_yaml_file(tmp_path / "config.yaml")
    assert cfg["projector"]["height"] == H and cfg["loss"]["with_exp_weights"] is True
    resumed = _tiny_trainer(tmp_path)
    resumed.init()
    # the checkpoint is written before the epoch's evaluation, as in the JAX package
    assert (resumed.num_train_epochs, resumed.train_iter, resumed.eval_iter) == (1, 2, 0)
    assert tr.eval_iter == 1
    for (k, a), b in zip(tr.module.state_dict().items(), resumed.module.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(tr.exp_s, resumed.exp_s)
    moments = [(s["exp_avg"], s["exp_avg_sq"]) for s in tr.optimizer.state.values()]
    assert len(moments) == len(resumed._trainable())
    for p, q in zip(tr._trainable(), resumed._trainable()):
        a, b = tr.optimizer.state[p], resumed.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert float(a["step"]) == float(b["step"]) == 2
    # the next step from either is the same step
    batch = [torch.from_numpy(a) for a in _batches(seed=3, steps=1)[0]]
    tr._train_step(*batch)
    resumed._train_step(*batch)
    for a, b in zip(tr._trainable(), resumed._trainable()):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# The entry point
# ----------------------------------------------------------------------------

TRAIN_OVERRIDES = ["dataset=synthetic", "dataset.num_frames=4", "dataset.lidar_height=16",
                   "dataset.lidar_width=64", "num_epochs=1", "batch_size=2",
                   "num_points_padded=1024", "training/loss=unsupervised"]


def test_train_entry_point_composes_like_train_py(tmp_path, monkeypatch):
    argv = TRAIN_OVERRIDES + [f"train_dir={tmp_path}"]
    ours = tconfig.compose(str(REPO / "config"), "train_posenet", argv)
    ref = jconfig.compose(str(REPO / "config"), "train_posenet", argv)
    assert ours == ref
    jtr = jtrain_mod.build_trainer(ref)
    # the card by default: no card here, so the port's trainer raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        ttrain_mod.build_trainer(ours)
    ttr = ttrain_mod.build_trainer(dict(ours, device="cpu"))
    plain_j, plain_t = jtrainer._plain(jtr.config), ttrainer._plain(ttr.config)
    assert dict(plain_j, device="cpu") == plain_t
    assert jtrainer._plain(jtr.loss_config) == ttrainer._plain(ttr.loss_config)
    assert jtrainer._plain(jtr.prediction.config) == ttrainer._plain(ttr.prediction.config)
    assert not ttr.is_supervised and ttr.proj == tproj.SphericalProjection(16, 64, 3, -24)


def test_train_module_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pylidar_slam_tpu_torch.train", *TRAIN_OVERRIDES,
         "device=cpu", "with_tensorboard=false", f"train_dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training on cpu" in proc.stderr
    state = torch.load(tmp_path / "checkpoint.ckp", weights_only=True)
    assert state["num_train_epochs"] == 1 and state["train_iter"] == 1
    assert tconfig.load_yaml_file(tmp_path / "config.yaml")["trainer"]["device"] == "cpu"
