"""The JAX trainer's ``checkpoint.ckp`` read by the port without JAX, on the
CPU: the JAX trainer takes one step and writes its pickle; the port reads
it with JAX, flax and optax blocked, regresses the JAX deep odometry's
poses from it, and resumes training from it -- the weights, exp_s,
optax's moments, the injected learning rate and the counters -- so that
its next step is the JAX trainer's next step.

Bars: the pose parameters to 1e-4 of their scale
(tests/test_torch_training_deep.py), the resumed step at the one-step bars
of tests/test_torch_training.py.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pylidar_slam_tpu.slam.odometry import posenet_odometry as jpo
from pylidar_slam_tpu.training import trainer as jtrainer

from test_torch_odometry import _one_torch_thread  # noqa: F401
from test_torch_training import (H, N_PTS, OPTIMIZERS, PROJ, REPO, STATS_TOL, W, _batches,
                                 _check_update, _jax_step, _jax_trainer, _Loader, _state_of)
from test_torch_training_deep import _close_poses
from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
from pylidar_slam_tpu_torch.models.from_jax import read_jax_checkpoint
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.slam.odometry import posenet_odometry as tpo
from pylidar_slam_tpu_torch.training import loss_modules as tloss
from pylidar_slam_tpu_torch.training import trainer as ttrainer
from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig as TPred

LOSS_TOL = 1e-4
LR_DECAY = 0.5  # the injected learning rate at the checkpoint: a milestone passed

_SAVED = {}


def _saved(opt, tmp_path_factory):
    """The JAX trainer after one supervised step, its injected learning rate
    halved, its checkpoint written (train_iter 1, epoch 1); and its second
    step.  Cached per optimizer."""
    if opt in _SAVED:
        return _SAVED[opt]
    tmp = tmp_path_factory.mktemp(f"jax_ckpt_{opt}")
    (points0, masks0, gt0), (points1, masks1, gt1) = _batches(seed=3, steps=2)
    with jax.enable_x64(False):
        jtr = _jax_trainer(tmp, opt, "supervised")
        step = _jax_step(jtr, "supervised")
        trainable, stats, opt_state, _ = step(
            jtr._trainable(), jtr.batch_stats, jtr.opt_state, jnp.asarray(points0),
            jnp.asarray(masks0), jnp.asarray(gt0))
        lr = jtrainer.ATrainerConfig().optimizer_learning_rate * LR_DECAY
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        jtr._set_trainable(trainable)
        jtr.batch_stats, jtr.opt_state = stats, opt_state
        jtr.num_train_epochs, jtr.train_iter, jtr.eval_iter = 1, 1, 0
        jtr.save_checkpoint()
        after, stats2, _, loss2 = step(trainable, stats, opt_state, jnp.asarray(points1),
                                       jnp.asarray(masks1), jnp.asarray(gt1))
    jdir = Path(jtr.config.train_dir)
    (jdir / "config.yaml").write_text(yaml.safe_dump({
        "prediction": jtrainer._plain(jtr.prediction.config),
        "projector": {"height": H, "width": W, "up_fov": PROJ[2], "down_fov": PROJ[3]}}))
    _SAVED[opt] = {
        "dir": jdir, "lr": lr, "batch": (points1, masks1, gt1),
        "before": _state_of(trainable["params"], stats),
        "before_exp_s": np.asarray(trainable["exp_s"]),
        "after": _state_of(after["params"], stats2), "after_exp_s": np.asarray(after["exp_s"]),
        "loss": float(loss2)}
    return _SAVED[opt]


def test_read_without_jax(tmp_path_factory):
    """A process in which jax, flax and optax cannot be imported reads the
    checkpoint: the same trees and counters as the JAX package's own
    unpickling."""
    saved = _saved("rmsprop", tmp_path_factory)
    path = saved["dir"] / "checkpoint.ckp"
    code = (
        "import sys, json\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from pylidar_slam_tpu_torch.models.from_jax import read_jax_checkpoint\n"
        f"st = read_jax_checkpoint({str(path)!r})\n"
        "leaves = []\n"
        "def walk(x, key=''):\n"
        "    if isinstance(x, dict):\n"
        "        for k in sorted(x): walk(x[k], key + '/' + k)\n"
        "    elif isinstance(x, tuple):\n"
        "        for i, v in enumerate(x): walk(v, key + '/' + type(x).__name__ + str(i))\n"
        "    elif x is not None:\n"
        "        a = np.asarray(x); leaves.append([key, str(a.dtype), list(a.shape), float(a.sum())])\n"
        "walk({k: st[k] for k in ('params', 'batch_stats', 'exp_s', 'opt_state')})\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print(json.dumps({'leaves': leaves, 'counters': [st['num_train_epochs'],\n"
        "    st['train_iter'], st['eval_iter']], 'lr': float(st['opt_state'].hyperparams\n"
        "    ['learning_rate']), 'inner': [type(s).__name__ for s in st['opt_state'].inner_state]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["counters"] == [1, 1, 0]
    assert out["lr"] == pytest.approx(saved["lr"], rel=1e-7)
    assert out["inner"] == ["ScaleByRmsState", "EmptyState",
                            "TraceState"]
    with open(path, "rb") as f:
        ref = pickle.load(f)  # the JAX package's own read, optax imported
    leaves = jax.tree_util.tree_leaves_with_path(
        {k: ref[k] for k in ("params", "batch_stats", "exp_s", "opt_state")})
    assert len(out["leaves"]) == len(leaves) > 100
    sums = sorted(round(v[3], 3) for v in out["leaves"])
    assert sums == sorted(round(float(np.asarray(x).sum()), 3) for _, x in leaves)


def test_flax_frozen_dicts_read_as_dicts(tmp_path_factory, tmp_path):
    """An older flax wrote its trees as FrozenDicts: they read as dicts."""
    from flax.core import FrozenDict
    saved = _saved("adam", tmp_path_factory)
    with open(saved["dir"] / "checkpoint.ckp", "rb") as f:
        state = pickle.load(f)
    state["params"] = FrozenDict(state["params"])
    state["batch_stats"] = FrozenDict(state["batch_stats"])
    path = tmp_path / "checkpoint.ckp"
    with open(path, "wb") as f:
        pickle.dump(state, f)
    st = read_jax_checkpoint(path)
    assert type(st["params"]) is dict and type(st["params"]["ResNetEncoder_0"]) is dict
    assert np.array_equal(st["params"]["fc_rot"]["kernel"],
                          np.asarray(state["params"]["fc_rot"]["kernel"]))


def test_unknown_global_is_refused(tmp_path):
    """Nothing but numpy arrays, builtins and JAX/flax/optax state classes:
    any other global is refused before it is called."""
    path = tmp_path / "checkpoint.ckp"
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "hook": Path("x")}, f)
    with pytest.raises(pickle.UnpicklingError, match="pathlib.*refused"):
        read_jax_checkpoint(path)

    class Evil:
        def __reduce__(self):
            return (os.system, ("touch " + str(tmp_path / "ran"),))
    with open(path, "wb") as f:
        pickle.dump({"params": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refused"):
        read_jax_checkpoint(path)
    assert not (tmp_path / "ran").exists()


def test_deep_odometry_from_a_jax_checkpoint(tmp_path_factory):
    """The port's PoseNetOdometry on the JAX train_dir as it is, against the
    JAX package's PoseNetOdometry on the same directory."""
    jdir = _saved("adamw", tmp_path_factory)["dir"]
    loader = SyntheticDatasetLoader(SyntheticConfig(lidar_height=H, lidar_width=W,
                                                    num_frames=5, beam_jitter_deg=0.1))
    ds = loader.sequences()[0][0][0]
    frames = [np.asarray(ds[i]["numpy_pc"], np.float32) for i in range(5)]
    with jax.enable_x64(False):
        jodom = jpo.PoseNetOdometry(jpo.PoseNetOdometryConfig(train_dir=str(jdir),
                                                              num_points_padded=N_PTS))
        for f in frames:
            jodom.process_next_frame({"numpy_pc": f})
        ref = np.asarray(jnp.concatenate(jodom._params_log))
    todom = tpo.PoseNetOdometry(tpo.PoseNetOdometryConfig(
        train_dir=str(jdir), num_points_padded=N_PTS, device="cpu"))
    for f in frames:
        todom.process_next_frame({"numpy_pc": f})
    ours = torch.stack(todom._params_log).numpy()
    assert ours.shape == (5, 6)
    _close_poses(ours[1:], ref[1:], "pose params")


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_resumed_step_matches_jax(opt, tmp_path_factory, tmp_path):
    """The port's trainer, pointed at the JAX train_dir, restores it on init
    and takes the JAX trainer's second step."""
    saved = _saved(opt, tmp_path_factory)
    cfg = ttrainer.ATrainerConfig(train_dir=str(tmp_path), batch_size=4,
                                  num_points_padded=N_PTS, with_tensorboard=False,
                                  optimizer_type=opt, device="cpu")
    (tmp_path / "checkpoint.ckp").write_bytes((saved["dir"] / "checkpoint.ckp").read_bytes())
    tr = ttrainer.PoseNetTrainer(cfg, TPred(), tloss.SupervisedLossConfig(with_exp_weights=True),
                                 _Loader(tproj.SphericalProjection(*PROJ)))
    tr.init()
    assert (tr.num_train_epochs, tr.train_iter, tr.eval_iter) == (1, 1, 0)
    assert [g["lr"] for g in tr.optimizer.param_groups] == [pytest.approx(saved["lr"])]
    loaded = {k: v.numpy() for k, v in tr.module.state_dict().items()}
    for name, ref in saved["before"].items():
        assert np.array_equal(loaded[name], ref), name
    assert np.array_equal(tr.exp_s.detach().numpy(), saved["before_exp_s"])
    assert len(tr.optimizer.state) == len(tr._trainable())

    loss, _ = tr._train_step(*(torch.from_numpy(a) for a in saved["batch"]))
    np.testing.assert_allclose(float(loss), saved["loss"], rtol=LOSS_TOL)
    ours = {k: v.detach().numpy() for k, v in tr.module.state_dict().items()}
    for name, ref in saved["after"].items():
        if "running" in name:
            err = np.abs(ours[name] - ref).max() / max(np.abs(ref).max(), 1e-12)
            assert err <= STATS_TOL[1], f"{name}: {err:.3e} of its scale"
            continue
        if "num_batches" in name:
            continue
        _check_update(name, opt, saved["before"][name], ref, ours[name], saved["lr"], 1)
    _check_update("exp_s", opt, saved["before_exp_s"], saved["after_exp_s"],
                  tr.exp_s.detach().numpy(), saved["lr"], 1)
