"""The port's PoseNet train steps against the JAX package's, on the CPU,
with seeded numpy inputs and the JAX side in float32
(``jax.enable_x64(False)``).  The trainer's epochs, batches, checkpoints
and entry point are in test_torch_training_loop.py, the deep odometry and
the PoseNet initialization in test_torch_training_deep.py.

Tolerances:
- train steps (PoseResNet-18 at 16x64, 512 padded points, batch 4, the
  setup of tests/test_parallel.py:71-98; from the same weights and
  batches; 1 and 3 steps of each optimizer, supervised with learned
  exponential weights and unsupervised; the JAX step is its trainer's
  ``value_and_grad`` of ``_loss_fn`` and its optax update):
  * the loss to 1e-4 relative;
  * each weight's update (after - before) to 1e-3 of its norm for sgd,
    whose step is lr * the momentum trace of the gradient, so the
    gradients' float32 rounding is all that differs (plus two ulps of each
    weight: a step under half an ulp leaves it where it was);
  * for adam, adamw and rmsprop the weights to 2.5 * lr * steps absolute:
    these normalise each gradient element by its own magnitude, so an
    element whose gradient is rounding noise moves by up to lr (rmsprop
    sqrt(10) * lr on its first step) in a direction the noise picks; the
    updates must still agree to 2e-2 of their norm;
  * the BatchNorm running statistics to 1e-4 of their scale after one step
    (the same forward), 1e-3 after three;
  * the unsupervised steps take radial normals (v / |v|) in both packages:
    the covariance normal map is held on its own in test_torch_posenet.py,
    where it is ill-conditioned on a few pixels;
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pylidar_slam_tpu.ops import geometry as jgeometry
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.training import loss_modules as jloss
from pylidar_slam_tpu.training import trainer as jtrainer
from pylidar_slam_tpu.training.prediction_modules import PredictionConfig as JPred

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import geometry as tgeometry
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.ops.rotation import np_euler_to_mat
from pylidar_slam_tpu_torch.training import loss_modules as tloss
from pylidar_slam_tpu_torch.training import trainer as ttrainer
from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig as TPred

REPO = Path(__file__).resolve().parents[1]
H, W, N_PTS, B = 16, 64, 512, 4
PROJ = (H, W, 3.0, -24.0)
LOSS_TOL = 1e-4
SGD_UPDATE_TOL = 1e-3
ADAPTIVE_PARAM_TOL = 2.5  # x lr x steps
ADAPTIVE_UPDATE_TOL = 2e-2
STATS_TOL = {1: 1e-4, 3: 1e-3}
OPTIMIZERS = ["adamw", "adam", "sgd", "rmsprop"]


class _Loader:
    def __init__(self, proj):
        self.proj = proj

    def projector(self):
        return self.proj

    def sequences(self):
        return (None, None), (None, None), (None, None), (lambda x: x)


def _radial_normals_jax(vm, kernel_size=5):
    r = jnp.linalg.norm(vm, axis=-1, keepdims=True)
    return jnp.where(r > 0, vm / jnp.where(r > 0, r, 1.0), 0.0)


def _radial_normals_torch(vm, kernel_size=5):
    r = torch.linalg.vector_norm(vm, dim=-1, keepdim=True)
    return torch.where(r > 0, vm / torch.where(r > 0, r, torch.ones_like(r)),
                       torch.zeros_like(vm))


def _batches(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        points = (rng.normal(size=(B, 2, N_PTS, 3)) * 10).astype(np.float32)
        masks = rng.uniform(size=(B, 2, N_PTS)) < 0.9
        gt = np.tile(np.eye(4), (B, 2, 1, 1))
        gt[:, 1, :3, :3] = np_euler_to_mat(rng.uniform(-0.1, 0.1, (B, 3)))
        gt[:, 1, :3, 3] = rng.uniform(-1.5, 1.5, (B, 3))
        out.append((points, masks, gt.astype(np.float32)))
    return out


def _loss_configs(mode):
    if mode == "supervised":
        kw = dict(with_exp_weights=True)
        return jloss.SupervisedLossConfig(**kw), tloss.SupervisedLossConfig(**kw)
    return jloss.PointToPlaneLossConfig(), tloss.PointToPlaneLossConfig()


def _jax_trainer(tmp, opt, mode):
    cfg = jtrainer.ATrainerConfig(train_dir=str(tmp / f"jax_{opt}_{mode}"), batch_size=B,
                                  num_points_padded=N_PTS, with_tensorboard=False,
                                  optimizer_type=opt)
    tr = jtrainer.PoseNetTrainer(cfg, JPred(), _loss_configs(mode)[0],
                                 _Loader(jproj.SphericalProjection(*PROJ)))
    tr.params, tr.batch_stats = tr.prediction.init_params(jax.random.PRNGKey(0),
                                                          (1, 2, 3, H, W))
    if mode == "supervised":
        tr.exp_s = jnp.asarray(tr.loss_config.init_weights, jnp.float32)
    tr.opt_state = tr.optimizer.init(tr._trainable())
    tr._build_steps()
    return tr


def _port_trainer(tmp, opt, mode, params, stats):
    cfg = ttrainer.ATrainerConfig(train_dir=str(tmp / f"port_{opt}_{mode}"), batch_size=B,
                                  num_points_padded=N_PTS, with_tensorboard=False,
                                  optimizer_type=opt, device="cpu")
    tr = ttrainer.PoseNetTrainer(cfg, TPred(), _loss_configs(mode)[1],
                                 _Loader(tproj.SphericalProjection(*PROJ)))
    load_jax_variables(tr.module, params, stats)
    tr._init_state()
    return tr


_NET = []


def _state_of(params, stats) -> dict:
    """A flax tree as the port module's state dict."""
    if not _NET:
        _NET.append(PoseResNet(PoseResNetConfig()))
    net = _NET[0]
    load_jax_variables(net, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


_RUNS = {}
_GRADS = {}


def _jax_step(jtr, mode):
    """The JAX trainer's train step: ``value_and_grad`` of its ``_loss_fn``
    (jitted once per loss mode and shared by the optimizers, whose trainers
    differ only in the optimizer) and its own optax update."""
    if mode not in _GRADS:
        _GRADS[mode] = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True),
                               static_argnums=(5,))
    grad_fn = _GRADS[mode]
    update = jax.jit(jtr.optimizer.update)

    def step(trainable, stats, opt_state, points, masks, gt):
        (loss, (_, new_stats)), grads = grad_fn(trainable, stats, points, masks, gt, True)
        updates, opt_state = update(grads, opt_state, trainable)
        return optax.apply_updates(trainable, updates), new_stats, opt_state, loss
    return step


def _run(opt, mode, tmp_path_factory):
    """The JAX and the port trainer's states after 1 and 3 steps (cached
    per optimizer and mode)."""
    key = (opt, mode)
    if key in _RUNS:
        return _RUNS[key]
    tmp = tmp_path_factory.mktemp(f"{opt}_{mode}")
    batches = _batches()
    patch = pytest.MonkeyPatch()
    patch.setattr(jgeometry, "compute_normal_map", _radial_normals_jax)
    patch.setattr(tgeometry, "compute_normal_map", _radial_normals_torch)
    try:
        with jax.enable_x64(False):
            jtr = _jax_trainer(tmp, opt, mode)
            init = (jax.tree_util.tree_map(np.asarray, jtr.params),
                    jax.tree_util.tree_map(np.asarray, jtr.batch_stats))
            ttr = _port_trainer(tmp, opt, mode, *init)
            trainable, stats, opt_state = jtr._trainable(), jtr.batch_stats, jtr.opt_state
            out = {0: {"state": _state_of(*init), "exp_s": np.asarray(
                tloss.SupervisedLossConfig().init_weights, np.float32)}}
            jstep = _jax_step(jtr, mode)
            for step, (points, masks, gt) in enumerate(batches, 1):
                trainable, stats, opt_state, jl = jstep(
                    trainable, stats, opt_state, jnp.asarray(points), jnp.asarray(masks),
                    jnp.asarray(gt))
                tl, _ = ttr._train_step(*(torch.from_numpy(a) for a in (points, masks, gt)))
                out[step] = {
                    "jax": {"loss": float(jl), "state": _state_of(trainable["params"], stats),
                            "exp_s": None if "exp_s" not in trainable
                            else np.asarray(trainable["exp_s"])},
                    "port": {"loss": float(tl),
                             "state": {k: v.detach().numpy().copy()
                                       for k, v in ttr.module.state_dict().items()},
                             "exp_s": None if ttr.exp_s is None
                             else ttr.exp_s.detach().numpy().copy()}}
    finally:
        patch.undo()
    _RUNS[key] = (out, jtr, trainable, stats, tmp)
    return _RUNS[key]


def _check_update(name, opt, before, ref, ours, lr, steps):
    d_ref, d_ours = ref - before, ours - before
    if opt == "sgd":
        # plus two float32 ulps of each weight: an sgd step below half an
        # ulp leaves the weight where it was
        bound = SGD_UPDATE_TOL * np.linalg.norm(d_ref) + np.linalg.norm(2 * np.spacing(ref))
        err = np.linalg.norm(d_ours - d_ref)
        assert err <= bound, f"{name}: update off by {err:.3e} (bound {bound:.3e})"
        return
    assert np.linalg.norm(d_ref) > 0, f"{name} did not move"
    rel = np.linalg.norm(d_ours - d_ref) / np.linalg.norm(d_ref)
    assert rel <= ADAPTIVE_UPDATE_TOL, f"{name}: update off by {rel:.3e} of its norm"
    err = np.abs(ours - ref).max()
    assert err <= ADAPTIVE_PARAM_TOL * lr * steps, f"{name}: {err:.3e} absolute"


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("mode", ["supervised", "unsupervised"])
@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_train_steps_match_jax(opt, mode, steps, tmp_path_factory):
    out, *_ = _run(opt, mode, tmp_path_factory)
    jax_s, port_s = out[steps]["jax"], out[steps]["port"]
    before = out[0]["state"]
    assert np.isfinite(port_s["loss"]) and port_s["loss"] > 0
    np.testing.assert_allclose(port_s["loss"], jax_s["loss"], rtol=LOSS_TOL)
    lr = ttrainer.ATrainerConfig().optimizer_learning_rate
    moved = sum(np.linalg.norm(ref - before[name]) for name, ref in jax_s["state"].items()
                if "running" not in name)
    assert moved > 0
    for name, ref in jax_s["state"].items():
        ours = port_s["state"][name]
        if "running" in name:
            scale = max(np.abs(ref).max(), 1e-12)
            err = np.abs(ours - ref).max() / scale
            assert err <= STATS_TOL[steps], f"{name}: {err:.3e} of its scale"
            continue
        _check_update(name, opt, before[name], ref, ours, lr, steps)
    if mode == "supervised":
        _check_update("exp_s", opt, out[0]["exp_s"], jax_s["exp_s"], port_s["exp_s"], lr,
                      steps)
