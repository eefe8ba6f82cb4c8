"""The port's PoseNet trainer, deep odometry and PoseNet initialization
against the JAX package's, on the CPU, with seeded numpy inputs and the JAX
side in float32 (``jax.enable_x64(False)``).

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
- ``_batches``: the same windows in the same order, bit for bit;
- the deep odometry and the PoseNet initialization over 5 frames, from a
  JAX-trained checkpoint carried into the port: the pose parameters to 1e-4
  of their scale (the forward's tolerance).
"""
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import train as jtrain_mod
from pylidar_slam_tpu import config as jconfig
from pylidar_slam_tpu.ops import geometry as jgeometry
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam import initialization as jinit
from pylidar_slam_tpu.slam.odometry import posenet_odometry as jpo
from pylidar_slam_tpu.training import loss_modules as jloss
from pylidar_slam_tpu.training import trainer as jtrainer
from pylidar_slam_tpu.training.prediction_modules import PredictionConfig as JPred

from pylidar_slam_tpu_torch import config as tconfig
from pylidar_slam_tpu_torch import train as ttrain_mod
from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import geometry as tgeometry
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.ops.rotation import np_euler_to_mat
from pylidar_slam_tpu_torch.slam import initialization as tinit
from pylidar_slam_tpu_torch.slam.odometry import posenet_odometry as tpo
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
# Inference from carried weights; the entry point
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A JAX-trained checkpoint (3 adamw steps), in the JAX package's
    train_dir and carried into a port train_dir."""
    _, jtr, trainable, stats, tmp = _run("adamw", "supervised", tmp_path_factory)
    jdir, tdir = Path(jtr.config.train_dir), tmp / "port_carried"
    jdir.mkdir(parents=True, exist_ok=True)
    jtr.params, jtr.batch_stats = trainable["params"], stats
    jtr.save_checkpoint()
    train_cfg = {"prediction": jtrainer._plain(jtr.prediction.config),
                 "projector": {"height": H, "width": W, "up_fov": 3.0, "down_fov": -24.0}}
    (jdir / "config.yaml").write_text(yaml.safe_dump(train_cfg))
    with open(jdir / "checkpoint.ckp", "rb") as f:
        state = pickle.load(f)
    net = PoseResNet(PoseResNetConfig())
    load_jax_variables(net, jax.tree_util.tree_map(np.asarray, state["params"]),
                       jax.tree_util.tree_map(np.asarray, state["batch_stats"]))
    tdir.mkdir()
    torch.save({"model": net.state_dict()}, tdir / "checkpoint.ckp")
    (tdir / "config.yaml").write_text(tconfig.dump_yaml(train_cfg))
    # de-calibrated beams: on the exact projector grid each point sits on a
    # pixel's rounding edge, where one ulp decides its pixel (ROADMAP.md §C2)
    loader = SyntheticDatasetLoader(SyntheticConfig(lidar_height=H, lidar_width=W,
                                                    num_frames=5, beam_jitter_deg=0.1))
    ds = loader.sequences()[0][0][0]
    frames = [np.asarray(ds[i]["numpy_pc"], np.float32) for i in range(5)]
    return jdir, tdir, frames


def _close_poses(ours, ref, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(ours - ref).max() / scale
    assert err <= 1e-4, f"{what}: {err:.3e} of the scale {scale:.3e}"


def test_posenet_odometry_matches_jax(carried):
    jdir, tdir, frames = carried
    with jax.enable_x64(False):
        jodom = jpo.PoseNetOdometry(jpo.PoseNetOdometryConfig(train_dir=str(jdir),
                                                              num_points_padded=N_PTS))
        for f in frames:
            jodom.process_next_frame({"numpy_pc": f})
        ref = np.asarray(jnp.concatenate(jodom._params_log))
        ref_rel = jodom.get_relative_poses()
    todom = tpo.PoseNetOdometry(tpo.PoseNetOdometryConfig(train_dir=str(tdir),
                                                          num_points_padded=N_PTS,
                                                          device="cpu"))
    for f in frames:
        d = {"numpy_pc": f}
        todom.process_next_frame(d)
        assert isinstance(d["odometry_pose"], torch.Tensor)
    ours = torch.stack(todom._params_log).numpy()
    assert ours.shape == (5, 6) and not ours[0].any()
    _close_poses(ours[1:], ref[1:], "pose params")
    rel = todom.get_relative_poses()
    assert rel.shape == (5, 4, 4) and rel.dtype == np.float32
    _close_poses(rel - np.eye(4), ref_rel - np.eye(4), "relative poses")


def test_posenet_initialization_matches_jax(carried):
    jdir, tdir, frames = carried
    proj = H, W, 3.0, -24.0
    with jax.enable_x64(False):
        jin = jinit.PoseNetInitialization(jinit.PNConfig(train_dir=str(jdir),
                                                         num_points_padded=N_PTS),
                                          projector=jproj.SphericalProjection(*proj))
        jin.init()
        ref = [jin.next_initial_pose({"numpy_pc": f}) for f in frames]
    loaded = tinit.INITIALIZATION.load({"type": "posenet", "train_dir": str(tdir),
                                        "num_points_padded": N_PTS},
                                       projector=tproj.SphericalProjection(*proj),
                                       device="cpu")
    assert isinstance(loaded, tinit.PoseNetInitialization)
    loaded.init()
    ours = [loaded.next_initial_pose({"numpy_pc": f}) for f in frames]
    assert ours[0] is None and ref[0] is None
    _close_poses(torch.stack(ours[1:]).numpy() - np.eye(4),
                 np.stack([np.asarray(r) for r in ref[1:]]) - np.eye(4), "priors")


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
