"""The port's multi-rank execution against the JAX package's multi-device
one, on the CPU: ranks are processes spawned over gloo
(``parallel.launch.run_ranks``, a file rendezvous per test), the JAX side
runs on the virtual 8-device mesh (tests/conftest.py).

* the layout helpers and the tensor-parallel leaf rule on
  tests/test_parallel.py's shapes and on PoseResNet-18's weights;
* the point-sharded GN step on 2 and 4 ranks against JAX's on a 2- and
  4-device mesh and against the unsharded step (atol 1e-4, as
  tests/test_parallel.py), bit-identical on every rank;
* ``shard_points=2`` surfel odometry on tests/test_parallel.py's setup
  (32x256, 6 frames) against the port's unsharded run (exact and hash NN
  5e-4, knn normals 3e-2, as there), both ranks bit for bit; and against
  JAX's ``shard_points=2`` run on tests/test_torch_surfel.py's setup
  (de-calibrated beams: on exact pixel-center beams a one-ulp atan2
  difference decides the pixel of every point, and the unsharded port
  already leaves JAX there) at that file's bars for frames 0-6, 2.5e-3 m
  and 1e-3 rad;
* one supervised train step of PoseResNet-18 with dp=2, tp=2 and dp=2 x
  tp=2 against the JAX package's step on the same global batch with the
  same carried weights (loss rtol 1e-4 as tests/test_parallel.py; each
  weight's sgd update within 1e-3 of its norm and the BatchNorm statistics
  within 1e-4, tests/test_torch_training.py's one-step bars) and against
  the port's one-process step;
* BatchNorm2d over a dp group normalizes with the global batch's
  statistics (and per-rank statistics would not pass);
* ``parallel_jobs=2`` through the port's CLI: each job's poses equal to the
  job run alone.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticSequence
from pylidar_slam_tpu.ops import optimization as jopt, se3 as jse3
from pylidar_slam_tpu.ops.projection import SphericalProjection as JProj
from pylidar_slam_tpu.parallel import make_mesh, point_sharded_gauss_newton_step
from pylidar_slam_tpu.parallel.mesh import factorize_two as jfactorize_two
from pylidar_slam_tpu.parallel.tp import leaf_sharding
from pylidar_slam_tpu.slam.odometry.icp_odometry import (ICPFrameToModel as JICP,
                                                         ICPFrameToModelConfig as JICPConfig)
from pylidar_slam_tpu.training import loss_modules as jloss
from pylidar_slam_tpu.training import trainer as jtrainer
from pylidar_slam_tpu.training.prediction_modules import PredictionConfig as JPred

import torch_parallel_workers as workers
from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import optimization as topt
from pylidar_slam_tpu_torch.parallel.launch import run_ranks
from pylidar_slam_tpu_torch.parallel.mesh import factorize_two
from pylidar_slam_tpu_torch.parallel.tp import flax_shape, leaf_split

GN_ATOL = 1e-4
SHARD_TOL = {"exact": 5e-4, "hash": 5e-4, "knn": 3e-2}
JAX_SURFEL_TOL = dict(trans=2.5e-3, rot=1e-3)  # tests/test_torch_surfel.py TIGHT
CHAMPION_PROJ = (32, 256)
LOSS_RTOL = 1e-4
SGD_UPDATE_TOL = 1e-3
STATS_TOL = 1e-4
# the dp/tp step and the one-process port step: the same float32 sums in
# another order (BatchNorm's sums per rank, the tp all-reduces)
PORT_LOSS_RTOL = 1e-5
BN_TOL = 1e-5
TRAIN_PROJ = (16, 64, 3.0, -24.0)
SURFEL_LOCAL_MAPS = {
    "exact": dict(nn_backend="exact", normals_mode="image"),
    "hash": dict(nn_backend="hash", normals_mode="image"),
    "knn": dict(nn_backend="exact", normals_mode="knn"),
}
_SURFEL_BASE = {"type": "kdtree_local_map", "local_map_size": 4, "points_per_frame": 512,
                "target_samples": 2048, "hash_capacity": 256, "hash_buckets": 1024}


def _local_map(name):
    return dict(_SURFEL_BASE, **SURFEL_LOCAL_MAPS[name])


# ----------------------------------------------------------------------------
# inputs, made once
# ----------------------------------------------------------------------------

def _gn_inputs():
    """tests/test_parallel.py's GN inputs: 1024 points moved by a known pose."""
    rng = np.random.default_rng(0)
    n = 128 * 8
    gt_params = jnp.asarray(rng.uniform(-0.1, 0.1, (6,)), jnp.float32)
    ref = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
    normals = rng.normal(size=(n, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    inv = jse3.inverse_pose_matrix(jse3.build_pose_matrix(gt_params[None]))[0]
    target = np.asarray(jse3.apply_transformation(jnp.asarray(ref), inv), np.float32)
    return target, ref, normals, np.ones((n,), bool)


def _surfel_frames():
    seq = SyntheticSequence(SyntheticConfig(lidar_height=32, lidar_width=256, num_frames=6),
                            "synth_00", seed=0)
    return [{"numpy_pc": np.asarray(seq[i]["numpy_pc"], np.float32)} for i in range(6)]


def _champion_setup(shard):
    """tests/test_torch_surfel.py's setup: the surfel champion at 32x256,
    K = 4 x S = 512, M = 2048, image normals, on 7 de-calibrated frames:
    (port config, JAX config, projection, frames)."""
    import dataclasses

    from pylidar_slam_tpu.eval import acceptance as jacc
    from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticConfig as TCfg
    from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticDatasetLoader as TLoader
    from pylidar_slam_tpu_torch.eval import acceptance as tacc
    h, w = CHAMPION_PROJ
    loader = TLoader(TCfg(**dict(tacc.SEQ_KW, lidar_height=h, lidar_width=w, num_frames=7,
                                 beam_jitter_deg=0.1)))
    ds = loader.sequences()[0][0][0]
    lm = dict(local_map_size=4, points_per_frame=512, target_samples=2048,
              normals_mode="image")
    t, j = tacc.champion_configs()["surfel"], jacc.champion_configs()["surfel"]
    t = dataclasses.replace(t, local_map=dict(t.local_map, **lm), num_points_padded=h * w,
                            device="cpu", shard_points=shard)
    j = dataclasses.replace(j, local_map=dict(j.local_map, **lm), num_points_padded=h * w,
                            shard_points=shard)
    return t, j, tuple(loader.projector()), [ds[i] for i in range(7)]


def _train_batch():
    from pylidar_slam_tpu_torch.ops.rotation import np_euler_to_mat
    rng = np.random.default_rng(0)
    points = (rng.normal(size=(4, 2, 512, 3)) * 10).astype(np.float32)
    masks = rng.uniform(size=(4, 2, 512)) < 0.9
    gt = np.tile(np.eye(4), (4, 2, 1, 1))
    gt[:, 1, :3, :3] = np_euler_to_mat(rng.uniform(-0.1, 0.1, (4, 3)))
    gt[:, 1, :3, 3] = rng.uniform(-1.5, 1.5, (4, 3))
    return points, masks, gt.astype(np.float32)


class _JLoader:
    def projector(self):
        return JProj(*TRAIN_PROJ)

    def sequences(self):
        return (None, None), (None, None), (None, None), (lambda x: x)


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    """The JAX package's supervised sgd step on the global batch, from its
    own initialisation: (params, batch_stats) before it as numpy trees, and
    the loss, weights and exp_s after it."""
    tmp = tmp_path_factory.mktemp("jax_train")
    with jax.enable_x64(False):
        cfg = jtrainer.ATrainerConfig(train_dir=str(tmp), batch_size=4, num_points_padded=512,
                                      with_tensorboard=False, optimizer_type="sgd",
                                      optimizer_learning_rate=1e-2)
        tr = jtrainer.PoseNetTrainer(cfg, JPred(),
                                     jloss.SupervisedLossConfig(with_exp_weights=True),
                                     _JLoader())
        tr.params, tr.batch_stats = tr.prediction.init_params(
            jax.random.PRNGKey(0), (1, 2, 3, *TRAIN_PROJ[:2]))
        tr.exp_s = jnp.asarray(tr.loss_config.init_weights, jnp.float32)
        tr.opt_state = tr.optimizer.init(tr._trainable())
        tr._build_steps()
        before = (jax.tree_util.tree_map(np.asarray, tr.params),
                  jax.tree_util.tree_map(np.asarray, tr.batch_stats))
        trainable, stats, _, loss, _ = tr._train_step(
            tr._trainable(), tr.batch_stats, tr.opt_state,
            *(jnp.asarray(a) for a in _train_batch()))
        after = (jax.tree_util.tree_map(np.asarray, trainable["params"]),
                 jax.tree_util.tree_map(np.asarray, stats))
    return {"before": before, "loss": float(loss), "after": _port_state(*after),
            "before_state": _port_state(*before), "exp_s": np.asarray(trainable["exp_s"])}


def _port_state(params, stats) -> dict:
    from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
    net = load_jax_variables(PoseResNet(PoseResNetConfig()), params, stats)
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def _train_args(tmp, tp, jax_train):
    return (str(tmp), TRAIN_PROJ, tp, *jax_train["before"], _train_batch(), 1e-2)


@pytest.fixture(scope="module")
def bn_input():
    # the two halves of the batch drawn with other means and scales, so
    # per-half statistics are far from the whole batch's
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 5, 6)).astype(np.float32)
    x[2:] = x[2:] * 3.0 + 2.0
    return x


def _surfel_runs(shard):
    runs = {name: (workers.surfel_config(_local_map(name), shard), workers.SURFEL_PROJ,
                   _surfel_frames()) for name in SURFEL_LOCAL_MAPS}
    t, _, proj, frames = _champion_setup(shard)
    runs["champion"] = (t, proj, frames)
    return runs


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, jax_train, bn_input):
    tmp = tmp_path_factory.mktemp("ranks2")
    train = [_train_args(tmp / "dp", 1, jax_train), _train_args(tmp / "tp", 2, jax_train)]
    return run_ranks(workers.two_ranks, 2, tmp, _gn_inputs(), _surfel_runs(2),
                     train, bn_input, threads=1)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, jax_train):
    tmp = tmp_path_factory.mktemp("ranks4")
    return run_ranks(workers.four_ranks, 4, tmp, _gn_inputs(),
                     _train_args(tmp / "dp_tp", 2, jax_train), threads=1)


@pytest.fixture(scope="module")
def port_train(tmp_path_factory, jax_train):
    """The port's one-process step from the same weights on the same batch."""
    tr = workers.make_trainer(tmp_path_factory.mktemp("port_train"), TRAIN_PROJ,
                              params=jax_train["before"][0], stats=jax_train["before"][1])
    return workers.step_result(tr, _train_batch())


# ----------------------------------------------------------------------------
# layout and leaf rule
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 12, 16])
def test_factorize_two(n):
    assert factorize_two(n) == jfactorize_two(n)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (16, 7), (7,), (), (7, 7, 6, 64),
                                   (512, 3), (1, 1, 64, 128)])
def test_tp_leaf_rule_matches_jax(shape):
    spec = leaf_sharding(shape, make_mesh([("dp", 4), ("tp", 2)])).spec
    d = leaf_split(shape, 2)
    assert tuple(spec) == (() if d is None else tuple(
        "tp" if i == d else None for i in range(len(shape))))


def test_tp_rule_splits_the_jax_leaves_of_poseresnet():
    """Each port weight, read in its flax layout, is one of the JAX tree's
    leaves, and the multiset of (shape, split) is the JAX package's."""
    from pylidar_slam_tpu.models.posenet import PoseResNet as JPoseResNet
    from pylidar_slam_tpu.models.posenet import PoseResNetConfig as JCfg
    with jax.enable_x64(False):  # the tree's shapes, without running the init
        variables = jax.eval_shape(lambda: JPoseResNet(JCfg()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, 16, 64)), train=False))
    mesh = make_mesh([("dp", 4), ("tp", 2)])
    ref = sorted((tuple(leaf.shape), tuple(leaf_sharding(leaf.shape, mesh).spec))
                 for leaf in jax.tree_util.tree_leaves(variables["params"]))
    ours = []
    for p in PoseResNet(PoseResNetConfig()).parameters():
        shape = flax_shape(p)
        d = leaf_split(shape, 2)
        ours.append((shape, () if d is None else tuple(
            "tp" if i == d else None for i in range(len(shape)))))
    assert sorted(ours) == ref


# ----------------------------------------------------------------------------
# the point-sharded GN step
# ----------------------------------------------------------------------------

def _jax_gn(n_dev):
    target, ref, normals, mask = (jnp.asarray(a) for a in _gn_inputs())
    with jax.enable_x64(False):
        mesh = make_mesh([("sp", n_dev)], devices=jax.devices()[:n_dev])
        dx, loss = point_sharded_gauss_newton_step(mesh, axis="sp")(
            jnp.zeros(6), target, ref, normals, mask)
    return np.asarray(dx), float(loss)


def _unsharded_gn():
    target, ref, normals, mask = (torch.from_numpy(a) for a in _gn_inputs())
    res, jac = topt.point_to_plane_at_identity(target, ref, normals, mask)
    dx, loss, _ = topt.gauss_newton_step(res, jac, torch.ones(len(res)))
    return dx.numpy(), float(loss)


@pytest.mark.parametrize("world", [2, 4])
def test_point_sharded_gn_matches_jax_and_unsharded(world, request):
    results = request.getfixturevalue(f"ranks{world}")
    dxs = [r["gn"][0] for r in results]
    for dx in dxs[1:]:  # every rank steps its own copy of the pose
        assert np.array_equal(dx.view(np.int32), dxs[0].view(np.int32))
    jdx, jloss_ = _jax_gn(world)
    np.testing.assert_allclose(dxs[0], jdx, atol=GN_ATOL)
    np.testing.assert_allclose(results[0]["gn"][1], jloss_, rtol=1e-4)
    udx, _ = _unsharded_gn()
    np.testing.assert_allclose(dxs[0], udx, atol=GN_ATOL)


def test_gauss_newton_step_packs_one_all_reduce(monkeypatch):
    """With a group, the step's (6,6)+(6,)+() payload is ONE all-reduce."""
    calls = []
    monkeypatch.setattr(topt.dist, "all_reduce",
                        lambda t, group=None: calls.append(tuple(t.shape)))
    target, ref, normals, mask = (torch.from_numpy(a) for a in _gn_inputs())
    res, jac = topt.point_to_plane_at_identity(target, ref, normals, mask)
    topt.gauss_newton_step(res, jac, torch.ones(len(res)), group=object())
    assert calls == [(43,)]


# ----------------------------------------------------------------------------
# shard_points surfel odometry
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SURFEL_LOCAL_MAPS))
def test_shard_points_surfel_matches_unsharded(name, ranks2):
    sharded = [r["surfel"][name] for r in ranks2]
    assert np.array_equal(sharded[0], sharded[1])  # both ranks, bit for bit
    alone = workers.odometry_runs(0, 1, {name: _surfel_runs(0)[name]})[name]
    assert sharded[0].shape == alone.shape
    np.testing.assert_allclose(sharded[0], alone, atol=SHARD_TOL[name])


def test_shard_points_surfel_matches_jax(ranks2):
    from test_torch_odometry import _pose_errors
    _, j, proj, frames = _champion_setup(2)
    with jax.enable_x64(False):
        odom = JICP(j, projector=JProj(*proj))
        odom.init()
        last = np.eye(4, dtype=np.float32)
        for f in frames:
            d = dict(f, init_rpose=last)
            odom.process_next_frame(d)
            last = d.get("odometry_pose", last)
        odom.finish()
        jp = odom.get_relative_poses()
    trans, rot = _pose_errors(ranks2[0]["surfel"]["champion"], jp)
    assert trans.max() < JAX_SURFEL_TOL["trans"] and rot.max() < JAX_SURFEL_TOL["rot"], \
        (trans, rot)


def test_shard_points_needs_the_ranks():
    with pytest.raises(AssertionError, match="shard_points=2"):
        workers.odometry_runs(0, 1, {"x": _surfel_runs(2)["exact"]})


# ----------------------------------------------------------------------------
# data- and tensor-parallel training
# ----------------------------------------------------------------------------

def _check_step(ours, ref, before, exp_s_ref, loss_ref, loss_rtol, update_tol, stats_tol):
    np.testing.assert_allclose(ours["loss"], loss_ref, rtol=loss_rtol)
    for name, r in ref.items():
        o = ours["state"][name]
        if "running" in name:
            err = np.abs(o - r).max() / max(np.abs(r).max(), 1e-12)
            assert err <= stats_tol, f"{name}: {err:.3e} of its scale"
            continue
        d_ref, d_ours = r - before[name], o - before[name]
        bound = update_tol * np.linalg.norm(d_ref) + np.linalg.norm(2 * np.spacing(r))
        err = np.linalg.norm(d_ours - d_ref)
        assert err <= bound, f"{name}: update off by {err:.3e} (bound {bound:.3e})"
    np.testing.assert_allclose(ours["exp_s"], exp_s_ref, rtol=1e-5)


def _layouts(ranks2, ranks4):
    return {"dp2": [r["dp"] for r in ranks2], "tp2": [r["tp"] for r in ranks2],
            "dp2_tp2": [r["dp_tp"] for r in ranks4]}


@pytest.mark.parametrize("layout", ["dp2", "tp2", "dp2_tp2"])
def test_parallel_train_step_matches_jax(layout, ranks2, ranks4, jax_train, port_train):
    results = _layouts(ranks2, ranks4)[layout]
    for r in results[1:]:  # every rank ends with the same weights
        assert r["loss"] == results[0]["loss"]
        for k, v in r["state"].items():
            assert np.array_equal(v, results[0]["state"][k]), k
    ours = results[0]
    assert bool(ours["split"]) == ("tp" in layout)
    _check_step(ours, jax_train["after"], jax_train["before_state"], jax_train["exp_s"],
                jax_train["loss"], LOSS_RTOL, SGD_UPDATE_TOL, STATS_TOL)
    _check_step(ours, port_train["state"], jax_train["before_state"], port_train["exp_s"],
                port_train["loss"], PORT_LOSS_RTOL, SGD_UPDATE_TOL, STATS_TOL)


def test_batchnorm_takes_the_global_batch_statistics(ranks2, bn_input):
    from pylidar_slam_tpu_torch.models.resnet import BatchNorm2d
    bn = BatchNorm2d(bn_input.shape[1])
    bn.train()
    whole = bn(torch.from_numpy(bn_input)).detach().numpy()
    ours = np.concatenate([r["bn"]["global"]["y"] for r in ranks2])
    np.testing.assert_allclose(ours, whole, atol=BN_TOL)
    for r in ranks2:
        np.testing.assert_allclose(r["bn"]["global"]["running_mean"], bn.running_mean.numpy(),
                                   atol=BN_TOL)
        np.testing.assert_allclose(r["bn"]["global"]["running_var"], bn.running_var.numpy(),
                                   atol=BN_TOL)
    # normalizing each rank's slice alone is a different step
    per_rank = np.concatenate([r["bn"]["per_rank"]["y"] for r in ranks2])
    assert np.abs(per_rank - whole).max() > 100 * BN_TOL


def test_one_rank_is_the_plain_step(tmp_path, port_train, jax_train):
    """data_parallel and tensor_parallel=2 without a process group of more
    than one rank: the plain step, as the JAX package's n_dev > 1 guard."""
    for kw in (dict(data_parallel=True), dict(tp=2)):
        tr = workers.make_trainer(tmp_path / str(kw), TRAIN_PROJ, params=jax_train["before"][0],
                                  stats=jax_train["before"][1], **kw)
        assert tr._mesh is None
        out = workers.step_result(tr, _train_batch())
        assert out["loss"] == port_train["loss"]
        for k, v in out["state"].items():
            assert np.array_equal(v, port_train["state"][k]), k


# ----------------------------------------------------------------------------
# parallel CLI jobs
# ----------------------------------------------------------------------------

MULTIRUN = ["dataset=synthetic", "dataset.num_frames=6", "dataset.lidar_height=32",
            "dataset.lidar_width=256", "slam.odometry.max_num_alignments=2",
            "slam.odometry.num_points_padded=8192", "slam/odometry/local_map=aggregated",
            "device=cpu"]


def test_parallel_jobs_equal_the_jobs_run_alone(tmp_path):
    from pylidar_slam_tpu_torch import run as trun
    from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk
    results = trun.main(["-m", *MULTIRUN, "dataset.speed=0.9,1.1", "parallel_jobs=2",
                         f"log_dir={tmp_path / 'sweep'}"])
    assert len(results) == 2
    for idx, speed in enumerate(("0.9", "1.1")):
        job = tmp_path / "sweep" / str(idx)
        assert (job / ".hydra" / "overrides.yaml").exists()
        assert (job / "metrics.yaml").exists()
        alone = tmp_path / f"alone{idx}"
        trun.main([*MULTIRUN, f"dataset.speed={speed}", f"log_dir={alone}"])
        assert np.array_equal(read_poses_from_disk(job / "synth_00.poses.txt"),
                              read_poses_from_disk(alone / "synth_00.poses.txt"))
