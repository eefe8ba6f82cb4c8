"""The port's driver entry points (``pylidar_slam_tpu_torch.graft_entry``)
against the root ``__graft_entry__.py`` on the CPU.

* ``entry()``: the aggregated-map step and its example arguments against
  the JAX entry's, over three steps on the same inputs: the example
  arguments themselves (an empty map: no match, no insert), a keyframe
  step at a 0.15 m prior (past the 0.1 m threshold: it inserts the scan)
  and a step at a small twist that registers against that map.  Poses
  within 1e-5, the iterations, the insert flag and the map's ages exactly,
  the match count within 0.1%, the loss to 1e-4 relative, the map's
  points and ranges within 1e-5 and its normals within 2e-2 (the JAX side
  in float32).  The normals' bar is their conditioning: each solves a 5x5
  window's plane fit over a scan of random ranges, whose points lie along
  nearly parallel rays (condition numbers 1e3-1e5), and float32 rounding
  moves them by up to 1.5e-2, 1e-4 at the median.
* ``dryrun_multichip(2)``, run once (2 gloo ranks, one thread each), from
  the JAX package's ``init_params(PRNGKey(0))`` weights and the dry run's
  own draws, each part against the JAX package on the same inputs:
  - the dp and tp train steps against the JAX trainer's ``_train_step`` on
    the same global batch: test_torch_training.py's one-step bars for
    adamw (loss 1e-4 relative; each weight's update to 2e-2 of its norm
    and 2.5 lr absolute; BatchNorm statistics 1e-4 of their scale); the tp
    part on the dp part's two windows (see ``dryrun2``);
  - dx and the loss against ``point_sharded_gauss_newton_step`` on a
    2-device mesh (atol 1e-4 and rtol 1e-4, tests/test_parallel.py's);
  - the edge-sharded pose graph against ``optimize_pose_graph`` on the
    whole edge set in float64 within 1e-8; the chain's poses are moved off
    their measurements by a seeded twist first (the dry run's own chain
    fits its edges exactly, so its optimum is its start);
  - the odometry's relative poses, over the first three frames of the
    synthetic sequence at 16x128 with de-calibrated beams, against the
    port's unsharded run within 5e-4 (tests/test_parallel.py's bar for
    exact NN) and against ``ICPFrameToModel(shard_points=2)`` within 3e-2,
    tests/test_torch_parallel.py's bar for k-NN map normals (the dry run's
    surfel map fits its normals to each surfel's nearest map points; at
    this sparse size the unsharded port leaves JAX by 3.2e-3 with them and
    by 4.5e-6 with image normals).  The dry run's own scan of random
    ranges holds no planes: its k-NN normals are as ill-defined as the
    eigenvalue ties that pick them (up to 1.1 apart after one frame);
  - every rank's results bit for bit;
  - the inputs each rank gives B2 (``record_nn``): its own block of 128
    targets against the same replicated map, one search a registered
    frame.
* ``optimize_pose_graph(group=None)`` bit for bit its result on a group of
  one rank.
* The dry run at n = 4 and n = 8 under ``-m slow``, as the JAX package's
  own dry-run test (tests/test_parallel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticSequence
from pylidar_slam_tpu.ops.pose_graph import PoseGraph as JPoseGraph
from pylidar_slam_tpu.ops.pose_graph import optimize_pose_graph as joptimize_pose_graph
from pylidar_slam_tpu.ops.projection import SphericalProjection as JProj
from pylidar_slam_tpu.parallel import make_mesh, point_sharded_gauss_newton_step
from pylidar_slam_tpu.slam.odometry.icp_odometry import (ICPFrameToModel as JICP,
                                                         ICPFrameToModelConfig as JICPConfig)
from pylidar_slam_tpu.training import loss_modules as jloss
from pylidar_slam_tpu.training import trainer as jtrainer
from pylidar_slam_tpu.training.prediction_modules import PredictionConfig as JPred

import torch_parallel_workers as workers
from test_torch_odometry import _one_torch_thread  # noqa: F401
from test_torch_training import LOSS_TOL, STATS_TOL, _check_update, _state_of
from pylidar_slam_tpu_torch import graft_entry
from pylidar_slam_tpu_torch.ops.pose_graph import PoseGraph, optimize_pose_graph
from pylidar_slam_tpu_torch.parallel.launch import run_ranks
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModelConfig

POSE_TOL = 1e-5
MAP_TOL = 1e-5
NORMAL_TOL = 2e-2
MATCH_RTOL = 1e-3
GN_ATOL = 1e-4
POSE_GRAPH_TOL = 1e-8
SHARD_TOL = 5e-4
KNN_NORMALS_TOL = 3e-2


# ----------------------------------------------------------------------------
# entry()
# ----------------------------------------------------------------------------

def _chain(step, args, to_array, to_input=None) -> list:
    """``graft_entry.step_chain``: the example step, then the keyframe and
    the matching step on the state each returns; every output as numpy."""
    return [{"state": {k: to_array(v) for k, v in out[0]._asdict().items()},
             "rpose": to_array(out[2]), "diag": [to_array(d) for d in out[4]]}
            for _, out in graft_entry.step_chain(step, args, to_input)]


@pytest.fixture(scope="module")
def entry_steps():
    with jax.enable_x64(False):
        jstep, jargs = jgraft.entry()
        ref = _chain(jax.jit(jstep), jargs, np.asarray, lambda pose: jnp.asarray(pose.numpy()))
    step, args = graft_entry.entry("cpu")
    ours = _chain(step, args, lambda t: t.numpy())
    return ours, ref


def test_entry_example_arguments_match_jax():
    with jax.enable_x64(False):
        _, jargs = jgraft.entry()
    _, args = graft_entry.entry("cpu")
    for name, a in args[0]._asdict().items():
        assert np.array_equal(a.numpy(), np.asarray(getattr(jargs[0], name))), name
    for a, b in zip(args[1:], jargs[1:]):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", [0, 1, 2], ids=["empty_map", "keyframe", "matching"])
def test_entry_step_matches_jax(entry_steps, k):
    ours, ref = (s[k] for s in entry_steps)
    np.testing.assert_allclose(ours["rpose"], ref["rpose"], atol=POSE_TOL)
    loss, iters, matches, inserted = ours["diag"]
    rloss, riters, rmatches, rinserted = ref["diag"]
    assert (int(iters), bool(inserted)) == (int(riters), bool(rinserted))
    assert abs(int(matches) - int(rmatches)) <= MATCH_RTOL * max(int(rmatches), 1)
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_TOL)
    assert np.array_equal(ours["state"]["age"], ref["state"]["age"])
    for name in ("xyz", "normal", "rng", "anchor_from_cur"):
        np.testing.assert_allclose(ours["state"][name], ref["state"][name], err_msg=name,
                                   atol=NORMAL_TOL if name == "normal" else MAP_TOL)
    # the chain does what it is for: the example step meets an empty map,
    # the keyframe fills it, the last step registers against it
    assert (int(matches) > 1000) == (k == 2) and bool(inserted) == (k == 1)


def test_entry_points_without_a_card_raise():
    """The card unless device="cpu": no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=cpu"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device=cpu"):
        graft_entry.dryrun_multichip(2)


# ----------------------------------------------------------------------------
# dryrun_multichip(2)
# ----------------------------------------------------------------------------

def _test_inputs(n: int) -> dict:
    """The dry run's inputs, with poses 1-7 of the pose graph's chain moved
    by a seeded twist (``graft_entry.perturbed_pose_graph``), and the
    odometry's frames replaced by the first three of the synthetic sequence
    at 16x128."""
    inputs = graft_entry.dryrun_inputs(n)
    seq = SyntheticSequence(SyntheticConfig(lidar_height=16, lidar_width=128, num_frames=3,
                                            beam_jitter_deg=0.1), "synth_00", seed=0)
    inputs["odometry"] = [np.asarray(seq[i]["numpy_pc"], np.float32) for i in range(3)]
    inputs["pose_graph"] = graft_entry.perturbed_pose_graph(inputs["pose_graph"])
    return inputs


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX dry run's trainer (its defaults: adamw, lr 1e-4, supervised
    l2 in degrees) from ``init_params(PRNGKey(0))``, stepped as a plain jit."""
    h, w, n_pts = graft_entry.TRAIN_SHAPE
    with jax.enable_x64(False):
        cfg = jtrainer.ATrainerConfig(train_dir=str(tmp_path_factory.mktemp("jax_graft")),
                                      batch_size=2, num_points_padded=n_pts,
                                      with_tensorboard=False)
        loader = type("Loader", (), {"projector": lambda self: JProj(h, w, *graft_entry.FOV)})
        tr = jtrainer.PoseNetTrainer(cfg, JPred(), jloss.SupervisedLossConfig(), loader())
        tr.params, tr.batch_stats = tr.prediction.init_params(jax.random.PRNGKey(0),
                                                              (1, 2, 3, h, w))
        tr.opt_state = tr.optimizer.init(tr._trainable())
        tr._build_steps()
    return tr


def _jax_train_step(tr, batch) -> dict:
    with jax.enable_x64(False):
        trainable, stats, _, loss, _ = tr._train_step(
            tr._trainable(), tr.batch_stats, tr.opt_state, *(jnp.asarray(a) for a in batch))
    return {"loss": float(loss), "state": _state_of(trainable["params"], stats)}


@pytest.fixture(scope="module")
def dryrun2(tmp_path_factory, jax_trainer):
    variables = tuple(jax.tree_util.tree_map(np.asarray, v)
                      for v in (jax_trainer.params, jax_trainer.batch_stats))
    inputs = _test_inputs(2)
    # the tp part's own batch at n = 2 is one window: BatchNorm's statistics
    # over the last stage's 1x2 pixels are then ill-conditioned in float32
    # (the loss 0.039977 in the port, 0.041027 in JAX, 0.041166 in float64),
    # so it takes the dp part's two windows here
    inputs["tp"] = inputs["dp"]
    ranks = graft_entry.dryrun_multichip(2, "cpu", tmp_path_factory.mktemp("dryrun2"),
                                         variables=variables, inputs=inputs, record_nn=True)
    return ranks, inputs, _state_of(*variables)


def _jax_gn(n, gn_inputs):
    with jax.enable_x64(False):
        mesh = make_mesh([("sp", n)], devices=jax.devices()[:n])
        dx, loss = point_sharded_gauss_newton_step(
            mesh, axis="sp", scheme="geman_mcclure", sigma=0.3)(
            jnp.zeros(6), *(jnp.asarray(a) for a in gn_inputs))
    return np.asarray(dx), float(loss)


def _jax_pose_graph(graph):
    jgraph = JPoseGraph(**{k: jnp.asarray(graph[k].astype(np.int32) if "idx" in k or "edge" in k
                                          else graph[k])
                           for k in JPoseGraph._fields})
    return np.asarray(joptimize_pose_graph(jnp.asarray(graph["poses"]), jgraph,
                                           num_iters=2, cg_iters=8))


def _jax_odometry(n, frames):
    h, w, n_pts = graft_entry.ODOMETRY_SHAPE
    with jax.enable_x64(False):
        odom = JICP(JICPConfig(max_num_alignments=3,
                               local_map={"type": "kdtree_local_map", "local_map_size": 3,
                                          "points_per_frame": 512, "target_samples": 128 * n},
                               num_points_padded=n_pts, data_key="numpy_pc", shard_points=n),
                    projector=JProj(h, w, *graft_entry.FOV))
        odom.init()
        for cloud in frames:
            odom.process_next_frame({"numpy_pc": cloud})
        return odom.get_relative_poses()


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        for part in ("dp", "tp"):
            assert (r[part]["loss"], r[part]["digest"]) == \
                (ranks[0][part]["loss"], ranks[0][part]["digest"]), part
        assert np.array_equal(r["gn"][0].view(np.int32), ranks[0]["gn"][0].view(np.int32))
        assert r["gn"][1] == ranks[0]["gn"][1]
        assert np.array_equal(r["pose_graph"], ranks[0]["pose_graph"])
        assert np.array_equal(r["odometry"], ranks[0]["odometry"])


def test_dryrun_ranks_agree_bit_for_bit(dryrun2):
    _same_on_every_rank(dryrun2[0])


@pytest.mark.parametrize("part", ["dp", "tp"])
def test_dryrun_train_steps_match_jax(dryrun2, jax_trainer, part):
    ranks, inputs, before = dryrun2
    ours = ranks[0][part]
    ref = _jax_train_step(jax_trainer, inputs[part])
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=LOSS_TOL)
    lr = jtrainer.ATrainerConfig().optimizer_learning_rate
    for name, r in ref["state"].items():
        o = ours["state"][name]
        if "running" in name:
            err = np.abs(o - r).max() / max(np.abs(r).max(), 1e-12)
            assert err <= STATS_TOL[1], f"{name}: {err:.3e} of its scale"
            continue
        _check_update(name, "adamw", before[name], r, o, lr, 1)


def test_dryrun_sharded_gn_matches_jax(dryrun2):
    ranks, inputs, _ = dryrun2
    jdx, jloss_ = _jax_gn(2, inputs["gn"])
    np.testing.assert_allclose(ranks[0]["gn"][0], jdx, atol=GN_ATOL)
    np.testing.assert_allclose(ranks[0]["gn"][1], jloss_, rtol=1e-4)


def test_dryrun_sharded_pose_graph_matches_jax(dryrun2):
    ranks, inputs, _ = dryrun2
    graph = inputs["pose_graph"]
    ref = _jax_pose_graph(graph)
    assert np.abs(ref - graph["poses"]).max() > 1e-2  # the optimizer moved the chain
    np.testing.assert_allclose(ranks[0]["pose_graph"], ref, atol=POSE_GRAPH_TOL)


def test_dryrun_sharded_odometry_matches_jax(dryrun2):
    ranks, inputs, _ = dryrun2
    ours = ranks[0]["odometry"]
    ref = _jax_odometry(2, inputs["odometry"])
    alone = graft_entry.odometry_poses(torch.device("cpu"), 2, inputs["odometry"], 0)
    assert ours.shape == ref.shape == alone.shape == (3, 4, 4)
    assert np.abs(ref[1:, :3, 3]).max() > 0.2  # the sequence moves
    np.testing.assert_allclose(ours, alone, atol=SHARD_TOL)
    np.testing.assert_allclose(ours, ref, atol=KNN_NORMALS_TOL)
    assert [r["b2_launches"] for r in ranks] == [0, 0]  # CPU tensors: the plain version


def test_dryrun_records_each_ranks_b2_inputs(dryrun2):
    ranks, inputs, _ = dryrun2
    every = ICPFrameToModelConfig().reassoc_every
    searches = len(range(0, 3, every)) * (len(inputs["odometry"]) - 1)
    calls = [r["nn_calls"] for r in ranks]
    assert [len(c) for c in calls] == [searches, searches]
    for (q0, m0, v0), (q1, m1, v1) in zip(*calls):
        assert q0.shape == q1.shape == (128, 3)  # each rank's block of 256 targets
        assert m0.shape[1] == 3 and v0.shape == (len(m0),) and v0.any()
        assert np.array_equal(m0, m1) and np.array_equal(v0, v1)  # the replicated map
        assert not np.array_equal(q0, q1)


def test_pose_graph_without_a_group_is_its_one_rank_result(tmp_path):
    graph = _test_inputs(2)["pose_graph"]
    [one_rank] = run_ranks(workers.pose_graph_one_rank, 1, tmp_path, graph, threads=1)
    plain = optimize_pose_graph(
        torch.from_numpy(graph["poses"]),
        PoseGraph(**{k: torch.from_numpy(graph[k]) for k in PoseGraph._fields}),
        num_iters=2, cg_iters=8).numpy()
    assert np.array_equal(plain, one_rank)
    np.testing.assert_allclose(plain, _jax_pose_graph(graph), atol=POSE_GRAPH_TOL)


@pytest.mark.slow
@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_at_the_drivers_sizes(tmp_path, n):
    inputs = _test_inputs(n)
    ranks = graft_entry.dryrun_multichip(n, "cpu", tmp_path, inputs=inputs)
    assert len(ranks) == n
    _same_on_every_rank(ranks)
    assert all(np.isfinite(ranks[0][p]["loss"]) for p in ("dp", "tp"))
    jdx, jloss_ = _jax_gn(n, inputs["gn"])
    np.testing.assert_allclose(ranks[0]["gn"][0], jdx, atol=GN_ATOL)
    np.testing.assert_allclose(ranks[0]["gn"][1], jloss_, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["pose_graph"], _jax_pose_graph(inputs["pose_graph"]),
                               atol=POSE_GRAPH_TOL)
    np.testing.assert_allclose(ranks[0]["odometry"], _jax_odometry(n, inputs["odometry"]),
                               atol=KNN_NORMALS_TOL)
