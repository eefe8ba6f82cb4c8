"""The driver's entry points on the port (torch counterpart of the root
``__graft_entry__.py``).

* ``entry(device)`` returns the aggregated-map ICP frame step (kernel B1 on
  the card) and its example arguments, at the JAX entry's settings: 32x256,
  FoV 3/-24, an empty map of age 10, 6 GN trips re-rasterized every 3, and
  8,192 points drawn from ``np.random.default_rng(0)``.  The example step
  meets an empty map; ``step_chain`` follows it with a keyframe step that
  fills the map and a step that registers against it.
* ``dryrun_multichip(n, device)`` runs the JAX dry run's five parts on n
  ranks spawned over gloo (``parallel.launch.run_ranks``; NCCL refuses two
  ranks on one card), each rank on ``rank_device(device)``: the dp and the
  dp x tp PoseResNet-18 train steps, the point-sharded GN step, the
  pose-graph optimizer with its edges sharded over the ranks, and the
  surfel odometry with ``shard_points=n`` (kernel B2 on each rank's block
  of targets).  It returns every rank's results; with ``record_nn`` they
  also hold the inputs of each rank's B2 calls.

Each part is a module-level function of its inputs; ``dryrun_inputs(n)``
draws them from ``np.random.default_rng(0)`` in the JAX file's order.  Both
entry points run on the card unless ``device="cpu"``, and raise without
one.
"""
from __future__ import annotations

import hashlib
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.ops import projection, se3
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.ops.pose_graph import PoseGraph, optimize_pose_graph
from pylidar_slam_tpu_torch.parallel.launch import run_ranks
from pylidar_slam_tpu_torch.parallel.mesh import rank_device
from pylidar_slam_tpu_torch.parallel.sharded_icp import point_sharded_gauss_newton_step
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (ICPFrameToModel,
                                                               ICPFrameToModelConfig)
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device

FOV = (3.0, -24.0)
TRAIN_SHAPE = (16, 64, 1024)  # the train steps' projection and padded points
POSE_GRAPH_POSES = 8
ODOMETRY_SHAPE = (16, 128, 2048)
# The priors of step_chain's second and third steps: past the aggregated
# map's 0.1 m insert threshold, then a small twist off that keyframe.
STEP_TWISTS = ([0.15, 0.0, 0.0, 0.0, 0.0, 0.0], [0.03, -0.02, 0.01, 0.002, 0.001, 0.004])


def _scan(rng: np.random.Generator, n: int, max_range: float) -> np.ndarray:
    """n points at uniform azimuth, elevation in [-23, 2.5] deg and range in
    [2, max_range] m, drawn in the JAX file's order."""
    azim = rng.uniform(-np.pi, np.pi, n)
    elev = rng.uniform(np.deg2rad(-23.0), np.deg2rad(2.5), n)
    r = rng.uniform(2.0, max_range, n)
    return np.stack([r * np.cos(elev) * np.cos(azim),
                     r * np.cos(elev) * np.sin(azim),
                     r * np.sin(elev)], 1).astype(np.float32)


def entry(device: Optional[str] = None):
    """(step, example_args): the aggregated-map frame step and (empty map,
    identity delta, 8,192 points, all-ones mask, identity prior) on
    `device` (the card by default)."""
    dev = resolve_device(device)
    h, w, n = 32, 256, 8192
    proj = projection.SphericalProjection(height=h, width=w, up_fov=FOV[0], down_fov=FOV[1])
    step, _first, _batch = am.make_agg_icp_frame_step(
        proj=proj, map_cfg=am.AggregatedLocalMapConfig(local_map_size=10),
        max_num_alignments=6, reassoc_every=3, threshold_delta_pose=1.0e-4,
        threshold_trans=0.1, threshold_rot=0.3, gn_scheme="geman_mcclure", gn_sigma=0.3)
    pts = torch.from_numpy(_scan(np.random.default_rng(0), n, 50.0)).to(dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return step, (am.init_agg_map(h, w, dev), eye, pts,
                  torch.ones(n, dtype=torch.bool, device=dev), eye.clone())


def step_chain(step, args, to_input=None) -> list:
    """The example step on `args`, then a keyframe step (prior
    STEP_TWISTS[0]: it inserts the scan into the empty map) and a matching
    step (prior STEP_TWISTS[1]: it registers against that map), each on the
    state and delta the last returned; [(inputs, outputs)] of the three.
    `to_input` turns a prior, a float32 (4, 4) CPU tensor, into the step's
    input (by default: moved to the points' device)."""
    state, delta, pts, mask, prior = args
    to_input = to_input or (lambda pose: pose.to(pts.device))
    out = []
    for twist in (None,) + STEP_TWISTS:
        if twist is not None:
            prior = to_input(se3.build_pose_matrix(
                torch.tensor([twist], dtype=torch.float32))[0])
        inputs = (state, delta, pts, mask, prior)
        res = step(*inputs)
        state, delta = res[0], res[1]
        out.append((inputs, res))
    return out


# ----------------------------------------------------------------------------
# the multi-rank dry run
# ----------------------------------------------------------------------------

def _identity_batch(points: np.ndarray) -> tuple:
    b, _, n_pts, _ = points.shape
    return (points, np.ones((b, 2, n_pts), bool),
            np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1)))


def dryrun_inputs(n: int) -> dict:
    """Every part's inputs for n ranks, from ``default_rng(0)`` in the JAX
    dry run's order: the dp batch (n windows), the tp batch (n/2, n even),
    the GN step's 128 n points, the pose graph (an 8-pose chain along x and
    2 n unit-step edges, those past the 7th with zero information, a prior
    on pose 0) and the odometry's two frames (one scan, twice)."""
    rng = np.random.default_rng(0)
    n_pts = TRAIN_SHAPE[2]
    out = {"dp": _identity_batch(rng.normal(size=(n, 2, n_pts, 3)).astype(np.float32) * 10)}
    if n % 2 == 0:
        out["tp"] = _identity_batch(
            rng.normal(size=(n // 2, 2, n_pts, 3)).astype(np.float32) * 10)
    n_total = 128 * n
    tgt = rng.normal(size=(n_total, 3)).astype(np.float32)
    ref = rng.normal(size=(n_total, 3)).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n_total, 1))
    out["gn"] = (tgt, ref, nrm, np.ones((n_total,), bool))

    m, n_edges = POSE_GRAPH_POSES, 2 * n
    poses = np.tile(np.eye(4), (m, 1, 1))
    poses[:, 0, 3] = np.arange(m)
    edge_i = np.arange(n_edges, dtype=np.int64) % (m - 1)
    meas = np.tile(np.eye(4), (n_edges, 1, 1))
    meas[:, 0, 3] = 1.0
    info = np.tile(np.eye(6), (n_edges, 1, 1))
    info[m - 1:] = 0.0
    out["pose_graph"] = {"poses": poses, "edge_i": edge_i, "edge_j": edge_i + 1,
                         "measurements": meas, "information": info,
                         "prior_idx": np.zeros((1,), np.int64),
                         "prior_measurements": np.eye(4)[None],
                         "prior_information": 1e6 * np.eye(6)[None]}
    scan = _scan(rng, ODOMETRY_SHAPE[2], 40.0)
    out["odometry"] = [scan, scan]
    return out


def perturbed_pose_graph(graph: dict, seed: int = 7) -> dict:
    """`graph` with poses 1.. moved off their measurements by a twist drawn
    from `seed` (up to 0.2 m and 0.05 rad a pose): a chain whose optimum is
    not its start, to check the optimizer on (the dry run's own chain fits
    its edges exactly)."""
    rng = np.random.default_rng(seed)
    m = len(graph["poses"])
    twists = np.concatenate([rng.uniform(-0.2, 0.2, (m - 1, 3)),
                             rng.uniform(-0.05, 0.05, (m - 1, 3))], axis=1)
    poses = graph["poses"].copy()
    poses[1:] = poses[1:] @ se3.build_pose_matrix(torch.from_numpy(twists)).numpy()
    return dict(graph, poses=poses)


class _Loader:
    def projector(self):
        return projection.SphericalProjection(*TRAIN_SHAPE[:2], *FOV)


def _train_step(device, batch, variables, train_dir, **parallel) -> dict:
    """One supervised PoseResNet-18 step (the trainer's defaults: adamw, lr
    1e-4, l2 loss in degrees) on the global batch over the default group;
    the loss, the whole weights after it and their sha256."""
    from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
    from pylidar_slam_tpu_torch.training.loss_modules import SupervisedLossConfig
    from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig
    from pylidar_slam_tpu_torch.training.trainer import ATrainerConfig, PoseNetTrainer

    cfg = ATrainerConfig(train_dir=str(train_dir), batch_size=len(batch[0]),
                         num_points_padded=TRAIN_SHAPE[2], with_tensorboard=False,
                         device=str(device), **parallel)
    tr = PoseNetTrainer(cfg, PredictionConfig(), SupervisedLossConfig(), _Loader())
    if variables is not None:
        load_jax_variables(tr.module, *variables)
    tr._init_state()
    loss, _ = tr._train_step(*(torch.from_numpy(a).to(tr.device) for a in batch))
    state, _ = tr._whole_state()
    state = {k: v.detach().cpu().numpy().copy() for k, v in state.items()}
    digest = hashlib.sha256(b"".join(state[k].tobytes() for k in sorted(state))).hexdigest()
    return {"loss": float(loss), "digest": digest, "state": state}


def dp_train_step(device, batch, variables, train_dir) -> dict:
    """Part 1: the batch split over every rank (``data_parallel``)."""
    return _train_step(device, batch, variables, train_dir, data_parallel=True)


def tp_train_step(device, batch, variables, train_dir) -> dict:
    """Part 2: dp = world / 2 x tp = 2 (``tensor_parallel=2``)."""
    return _train_step(device, batch, variables, train_dir, tensor_parallel=2)


def _block(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """This rank's contiguous block of the leading axis."""
    n = len(a)
    return a[rank * n // world:(rank + 1) * n // world]


def sharded_gn(device, rank, world, target, ref, normals, mask) -> tuple:
    """Part 3: this rank's block of the points through the point-sharded GN
    step (geman_mcclure, sigma 0.3); (dx, loss), the same on every rank."""
    step = point_sharded_gauss_newton_step(dist.group.WORLD, scheme="geman_mcclure",
                                           sigma=0.3)
    dx, loss = step(torch.zeros(6, device=device),
                    *(torch.from_numpy(_block(a, rank, world)).to(device)
                      for a in (target, ref, normals, mask)))
    return dx.cpu().numpy(), float(loss)


def sharded_pose_graph(device, rank, world, graph: dict) -> np.ndarray:
    """Part 4: the float64 pose graph, 2 GN iterations of 8 CG trips, this
    rank holding its block of the edges; the optimized poses."""
    edges = {k: torch.from_numpy(_block(graph[k], rank, world)).to(device)
             for k in ("edge_i", "edge_j", "measurements", "information")}
    priors = {k: torch.from_numpy(graph[k]).to(device)
              for k in ("prior_idx", "prior_measurements", "prior_information")}
    poses = optimize_pose_graph(torch.from_numpy(graph["poses"]).to(device),
                                PoseGraph(**edges, **priors), num_iters=2, cg_iters=8,
                                group=dist.group.WORLD)
    return poses.cpu().numpy()


def odometry_poses(device, world, frames: list, shard_points: int) -> np.ndarray:
    """The dry run's surfel odometry (128 targets per rank of `world`, exact
    NN: kernel B2 on the card) with `shard_points` over `frames` (point
    clouds); the relative poses."""
    h, w, n_pts = ODOMETRY_SHAPE
    cfg = ICPFrameToModelConfig(
        max_num_alignments=3,
        local_map={"type": "kdtree_local_map", "local_map_size": 3,
                   "points_per_frame": 512, "target_samples": 128 * world},
        num_points_padded=n_pts, data_key="numpy_pc", shard_points=shard_points,
        device=str(device))
    odom = ICPFrameToModel(cfg, projector=projection.SphericalProjection(h, w, *FOV))
    for cloud in frames:
        odom.process_next_frame({"numpy_pc": cloud})
    return odom.get_relative_poses()


def sharded_odometry(device, world, frames: list) -> np.ndarray:
    """Part 5: the odometry with its targets sharded over the ranks
    (``shard_points=world``: B2 on this rank's block)."""
    return odometry_poses(device, world, frames, world)


def _record_nn_calls(calls: list) -> None:
    """Wraps the surfel map's B2 entry, in this process, to keep each call's
    (queries, model, valid) in `calls` as host arrays."""
    from pylidar_slam_tpu_torch.slam.odometry import surfel_map
    search = surfel_map.nn_argmin

    def recording(queries, model, valid, **kw):
        calls.append(tuple(t.detach().cpu().numpy().copy() for t in (queries, model, valid)))
        return search(queries, model, valid, **kw)
    surfel_map.nn_argmin = recording


def _rank(rank, world, device, inputs, variables, workdir, record_nn=False) -> dict:
    """The five parts on this rank; the weights themselves only from rank 0
    (every rank's digest says they are the same)."""
    dev = rank_device(torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"dp": dp_train_step(dev, inputs["dp"], variables, Path(workdir) / f"dp{rank}")}
    if "tp" in inputs:
        out["tp"] = tp_train_step(dev, inputs["tp"], variables, Path(workdir) / f"tp{rank}")
    if rank:
        for part in ("dp", "tp"):
            if part in out:
                out[part]["state"] = None
    out["gn"] = sharded_gn(dev, rank, world, *inputs["gn"])
    out["pose_graph"] = sharded_pose_graph(dev, rank, world, inputs["pose_graph"])
    calls = []
    if record_nn:
        _record_nn_calls(calls)
    before = b2.nn_argmin.launches
    out["odometry"] = sharded_odometry(dev, world, inputs["odometry"])
    out["b2_launches"] = b2.nn_argmin.launches - before
    if record_nn:
        out["nn_calls"] = calls
    return out


def dryrun_multichip(n: int, device: Optional[str] = None, workdir=None,
                     variables=None, inputs: Optional[dict] = None,
                     record_nn: bool = False) -> list:
    """The five parts on n gloo ranks on `device` (the card by default);
    each rank's results, in rank order.  `variables` are flax (params,
    batch_stats) trees to start PoseResNet-18 from (the port's seeded
    initialisation when None); `inputs` replace ``dryrun_inputs(n)``.
    `record_nn` adds each rank's B2 calls, [(queries, model, valid)] as
    host arrays, under "nn_calls": the shapes this path gives the kernel."""
    dev = resolve_device(device)
    inputs = dryrun_inputs(n) if inputs is None else inputs
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return dryrun_multichip(n, str(dev), tmp, variables, inputs, record_nn)
    return run_ranks(_rank, n, workdir, str(dev), inputs, variables, str(workdir), record_nn,
                     threads=1)
