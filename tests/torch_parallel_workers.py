"""Rank functions of tests/test_torch_parallel.py, run on spawned ranks by
``pylidar_slam_tpu_torch.parallel.launch.run_ranks`` (gloo on the CPU).

This module imports torch and the port only: each rank imports it afresh.
"""
import numpy as np
import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.resnet import BatchNorm2d
from pylidar_slam_tpu_torch.ops import projection
from pylidar_slam_tpu_torch.parallel import point_sharded_gauss_newton_step
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (ICPFrameToModel,
                                                               ICPFrameToModelConfig)
from pylidar_slam_tpu_torch.training import loss_modules, trainer
from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig

SURFEL_PROJ = (32, 256, 3.0, -24.0)


def gn_step(rank, world, target, ref, normals, mask):
    """This rank's contiguous block of the points through the point-sharded
    GN step: (dx, loss), the same on every rank."""
    n = len(target)
    block = slice(rank * n // world, (rank + 1) * n // world)
    step = point_sharded_gauss_newton_step(dist.group.WORLD)
    dx, loss = step(torch.zeros(6), *(torch.from_numpy(a[block])
                                      for a in (target, ref, normals, mask)))
    return dx.numpy(), float(loss)


def surfel_config(local_map: dict, shard: int) -> ICPFrameToModelConfig:
    """tests/test_parallel.py's surfel configuration on the CPU."""
    return ICPFrameToModelConfig(
        max_num_alignments=6, local_map=dict(local_map), num_points_padded=8192,
        data_key="numpy_pc", shard_points=shard, device="cpu")


def odometry_poses(cfg, proj, frames) -> np.ndarray:
    """ICPFrameToModel over the frame dicts, each fed with the previous
    frame's pose as its prior; the relative poses."""
    odom = ICPFrameToModel(cfg, projector=projection.SphericalProjection(*proj))
    last = np.eye(4, dtype=np.float32)
    for f in frames:
        d = dict(f, init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
    odom.finish()
    return odom.get_relative_poses()


def odometry_runs(rank, world, runs):
    """{name: relative poses} of each (config, projection, frames) run."""
    return {name: odometry_poses(*run) for name, run in runs.items()}


class _Loader:
    def __init__(self, proj):
        self.proj = proj

    def projector(self):
        return self.proj


def make_trainer(train_dir, proj, tp=1, data_parallel=False, lr=1e-2,
                 params=None, stats=None):
    """A supervised PoseResNet-18 trainer (learned exp weights, sgd), on
    the CPU, with the JAX package's weights when given."""
    cfg = trainer.ATrainerConfig(
        train_dir=str(train_dir), batch_size=4, num_points_padded=512,
        with_tensorboard=False, optimizer_type="sgd", optimizer_learning_rate=lr,
        device="cpu", tensor_parallel=tp, data_parallel=data_parallel)
    tr = trainer.PoseNetTrainer(cfg, PredictionConfig(),
                                loss_modules.SupervisedLossConfig(with_exp_weights=True),
                                _Loader(projection.SphericalProjection(*proj)))
    if params is not None:
        load_jax_variables(tr.module, params, stats)
    tr._init_state()
    return tr


def step_result(tr, batch) -> dict:
    """One train step on the global batch; the loss and the weights after
    it, gathered whole."""
    loss, _ = tr._train_step(*(torch.from_numpy(a) for a in batch))
    state, _ = tr._whole_state()
    return {"loss": float(loss), "exp_s": tr.exp_s.detach().numpy().copy(),
            "state": {k: v.detach().numpy().copy() for k, v in state.items()},
            "split": sorted(tr._split or {})}


def train_step(rank, world, workdir, proj, tp, params, stats, batch, lr):
    tr = make_trainer(f"{workdir}/rank{rank}", proj, tp=tp, data_parallel=True, lr=lr,
                      params=params, stats=stats)
    return step_result(tr, batch)


def batchnorm(rank, world, x):
    """BatchNorm2d in train mode on this rank's slice of `x`, with the
    statistics over the dp group and, for contrast, over the slice alone."""
    b = len(x)
    local = torch.from_numpy(x[rank * b // world:(rank + 1) * b // world])
    out = {}
    for name, group in (("global", dist.group.WORLD), ("per_rank", None)):
        bn = BatchNorm2d(x.shape[1])
        bn.group = group
        bn.train()
        out[name] = {"y": bn(local).detach().numpy(),
                     "running_mean": bn.running_mean.numpy().copy(),
                     "running_var": bn.running_var.numpy().copy()}
    return out


def two_ranks(rank, world, gn_args, surfel_args, train_args, bn_x):
    """Every check of the 2-rank cases in one spawn (a spawn costs ~3 s)."""
    torch.manual_seed(0)
    return {"gn": gn_step(rank, world, *gn_args),
            "surfel": odometry_runs(rank, world, surfel_args),
            "dp": train_step(rank, world, *train_args[0]),
            "tp": train_step(rank, world, *train_args[1]),
            "bn": batchnorm(rank, world, bn_x)}


def four_ranks(rank, world, gn_args, train_args):
    """The 4-rank cases: the GN step, and dp=2 x tp=2 training."""
    return {"gn": gn_step(rank, world, *gn_args),
            "dp_tp": train_step(rank, world, *train_args)}
