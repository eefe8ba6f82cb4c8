"""The port's deep odometry and PoseNet initialization against the JAX
package's on the CPU, over 5 frames, from a JAX-trained checkpoint (3 adamw
steps of test_torch_training.py) carried into the port: the pose
parameters to 1e-4 of their scale (the forward's tolerance), the JAX side
in float32 (``jax.enable_x64(False)``)."""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam import initialization as jinit
from pylidar_slam_tpu.slam.odometry import posenet_odometry as jpo
from pylidar_slam_tpu.training import trainer as jtrainer

from test_torch_odometry import _one_torch_thread  # noqa: F401
from test_torch_training import H, N_PTS, W, _run
from pylidar_slam_tpu_torch import config as tconfig
from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.slam import initialization as tinit
from pylidar_slam_tpu_torch.slam.odometry import posenet_odometry as tpo


# ----------------------------------------------------------------------------
# Inference from carried weights
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
