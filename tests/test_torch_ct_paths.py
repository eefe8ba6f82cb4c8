"""The port's aggregated map on the branches beyond the champion -- elastic
and deskew warps, point-to-point GN and procrustes, the CT-ICP priors,
merged-model and centered normals -- against the JAX package's, on the
CPU: one step from the same map state per mode, an elastic trajectory, and
the profiles pinned to the repo's configs.

One step agrees to <= 2e-5 m / 2e-5 of the rotation entries with identical
iteration, match and insert decisions.  The trajectory is held as
tests/test_torch_odometry.py holds the champion's (its docstring gives the
reasons): within the drift bounds of PR 1's trajectory tests, 2e-2 m / 2e-3
rad per frame, since one-ulp differences flip z-buffer pixels and compound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.config import compose, dataclass_from_dict
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry import aggregated_map as jam
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModelConfig as JICPConfig
from pylidar_slam_tpu.utils import prewarm

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops.kernels import assoc_gn
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_odometry import DRIFT, _one_torch_thread, _pose_errors  # noqa: F401

H, W = 32, 256
CAP = H * W + (H + W + 1) // 2 + 112  # rimg8 rows + zero padding
# The rolling-shutter sequence at 32x256 with de-calibrated beams: f32
# clouds of exact pixel-center beams sit on .5 column boundaries, where one
# ulp of atan2 decides the pixel (tests/test_torch_odometry_paths.py).
SKEW = dict(tacc.ROLLING_SHUTTER_KW, lidar_height=H, lidar_width=W, num_frames=3,
            beam_jitter_deg=0.1)
STEP_TOL = 2e-5


def jax_config(tcfg):
    """The JAX package's config with the port config's fields (the two
    dataclasses have the same fields; the device stays the JAX default)."""
    fields = dataclasses.asdict(tcfg)
    fields.pop("device")
    return JICPConfig(**fields)


def _upload(odom, cloud):
    buf = odom.encode_upload(cloud)
    out = np.zeros((CAP, buf.shape[1]), buf.dtype)
    out[:buf.shape[0]] = buf
    return out


def _join_prewarm():
    for t in list(prewarm._threads):  # the JAX odometry's background compile
        t.join()


def step_like_jax(tcfg, seq=SKEW, label=""):
    """Runs frame 0's insert in JAX, converts the map state, then one step
    of frame 1 in both packages from it (init: the ground-truth motion off
    by 3 cm / 0.3 deg), and checks the relative pose and the decisions."""
    tcfg = dataclasses.replace(tcfg, num_points_padded=CAP, device="cpu")
    loader = TLoader(TCfg(**seq))
    proj = loader.projector()
    frames = loader.sequences()[0][0][0]
    t = TICP(tcfg, projector=proj)
    j = JICP(jax_config(tcfg), projector=jproj.SphericalProjection(*proj))
    _join_prewarm()
    u0, u1 = (_upload(t, frames[i]["numpy_pc"]) for i in (0, 1))
    init = loader.get_ground_truth("synth_00")[1].astype(np.float32)
    c, s = np.cos(0.005), np.sin(0.005)
    init = init @ np.float32([[c, -s, 0, 0.03], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    ones = np.ones(CAP, bool)
    eye = np.eye(4, dtype=np.float32)
    with jax.enable_x64(False):
        state = j._first(jam.init_agg_map(H, W), jnp.asarray(u0), jnp.asarray(ones))
        tstate = tam.agg_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
        jout = j._step(state, jnp.asarray(eye), jnp.asarray(u1), jnp.asarray(ones),
                       jnp.asarray(init))
        jrel = np.asarray(jout[2])
        jdiag = [np.asarray(d) for d in jout[4]]
    launches = assoc_gn.assoc_gn.launches
    tout = t._map.step(tstate, torch.from_numpy(eye), torch.from_numpy(u1),
                   torch.from_numpy(ones), torch.from_numpy(init))
    assert assoc_gn.assoc_gn.launches == launches  # CPU: the plain version
    trel = tout[2].numpy()
    gap_t = np.abs(trel[:3, 3] - jrel[:3, 3]).max()
    gap_r = np.abs(trel[:3, :3] - jrel[:3, :3]).max()
    loss, iters, matches, insert = (d.numpy() for d in tout[4])
    print(f"\n{label}: step gap {gap_t:.2e} m, {gap_r:.2e} rot; iterations {iters}, "
          f"matches {matches}, moved {np.linalg.norm(jrel[:3, 3]):.3f} m")
    assert gap_t <= STEP_TOL and gap_r <= STEP_TOL
    assert iters == jdiag[1] and matches == jdiag[2] and insert == jdiag[3]
    assert matches > 1000
    np.testing.assert_allclose(loss, jdiag[0], rtol=1e-4)
    return tout


def _champion(**over):
    return dataclasses.replace(tacc.champion_configs()["aggregated"], batch_size=1,
                               upload_format="f32", **over)


_PRIORS = {"max_dist_to_plane": 0.3, "beta_location_consistency": 0.001,
           "beta_constant_velocity": 0.001, "beta_small_velocity": 0.01,
           "beta_orientation_consistency": 0.01}

MODES = {
    # elastic + plane gate + location / constant-velocity priors, reassoc 2
    "ct_icp": tacc.profile_configs()["ct_icp"],
    # the generic 2x3 window of kernel B1, annealing, small-velocity prior
    "ct_icp_robust_shaky": tacc.profile_configs()["ct_icp_robust_shaky"],
    "deskew": _champion(alignment={"deskew": True, "gauss_newton_config": {
        "scheme": "geman_mcclure", "sigma": 0.4}}),
    "procrustes": _champion(alignment={"mode": "point_to_point_procrustes",
                                       "gauss_newton_config": {"scheme": "geman_mcclure",
                                                               "sigma": 0.5}}),
    "point_to_point_with_priors": _champion(alignment={
        "mode": "point_to_point_gauss_newton",
        "gauss_newton_config": dict(_PRIORS, scheme="geman_mcclure", sigma=0.4)}),
    "all_four_priors": _champion(alignment={"gauss_newton_config": dict(
        _PRIORS, scheme="geman_mcclure", sigma=0.4)}),
    # merged-model refits with the centered fit, batched rimg8 profile run
    # one step at a time
    "aggregated_highway": dataclasses.replace(tacc.profile_configs()["aggregated_highway"],
                                              batch_size=1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_one_step_like_jax(mode):
    step_like_jax(MODES[mode], label=mode)


def test_elastic_trajectory_like_jax():
    """ICPFrameToModel in elastic mode with the mid-sweep pose over 5 frames
    at 16x128 (the JAX package's tests/test_ct_poses.py setting), the
    previous pose fed as prior: every surface within the drift bounds of
    the JAX run (frame 1, one step from the same map, within 1e-4 m), mid
    and begin surfaces apart."""
    seq = dict(lidar_height=16, lidar_width=128, num_frames=5, num_walls=12,
               num_pillars=8, beam_jitter_deg=0.1)
    over = dict(max_num_alignments=4, num_points_padded=4096, data_key="numpy_pc",
                pose_type="mid_pose", upload_format="f32",
                local_map={"type": "aggregated_local_map", "local_map_size": 10},
                alignment={"elastic": True, "gauss_newton_config": {
                    "scheme": "geman_mcclure", "sigma": 0.5,
                    "max_dist_to_plane": 0.5, "beta_constant_velocity": 0.001}})
    loader = TLoader(TCfg(**seq))
    frames = loader.sequences()[0][0][0]
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModelConfig
    tcfg = ICPFrameToModelConfig(device="cpu", **over)
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jax_config(tcfg), projector=jproj.SphericalProjection(*loader.projector()))
    _join_prewarm()
    j.init()
    for odom, ctx in ((t, None), (j, jax.enable_x64(False))):
        if ctx is not None:
            ctx.__enter__()
        last = np.eye(4, dtype=np.float32)
        for i in range(5):
            d = {"numpy_pc": frames[i]["numpy_pc"], "init_rpose": last}
            odom.process_next_frame(d)
            last = np.asarray(d["odometry_pose"], np.float32)
        if ctx is not None:
            surfaces = [odom.get_relative_poses()] + [
                odom.get_ct_relative_poses(p) for p in ("begin_pose", "end_pose")]
            ctx.__exit__(None, None, None)
    ours = [t.get_relative_poses()] + [t.get_ct_relative_poses(p)
                                       for p in ("begin_pose", "end_pose")]
    for a, b, name in zip(ours, surfaces, ("mid", "begin", "end")):
        trans, rot = _pose_errors(a, b)
        print(f"\nelastic 16x128, {name} surface: per-frame gaps {np.round(trans, 6)} m, "
              f"max {rot.max():.2e} rad")
        assert trans[1] < 1e-4
        assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"]
    assert not np.allclose(ours[0], ours[1], atol=1e-6)


# the voxel profile is bench.py's configuration, with no YAML of its own;
# tests/test_torch_voxel_map.py pins it to bench.build_icp_config
@pytest.mark.parametrize("name", [n for n in tacc.profile_configs() if n != "voxel"])
def test_profiles_match_the_repo_configs(name, monkeypatch):
    """profile_configs() carries each config/slam/odometry/<name>.yaml as the
    JAX package composes it, with the runner settings the JAX tests add
    (tests/test_slam_e2e.py, tests/test_high_speed.py), field for field;
    and ICPFrameToModel builds each on the device it is given."""
    monkeypatch.setenv("KITTI_ODOM_ROOT", "/tmp")
    tcfg = tacc.profile_configs()[name]
    runner = {"num_points_padded": tcfg.num_points_padded}
    if name == "aggregated_highway":
        runner.update(upload_format="rimg8", batch_size=12)
    od = compose("config", "slam", overrides=[f"slam/odometry={name}"] + [
        f"slam.odometry.{k}={v}" for k, v in runner.items()])["slam"]["odometry"]
    jd = dataclasses.asdict(dataclass_from_dict(JICPConfig, od))
    td = dataclasses.asdict(tcfg)
    assert td.pop("device") == "cuda"
    jd.pop("device")
    assert td == jd
    odom = TICP(tcfg, projector=TLoader(TCfg(lidar_height=16, lidar_width=128)).projector(),
                device="cpu")
    assert odom.device.type == "cpu" and odom._map_state.xyz.device.type == "cpu"
