"""The port's projective ring-buffer map (the JAX ICPFrameToModel's default
map) against the JAX package's, on the CPU, with seeded numpy inputs and
the JAX side in float32 (``jax.enable_x64(False)``).

Tolerances:
- ``build_vertex_map``: bit for bit on clouds whose float64 row and column
  lie at least 1e-3 px from a .5 rounding edge.  On the edge one ulp of
  ``asin`` or ``atan2`` decides the pixel (ROADMAP.md §C2), so the
  whole-slice runs use de-calibrated beams (0.1 deg jitter);
- ``compute_neighbors``: neighbours and fields bit for bit (they are
  gathered), the same argmins, on tie-free data; ``oriented_normal_map``
  1e-5;
- ``gauss_newton``: 1e-5;
- one step from the same map state: pose 2e-5 m, the same iterations,
  matches and insert flag;
- frames 0-6 of the jittered sequence: 1e-3 m / 1e-4 rad (the JAX program
  itself drifts by up to 7e-3 m under a 1e-7 input perturbation, so later
  frames are held by metric, 2e-2 m / 2e-3 rad);
- vertex-map inputs on the projective, aggregated and surfel maps (the
  voxel map's in tests/test_torch_voxel_map.py): the same poses as the JAX
  package fed the same vertex map, and (3, H, W) and tensor inputs equal to
  (H, W, 3) bit for bit; batched vertex-map inputs as the per-frame run.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.eval import acceptance as jacc
from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import optimization as jopt
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry import icp_odometry as jicp
from pylidar_slam_tpu.slam.odometry import local_map as jlm
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import optimization as topt
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.slam.odometry import icp_odometry as ticp
from pylidar_slam_tpu_torch.slam.odometry import local_map as tlm
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_odometry import _assert_poses_close, _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
H, W, N, K = 32, 256, 7, 4
SEQ = dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N,
           beam_jitter_deg=0.1)
PROJ = tproj.SphericalProjection(H, W, tacc.UP_FOV, tacc.DOWN_FOV)
JPROJ = jproj.SphericalProjection(*PROJ)
GN = dict(scheme="neighborhood", sigma=0.2, max_iters=1)


def _config(batch_size=1, **over):
    """The projective map as config/slam/odometry (icp_odometry.yaml with
    local_map=projective, the neighborhood alignment), K = 4."""
    kw = dict(max_num_alignments=10, data_key="numpy_pc", num_points_padded=H * W,
              local_map={"type": "projective_local_map", "local_map_size": K},
              alignment={"gauss_newton_config": GN}, batch_size=batch_size, **over)
    return ticp.ICPFrameToModelConfig(device="cpu", **kw), jicp.ICPFrameToModelConfig(**kw)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**SEQ))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _off_edge_cloud(rng, n):
    """Points whose float64 pixel row and column sit >= 1e-3 px from a .5
    edge, plus exact duplicates and same-range pairs (the index tie-break)."""
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(2.0, 60.0, (4 * n, 1))).astype(np.float32)
    p64 = pts.astype(np.float64)
    r = np.linalg.norm(p64, axis=1)
    fov_up, fov_down = np.radians(PROJ.up_fov), np.radians(PROJ.down_fov)
    fov = abs(fov_up) + abs(fov_down)
    col = 0.5 * (-np.arctan2(p64[:, 1], p64[:, 0]) / np.pi + 1.0) * W
    row = (1.0 - (np.arcsin(p64[:, 2] / r) + abs(fov_down)) / fov) * H
    ok = (np.abs(col % 1.0 - 0.5) > 1e-3) & (np.abs(row % 1.0 - 0.5) > 1e-3)
    pts = pts[ok][:n]
    dup = pts[: n // 20]
    return np.concatenate([pts, dup, pts[: n // 20] * 1.0], axis=0)


def test_build_vertex_map_bit_for_bit_off_the_edge():
    rng = np.random.default_rng(0)
    clouds = [_off_edge_cloud(rng, 6000) for _ in range(3)]
    n = min(len(c) for c in clouds)
    clouds = np.stack([c[:n] for c in clouds])
    masks = rng.random(clouds.shape[:2]) < 0.9
    chans = rng.normal(size=clouds.shape[:2] + (3,)).astype(np.float32)
    chans = np.concatenate([clouds, chans], axis=-1)
    with jax.enable_x64(False):
        ref = [np.asarray(jproj.build_vertex_map(jnp.asarray(c), JPROJ, mask=jnp.asarray(m),
                                                 channels=jnp.asarray(ch)))
               for c, m, ch in zip(clouds, masks, chans)]
        ref_xyz = np.asarray(jproj.build_vertex_map(jnp.asarray(clouds[0]), JPROJ))
    got = tproj.build_vertex_map(torch.from_numpy(clouds), PROJ, mask=torch.from_numpy(masks),
                                 channels=torch.from_numpy(chans)).numpy()
    assert got.shape == (3, H, W, 6)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
        assert (np.abs(r[..., :3]).max(-1) > 0).mean() > 0.1
    assert np.array_equal(tproj.build_vertex_map(torch.from_numpy(clouds[0]), PROJ).numpy(),
                          ref_xyz)
    pts = tproj.vertex_map_to_points(torch.from_numpy(got))
    assert pts.shape == (3, H * W, 6)
    assert np.array_equal(pts.numpy(), np.asarray(jproj.vertex_map_to_points(jnp.asarray(got))))


def _vmaps(rng, k):
    """Tie-free vertex maps with empty pixels: a target and K references."""
    base = rng.uniform(-20, 20, (H, W, 3)).astype(np.float32)
    refs = (base[None] + rng.normal(0, 0.3, (k, H, W, 3))).astype(np.float32)
    refs[rng.random((k, H, W)) < 0.2] = 0.0
    tgt = (base + rng.normal(0, 0.3, (H, W, 3))).astype(np.float32)
    tgt[rng.random((H, W)) < 0.1] = 0.0
    return tgt, refs


def test_compute_neighbors_and_normal_maps_match_jax():
    rng = np.random.default_rng(1)
    tgt, refs = _vmaps(rng, 5)
    fields = rng.normal(size=refs.shape[:-1] + (4,)).astype(np.float32)
    with jax.enable_x64(False):
        jn, jf = jgeo.compute_neighbors(jnp.asarray(tgt), jnp.asarray(refs), jnp.asarray(fields))
        jnone = jgeo.compute_neighbors(jnp.asarray(tgt), jnp.asarray(refs))[1]
        j_or = np.asarray(jgeo.oriented_normal_map(jnp.asarray(refs[0])))
        j_mask = np.asarray(jgeo.mask_not_null(jnp.asarray(refs)))
    tn, tf = tgeo.compute_neighbors(torch.from_numpy(tgt), torch.from_numpy(refs),
                                    torch.from_numpy(fields))
    assert jnone is None and tgeo.compute_neighbors(
        torch.from_numpy(tgt), torch.from_numpy(refs))[1] is None
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    # the argmins: every found neighbour is the reference of the same slot
    slot = np.argmax(np.all(refs == tn.numpy()[None], axis=-1), axis=0)
    found = np.abs(tn.numpy()).max(-1) > 0
    assert found.mean() > 0.8
    assert np.array_equal(tf.numpy()[found], np.take_along_axis(
        fields, slot[None, ..., None], 0)[0][found])
    np.testing.assert_allclose(tgeo.oriented_normal_map(torch.from_numpy(refs[0])).numpy(),
                               j_or, rtol=0, atol=1e-5)
    assert np.array_equal(tgeo.mask_not_null(torch.from_numpy(refs)).numpy(), j_mask)


@pytest.mark.parametrize("scheme,max_iters", [("neighborhood", 1), ("geman_mcclure", 5),
                                              ("least_square", 3)])
def test_gauss_newton_matches_jax(scheme, max_iters):
    rng = np.random.default_rng(2)
    n = 3000
    t = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    r = (t + 0.05 * rng.normal(size=(n, 3)) + np.array([0.1, -0.05, 0.02])).astype(np.float32)
    mask = rng.random(n) < 0.9
    sq = np.sum((t - r) ** 2, axis=1).astype(np.float32)
    kw = dict(max_iters=max_iters, norm_stop_criterion=1e-4, scheme=scheme, sigma=0.3)
    with jax.enable_x64(False):
        jt, jr, jnm, jm = map(jnp.asarray, (t, r, nrm, mask))
        jres = jopt.gauss_newton(
            jnp.zeros(6, jnp.float32),
            lambda p: jopt.point_to_plane_residuals(p, jt, jr, jnm, jm),
            lambda p: jopt.point_to_plane_jacobian(p, jt, jnm, jm),
            sq_dists=jnp.asarray(sq), **kw)
    tt, tr, tn, tm = map(torch.from_numpy, (t, r, nrm, mask))
    tres = topt.gauss_newton(
        torch.zeros(6), lambda p: topt.point_to_plane_residuals(p, tt, tr, tn, tm),
        lambda p: topt.point_to_plane_jacobian(p, tt, tn, tm),
        sq_dists=torch.from_numpy(sq), **kw)
    np.testing.assert_allclose(tres.params.numpy(), np.asarray(jres.params), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tres.delta_norm), float(jres.delta_norm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    assert bool(tres.singular) == bool(jres.singular) is False
    assert np.abs(np.asarray(jres.params)).max() > 1e-2


def test_projective_state_roundtrip():
    rng = np.random.default_rng(3)
    arrays = {name: rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
              for name in ("vmaps", "nmaps", "model_vmaps", "model_nmaps")}
    arrays.update(poses=rng.normal(size=(2, 4, 4)).astype(np.float32),
                  count=np.array(2, np.int32), write_idx=np.array(1, np.int32))
    back = tlm.projective_state_to_numpy(tlm.projective_state_from_numpy(arrays, "cpu"))
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)


def _vmap_of(frame):
    """A frame's (H, W, 3) vertex map (built by the port on the CPU, equal
    to the JAX package's off the .5 edge)."""
    pc = torch.from_numpy(np.asarray(frame["numpy_pc"], np.float32)[:, :3])
    return tproj.build_vertex_map(pc, PROJ).numpy()


def test_step_from_the_same_state(frames, loader):
    """first_frame on the JAX side, then one step of both from that state
    (carried across with projective_state_from_numpy), prior: the ground
    truth's motion."""
    gn_cfg = jicp.GaussNewtonConfig(**GN)
    kw = dict(max_num_alignments=10, threshold_delta_pose=1e-4, threshold_trans=0.1,
              threshold_rot=0.3)
    jstep, jfirst, _ = jicp.make_icp_frame_step(JPROJ, gn=gn_cfg, **kw)
    tstep, _, _ = ticp.make_icp_frame_step(PROJ, gn=ticp.GaussNewtonConfig(**GN), **kw)
    v0, v1 = _vmap_of(frames[0]), _vmap_of(frames[1])
    eye = np.eye(4, dtype=np.float32)
    prior = loader.get_ground_truth("synth_00")[1].astype(np.float32)
    with jax.enable_x64(False):
        state = jfirst(jlm.init_projective_map(K, H, W), jnp.asarray(v0))
        tstate = tlm.projective_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
        jstate, jdelta, jres = jstep(state, jnp.asarray(eye), jnp.asarray(v1),
                                     jnp.asarray(prior))
    ts, tdelta, tres = tstep(tstate, torch.from_numpy(eye), torch.from_numpy(v1),
                             torch.from_numpy(prior))
    np.testing.assert_allclose(tres.pose_matrix.numpy()[:3, 3],
                               np.asarray(jres.pose_matrix)[:3, 3], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tres.pose_params.numpy(), np.asarray(jres.pose_params),
                               rtol=0, atol=2e-5)
    assert (tres.num_iters.item(), tres.num_matches.item(), tres.inserted.item()) == \
        (int(jres.num_iters), int(jres.num_matches), bool(jres.inserted))
    assert tres.num_iters.item() > 1 and tres.num_matches.item() > H * W // 4
    assert tres.inserted.item()
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-3)
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), rtol=0, atol=2e-5)
    back = tlm.projective_state_to_numpy(ts)
    for name in ("count", "write_idx", "vmaps"):
        assert np.array_equal(back[name], np.asarray(getattr(jstate, name))), name
    # The new frame's normal map: the uncentered window solve is
    # ill-conditioned in float32, and the jitted JAX step's own normals
    # differ from its op-by-op normals on half of the pixels (by up to 0.18
    # on this frame), so the port is held to the op-by-op ones.
    with jax.enable_x64(False):
        eager = np.asarray(jgeo.compute_normal_map(jnp.asarray(v1), 5))
    np.testing.assert_allclose(back["nmaps"][1], eager, rtol=0, atol=1e-3)
    assert np.array_equal(back["nmaps"][0], np.asarray(jstate.nmaps)[0])
    np.testing.assert_allclose(back["poses"], np.asarray(jstate.poses), rtol=0, atol=2e-5)
    # the re-projected model carries the pose's last-bit differences, which
    # move a few vertices across a .5 pixel edge
    close = np.all(np.abs(back["model_vmaps"] - np.asarray(jstate.model_vmaps)) < 1e-4,
                   axis=-1)
    assert close.mean() > 0.99


def _run(odom, frames, key="numpy_pc", to_input=None):
    """Feeds the frames with the previous pose as the prior; returns the
    relative poses."""
    last = np.eye(4, dtype=np.float32)
    for f in frames:
        d = dict(f, init_rpose=last)
        if to_input is not None:
            d[key] = to_input(f)
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
    odom.finish()
    return odom.get_relative_poses()


def _capture_results(odom, monkeypatch):
    """Records the ICPStepResult of every projective step."""
    local_map = getattr(odom, "_map", None)  # the port drives its map's record
    log, step = [], odom._step if local_map is None else local_map.step

    def wrap(*args):
        out = step(*args)
        log.append(out[2])
        return out

    if local_map is None:
        monkeypatch.setattr(odom, "_step", wrap)
    else:
        monkeypatch.setattr(odom, "_map", local_map._replace(step=wrap))
    return log


def test_frames_0_6_match_jax(frames, loader, monkeypatch):
    """ICPFrameToModel with the projective map over the jittered frames: the
    cloud rasterized on the device, the EI bootstrap on frame 1, batch_size
    4 ignored (one frame per step, as in the JAX package)."""
    tcfg, jcfg = _config(batch_size=4)
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jcfg, projector=JPROJ)
    j.init()
    tlog, jlog = _capture_results(t, monkeypatch), _capture_results(j, monkeypatch)
    tp = _run(t, frames)
    with jax.enable_x64(False):
        jp = _run(j, frames)
    assert len(tlog) == len(jlog) == N - 1
    assert [bool(r.inserted) for r in tlog] == [bool(r.inserted) for r in jlog]
    assert tp.shape == jp.shape == (N, 4, 4)
    _assert_poses_close(tp, jp, "projective map")
    # the frame's vertex map goes downstream as odometry_pc
    t = TICP(tcfg, projector=loader.projector())
    first, second = dict(frames[0]), dict(frames[1])
    t.process_next_frame(first)
    t.process_next_frame(second)
    assert "odometry_pc" not in first and second["odometry_pc"].shape == (H, W, 3)
    assert second["odometry_pose"].shape == (4, 4)


def test_projective_is_the_default_map(loader):
    """A config that names no map runs the projective map, as the JAX
    package's."""
    t = TICP(ticp.ICPFrameToModelConfig(device="cpu", data_key="numpy_pc",
                                        num_points_padded=H * W),
             projector=loader.projector())
    j = JICP(jicp.ICPFrameToModelConfig(data_key="numpy_pc", num_points_padded=H * W),
             projector=JPROJ)
    assert t._mode == j._mode == "projective_local_map"
    assert t.local_map_size == j.local_map_size == 20
    assert t._map_state.vmaps.shape == (20, H, W, 3)


def test_projective_refusals(loader):
    cfg, _ = _config(upload_format="rimg8")
    with pytest.raises(AssertionError, match="no effect"):
        TICP(cfg, projector=loader.projector())


# the voxel map's case runs at 64x1024 in tests/test_torch_voxel_map.py
MAPS = ["projective_local_map", "aggregated_local_map", "kdtree_local_map"]


def _map_configs(map_type):
    if map_type == "projective_local_map":
        return _config()
    if map_type == "voxel_local_map":
        tv = tacc.profile_configs()["voxel"]
        lm = dict(tv.local_map, table_slots=16384, target_samples=2048)
        kw = {f.name: getattr(tv, f.name) for f in dataclasses.fields(tv) if f.name != "device"}
        kw.update(local_map=lm, num_points_padded=H * W + (H + W + 1) // 2, batch_size=1)
        return ticp.ICPFrameToModelConfig(device="cpu", **kw), jicp.ICPFrameToModelConfig(**kw)
    name = "aggregated" if map_type == "aggregated_local_map" else "surfel"
    t, j = tacc.champion_configs()[name], jacc.champion_configs()[name]
    over = dict(num_points_padded=H * W + (H + W + 1) // 2 if name == "aggregated"
                else H * W, batch_size=1)
    if name == "surfel":
        # image normals: the champion's k-NN normals are held by metric
        # (tests/test_torch_surfel.py)
        lm = dict(t.local_map, local_map_size=K, points_per_frame=512, target_samples=2048,
                  normals_mode="image")
        over["local_map"] = lm
    return (dataclasses.replace(t, device="cpu", **over), dataclasses.replace(j, **over))


@pytest.mark.parametrize("map_type", MAPS)
def test_vertex_map_inputs_on_every_map(frames, loader, map_type):
    """The frames as (H, W, 3) vertex maps through the port and the JAX
    package on every map, and as (3, H, W) through the port: the same
    poses."""
    tcfg, jcfg = _map_configs(map_type)
    n = 4
    with jax.enable_x64(False):
        j = JICP(jcfg, projector=JPROJ)
        j.init()
        jp = _run(j, frames[:n], to_input=_vmap_of)
    tp = _run(TICP(tcfg, projector=loader.projector()), frames[:n], to_input=_vmap_of)
    chw = _run(TICP(tcfg, projector=loader.projector()), frames[:n],
               to_input=lambda f: np.ascontiguousarray(np.transpose(_vmap_of(f), (2, 0, 1))))
    as_tensor = _run(TICP(tcfg, projector=loader.projector()), frames[:n],
                     to_input=lambda f: torch.from_numpy(_vmap_of(f)))
    assert np.array_equal(chw, tp) and np.array_equal(as_tensor, tp)
    _assert_poses_close(tp, jp, f"vertex-map input, {map_type}")
    assert np.linalg.norm(tp[1:, :3, 3], axis=1).min() > 0.5  # it moved


@pytest.mark.parametrize("map_type", ["aggregated_local_map", "voxel_local_map"])
def test_vertex_map_inputs_batched(frames, loader, map_type):
    """Batched maps buffer vertex-map inputs on the device: batch 3 gives
    the per-frame run's poses."""
    tcfg, _ = _map_configs(map_type)
    one = _run(TICP(tcfg, projector=loader.projector()), frames, to_input=_vmap_of)
    three = _run(TICP(dataclasses.replace(tcfg, batch_size=3), projector=loader.projector()),
                 frames, to_input=_vmap_of)
    np.testing.assert_allclose(three, one, rtol=0, atol=1e-6)


CLI = ["dataset=synthetic", "dataset.num_frames=5", f"dataset.lidar_height={H}",
       f"dataset.lidar_width={W}", "dataset.beam_jitter_deg=0.1",
       "slam/odometry/local_map=projective", "slam.odometry.local_map.local_map_size=4",
       f"slam.odometry.num_points_padded={H * W}"]


def test_cli_runs_the_projective_map(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pylidar_slam_tpu_torch.run", *CLI, "device=cpu",
         f"log_dir={tmp_path}"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = (tmp_path / "metrics.yaml").read_text()
    assert "synth_00" in text and "ATE" in text
    poses = np.loadtxt(tmp_path / "synth_00.poses.txt", delimiter=",", skiprows=1)
    assert poses.shape == (5, 12) and np.isfinite(poses).all()
