"""The port's surfel ("kdtree") map odometry against the JAX package's, on
the same numpy-seeded synthetic frames, on the CPU, at 32x256 with K = 4
frames x S = 512 surfels and M = 2048 targets.

The frames come from de-calibrated beams (0.1 deg jitter), as in the f32
upload test of tests/test_torch_odometry_paths.py: on exact pixel-center
beams a one-ulp atan2 difference decides the pixel of every point.  Frames
are fed with the previous frame's pose as the prior, as a user's pipeline
(and the JAX package's fixture recorder) feeds them.

From the same map state one step agrees to ~1e-6 m with identical counts.
Over a sequence, with image normals, the gap grows as in slice 1
(tests/test_torch_odometry.py), from last-bit differences that now and then
move a surfel's normal fit.  The JAX program drifts as much from itself: a
1e-7 relative change of its input clouds moves its poses here by up to
1.1e-3 m within frames 0-6 (3.7e-3 m over 12 frames with knn normals), and
a 3e-7 change turns them by 5.4e-4 rad at frame 4.  So frames 0-6 are held
at 2.5e-3 m / 1e-3 rad and the whole run at 2e-2 m / 2e-3 rad, with
identical insert decisions.  The champion's k-NN
normals are held by metric (tests/test_torch_surfel_champion.py): their closed-form eigen-solve is ill-conditioned when two
eigenvalues are close next to a large one (the cubic's arccos argument
sits at 1), so one rounding of det(B) decides the normal -- the JAX package
itself gives different normals there jitted and op by op -- and the map
carries such a normal forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.eval import acceptance as jacc
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry import surfel_map as jsm
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as tsm
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_odometry import (DRIFT, TIGHT_FRAMES, _capture_diags,
                                 _one_torch_thread,  # noqa: F401
                                 _pose_errors)

H, W, N = 32, 256, 10
K, S, M = 4, 512, 2048
SEQ = dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N,
           beam_jitter_deg=0.1)
CAP = H * W
TIGHT = dict(trans=2.5e-3, rot=1e-3)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**SEQ))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _configs(**local_map):
    lm = dict(local_map_size=K, points_per_frame=S, target_samples=M, **local_map)
    t = tacc.champion_configs()["surfel"]
    j = jacc.champion_configs()["surfel"]
    return (dataclasses.replace(t, local_map=dict(t.local_map, **lm),
                                num_points_padded=CAP, device="cpu"),
            dataclasses.replace(j, local_map=dict(j.local_map, **lm),
                                num_points_padded=CAP))


def _padded(frame):
    pts = np.zeros((CAP, 3), np.float32)
    pc = np.asarray(frame["numpy_pc"], np.float32)[:, :3]
    pts[:len(pc)] = pc
    return pts


def _run(odom, frames):
    """Feeds the frames with the previous pose as the prior; returns the
    relative poses."""
    last = np.eye(4, dtype=np.float32)
    for f in frames:
        d = dict(f, init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
    odom.finish()
    return odom.get_relative_poses()


def test_champion_config_matches_the_jax_package():
    t, j = tacc.champion_configs()["surfel"], jacc.champion_configs()["surfel"]
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert td.pop("device") == "cuda" and jd.pop("device") == "tpu"
    assert td == jd
    lm = dataclasses.asdict(tsm.SurfelRingMapConfig(**t.local_map))
    assert lm == dataclasses.asdict(jsm.SurfelRingMapConfig(**j.local_map))


def test_surfel_state_roundtrip():
    rng = np.random.default_rng(0)
    arrays = {"points": rng.normal(size=(8, 3)).astype(np.float32),
              "normals": rng.normal(size=(8, 3)).astype(np.float32),
              "valid": rng.random(8) < 0.5,
              "write_slot": np.array(3, np.int32),
              "anchor_from_cur": np.eye(4, dtype=np.float32),
              "table_pts": rng.normal(size=(4, 2, 3)).astype(np.float32),
              "table_ids": rng.integers(-1, 8, (4, 2)).astype(np.int32)}
    back = tsm.surfel_state_to_numpy(tsm.surfel_state_from_numpy(arrays, "cpu"))
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    # the JAX package's initial state keeps the table flat
    flat = dict(arrays, table_pts=arrays["table_pts"].reshape(-1, 3))
    state = tsm.surfel_state_from_numpy(flat, "cpu")
    assert state.table_pts.shape == (4, 2, 3)


@pytest.mark.parametrize("backend", ["exact", "hash"])
def test_step_from_the_same_state(frames, loader, backend):
    """first_frame on the JAX side, then one step on both sides from that
    state (converted with surfel_state_from_numpy), the champion's knn
    normals, the prior of ground truth."""
    tcfg, _ = _configs(nn_backend=backend)
    mc = dict(tcfg.local_map)
    proj = loader.projector()
    kw = dict(max_num_alignments=20, threshold_delta_pose=1e-4,
              threshold_trans=0.1, threshold_rot=0.3,
              gn_scheme="neighborhood", gn_sigma=0.2)
    jstep, jfirst, _ = jsm.make_surfel_icp_frame_step(
        jproj.SphericalProjection(*proj), jsm.SurfelRingMapConfig(**mc), **kw)
    tstep, _, _ = tsm.make_surfel_icp_frame_step(
        proj, tsm.SurfelRingMapConfig(**mc), **kw)
    nb, cap = (tsm.SurfelRingMapConfig.hash_buckets,
               tsm.SurfelRingMapConfig.hash_capacity) if backend == "hash" else (0, 0)
    ones = np.ones(CAP, bool)
    eye = np.eye(4, dtype=np.float32)
    prior = loader.get_ground_truth("synth_00")[1].astype(np.float32)
    with jax.enable_x64(False):
        state = jfirst(jsm.init_surfel_map(K, S, hash_buckets=nb, hash_capacity=cap),
                       jnp.asarray(_padded(frames[0])), jnp.asarray(ones))
        tstate = tsm.surfel_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
        jout = jstep(state, jnp.asarray(eye), jnp.asarray(_padded(frames[1])),
                     jnp.asarray(ones), jnp.asarray(prior))
    tout = tstep(tstate, torch.from_numpy(eye), torch.from_numpy(_padded(frames[1])),
                 torch.from_numpy(ones), torch.from_numpy(prior))
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=2e-5)
    loss, it, matches, inserted = tout[4]
    np.testing.assert_allclose(float(loss), float(jout[4][0]), rtol=1e-4)
    assert (it.item(), matches.item(), inserted.item()) == \
        tuple(np.asarray(x).item() for x in jout[4][1:])
    assert it.item() > 1 and matches.item() > M // 4 and inserted.item()
    # the inserted map: the same surfels and slot; their coordinates and the
    # anchor carry the pose's last-bit differences
    ts, js = tsm.surfel_state_to_numpy(tout[0]), jout[0]
    for name in ("valid", "write_slot"):
        assert np.array_equal(ts[name], np.asarray(getattr(js, name))), name
    for name in ("points", "anchor_from_cur"):
        np.testing.assert_allclose(ts[name], np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-4)
    if backend == "hash":  # a surfel on a voxel face may change bucket
        assert np.mean(ts["table_ids"] == np.asarray(js.table_ids)) > 0.999
    tn, jn = ts["normals"], np.asarray(js.normals)
    agree = np.abs(np.sum(tn * jn, axis=1)) > 1 - 1e-5
    assert agree[ts["valid"]].mean() > 0.98  # the rest: ill-conditioned fits


@pytest.mark.parametrize("backend", ["exact", "hash"])
def test_whole_slice_matches_jax(frames, loader, backend, monkeypatch):
    """ICPFrameToModel over the frames with the image normals: the per-frame
    path, the EI bootstrap on frame 1, the exact or hash search."""
    tcfg, jcfg = _configs(normals_mode="image", nn_backend=backend)
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jcfg, projector=jproj.SphericalProjection(*loader.projector()))
    j.init()
    tlog = _capture_diags(t, lambda x: x.numpy(), monkeypatch)
    jlog = _capture_diags(j, np.asarray, monkeypatch)
    launches = b2.nn_argmin.launches
    tp = _run(t, frames)
    with jax.enable_x64(False):
        jp = _run(j, frames)
    assert b2.nn_argmin.launches == launches  # CPU: the plain version
    assert len(tlog) == len(jlog) == N - 1
    assert [bool(d[3]) for d in tlog] == [bool(d[3]) for d in jlog]
    assert tp.shape == jp.shape == (N, 4, 4)
    trans, rot = _pose_errors(tp, jp)
    print(f"\nsurfel {backend}, image normals: max per-frame gap {trans.max():.3e} m, "
          f"{rot.max():.3e} rad (frames < {TIGHT_FRAMES}: "
          f"{trans[:TIGHT_FRAMES].max():.3e} m, {rot[:TIGHT_FRAMES].max():.3e} rad)")
    assert trans[:TIGHT_FRAMES].max() < TIGHT["trans"]
    assert rot[:TIGHT_FRAMES].max() < TIGHT["rot"]
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"]
    gt = loader.get_ground_truth("synth_00")[:N]
    t_ate, _ = tev.compute_ate(tp, gt)
    j_ate, _ = tev.compute_ate(jp, gt)
    assert t_ate < 0.1 and abs(t_ate - j_ate) < 0.05 * j_ate
