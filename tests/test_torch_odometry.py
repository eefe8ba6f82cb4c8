"""The port's aggregated-map odometry against the JAX package's, on the
same numpy-seeded synthetic frames, on the CPU.

Per step, from the same map state, the two agree to ~1e-6 m.  Over a
sequence they drift apart: a one-ulp difference (sin/cos/atan2 round
differently in the two frameworks) now and then moves a point across a
z-buffer pixel boundary or tips an ill-conditioned normal fit, and the map
carries that forward.  The JAX program itself drifts the same way under
perturbations that small (a 1e-7 relative change of its input clouds moves
its own per-frame poses by up to 7e-3 m within 14 frames at 32x256).  So
poses are held at 1e-3 m / 1e-4 rad over the first frames, before such a
flip can compound, and at 2e-2 m / 2e-3 rad -- about three times the JAX
program's own drift -- over the whole run, with identical insert
decisions and matching accuracy against ground truth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.eval import acceptance as jacc
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry import aggregated_map as jam
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP
from pylidar_slam_tpu.utils import prewarm

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.ops import se3 as tse3
from pylidar_slam_tpu_torch.ops.kernels import assoc_gn
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

H, W, N = 32, 256, 14
SEQ = dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N)
CAP = H * W + (H + W + 1) // 2 + 112  # rimg8 rows + zero padding
TIGHT = dict(trans=1e-3, rot=1e-4)
TIGHT_FRAMES = 7  # sequence frames 0-6
DRIFT = dict(trans=2e-2, rot=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    ds = TLoader(TCfg(**SEQ)).sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _configs(**over):
    over = dict(dict(num_points_padded=CAP), **over)
    t = dataclasses.replace(tacc.champion_configs()["aggregated"], device="cpu", **over)
    j = dataclasses.replace(jacc.champion_configs()["aggregated"], **over)
    return t, j


@pytest.fixture(scope="module")
def jax_odom():
    """One JAX odometry for the module, so its jitted steps compile once."""
    odom = JICP(_configs()[1], projector=jproj.SphericalProjection(
        *TLoader(TCfg(**SEQ)).projector()))
    odom.init()
    for t in list(prewarm._threads):  # its background compile, not ours
        t.join()
    return odom


def _capture_diags(odom, to_np, monkeypatch):
    """Records the (loss, iterations, matches, inserted) diagnostics of every
    device step the odometry runs."""
    log = []
    local_map = getattr(odom, "_map", None)  # the port drives its map's record
    batch_step, step = (odom._batch_step, odom._step) if local_map is None else \
        (local_map.batch_step, local_map.step)

    def batch_wrap(*args):
        out = batch_step(*args)
        log.extend(zip(*[to_np(d) for d in out[4]]))
        return out

    def step_wrap(*args):
        out = step(*args)
        log.append(tuple(to_np(d) for d in out[4]))
        return out

    if local_map is None:
        monkeypatch.setattr(odom, "_batch_step", batch_wrap)
        monkeypatch.setattr(odom, "_step", step_wrap)
    else:
        monkeypatch.setattr(odom, "_map", local_map._replace(batch_step=batch_wrap,
                                                             step=step_wrap))
    return log


def _pose_errors(a, b):
    """Per-frame translation (m) and rotation (rad) gaps of two (T, 4, 4)
    relative-pose sequences."""
    trans = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    rel = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    # small-angle form (the trace form loses ~1e-4 rad to float32 inputs)
    skew = np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                     rel[:, 1, 0] - rel[:, 0, 1]], axis=1)
    rot = np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2, 0, 1))
    return trans, rot


def _assert_poses_close(ours, ref, label, first_frame=0):
    """`ours` / `ref` hold sequence frames first_frame, first_frame+1, ..."""
    trans, rot = _pose_errors(ours, ref)
    k = TIGHT_FRAMES - first_frame
    print(f"\n{label}: max per-frame gap {trans.max():.3e} m, {rot.max():.3e} rad "
          f"(frames < {TIGHT_FRAMES}: {trans[:k].max():.3e} m, {rot[:k].max():.3e} rad)")
    assert trans[:k].max() < TIGHT["trans"] and rot[:k].max() < TIGHT["rot"], \
        (trans[:k], rot[:k])
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"], (trans, rot)


def test_ei_bootstrap_pose_matches_jax(frames, jax_odom):
    t = TICP(_configs()[0], projector=TLoader(TCfg(**SEQ)).projector())
    j = jax_odom
    t._boot_cloud = frames[0]["numpy_pc"]
    j._boot_cloud = frames[0]["numpy_pc"]
    tm = t._ei_bootstrap_pose(dict(frames[1]))
    with jax.enable_x64(False):
        jm = j._ei_bootstrap_pose(dict(frames[1]))
    assert tm is not None and jm is not None
    tm, jm = tm.numpy(), np.asarray(jm)
    # the same yaw bin and sub-pixel peak: FFT and trig rounding only
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4)
    # and it is a real motion estimate (the sequence moves 1.1 m/frame)
    assert 0.9 < np.linalg.norm(tm[:2, 3]) < 1.3


def test_step_and_batch_step_from_the_same_state(frames, jax_odom):
    """One step, then one 12-frame batch_step, each started on both sides
    from the same map state (the JAX state converted with
    agg_state_from_numpy)."""
    proj = TLoader(TCfg(**SEQ)).projector()
    jp = jproj.SphericalProjection(*proj)
    t = TICP(_configs()[0], projector=proj)
    j = jax_odom

    def upload(i):
        buf = jproj.np_encode_range_image(frames[i]["numpy_pc"], jp, planes=True)
        out = np.zeros((CAP, 2), np.uint8)
        out[:buf.shape[0]] = buf
        return out

    def to_torch(state):
        return tam.agg_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")

    ones = np.ones(CAP, bool)
    eye = np.eye(4, dtype=np.float32)
    with jax.enable_x64(False):
        state = j._first(jam.init_agg_map(H, W), jnp.asarray(upload(0)),
                         jnp.asarray(ones))
        tstate = to_torch(state)
        jout = j._step(state, jnp.asarray(eye), jnp.asarray(upload(1)),
                       jnp.asarray(ones), jnp.asarray(eye))
    tout = t._map.step(tstate, torch.from_numpy(eye), torch.from_numpy(upload(1)),
                   torch.from_numpy(ones), torch.from_numpy(eye))
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=1e-5)
    for a, b in zip(tout[4], jout[4]):
        if a.dtype == torch.float32:  # the final loss
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
        else:  # iterations, matches, insert
            assert a.item() == np.asarray(b).item()
    np.testing.assert_allclose(tout[0].xyz.numpy(), np.asarray(jout[0].xyz),
                               rtol=0, atol=1e-4)

    state, delta, rpose = jout[0], jout[1], jout[2]
    tstate = to_torch(state)
    pts = np.stack([upload(i) for i in range(2, 14)])
    masks = np.ones((12, CAP), bool)
    with jax.enable_x64(False):
        jb = j._batch_step(state, delta, rpose, jnp.asarray(pts), jnp.asarray(masks))
    tb = t._map.batch_step(tstate, torch.as_tensor(np.asarray(delta)),
                       torch.as_tensor(np.asarray(rpose)), torch.from_numpy(pts),
                       torch.from_numpy(masks))
    assert np.array_equal(tb[4][3].numpy(), np.asarray(jb[4][3]))  # inserts
    to_mats = lambda p: tse3.build_pose_matrix(torch.as_tensor(np.asarray(p))).numpy()
    _assert_poses_close(to_mats(tb[3]).astype(np.float64),
                        to_mats(jb[3]).astype(np.float64), "12-frame batch_step",
                        first_frame=2)


def test_whole_slice_matches_jax(frames, jax_odom, monkeypatch):
    """ICPFrameToModel with the champion configuration over 14 frames: the
    first frame, one batch of 12 (EI bootstrap on frame 1), one remainder
    frame."""
    t = TICP(_configs()[0], projector=TLoader(TCfg(**SEQ)).projector())
    j = jax_odom
    j.init()
    tlog = _capture_diags(t, lambda x: x.numpy(), monkeypatch)
    jlog = _capture_diags(j, np.asarray, monkeypatch)
    launches = assoc_gn.assoc_gn.launches
    for f in frames:
        t.process_next_frame(dict(f))
    t.finish()
    with jax.enable_x64(False):
        for f in frames:
            j.process_next_frame(dict(f))
        j.finish()
    assert assoc_gn.assoc_gn.launches == launches  # CPU: the plain version
    assert len(tlog) == len(jlog) == N - 1
    t_ins = [bool(d[3]) for d in tlog]
    assert t_ins == [bool(d[3]) for d in jlog]

    with jax.enable_x64(False):
        jp = j.get_relative_poses()
    tp = t.get_relative_poses()
    assert tp.shape == jp.shape == (N, 4, 4)
    _assert_poses_close(tp, jp, "ICPFrameToModel, 14 frames")
    gt = TLoader(TCfg(**SEQ)).get_ground_truth("synth_00")[:N]
    t_ate, _ = tev.compute_ate(tp, gt)
    j_ate, _ = tev.compute_ate(jp, gt)
    assert t_ate < 0.05 and abs(t_ate - j_ate) < 0.1 * j_ate
    abs_poses = t.absolute_poses
    assert len(abs_poses) == N
    np.testing.assert_allclose(abs_poses[-1], tev.compute_absolute_poses(tp)[-1],
                               atol=1e-9)
