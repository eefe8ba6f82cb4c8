"""The port's continuous-time and alignment ops against the JAX package's,
on numpy-seeded float32 inputs on the CPU: the quaternion slerp and pose
interpolation, azimuth timestamps, the centered normal fit, weighted
Procrustes, the point-to-point residual and Jacobian, the GN pose priors,
the CT pose surface and the rolling-shutter frames.  Each test states its
tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.dataset.synthetic import (SyntheticConfig as JCfg,
                                                SyntheticDatasetLoader as JLoader)
from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import optimization as jopt
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.ops import registration as jreg
from pylidar_slam_tpu.ops import se3 as jse3
from pylidar_slam_tpu.slam.odometry import icp_odometry as jicp

from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig as TCfg,
                                                      SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import optimization as topt
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.ops import registration as treg
from pylidar_slam_tpu_torch.ops import rotation as trot
from pylidar_slam_tpu_torch.ops import se3 as tse3
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry import icp_odometry as ticp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rotations(rng):
    """Euler angles: random, near identity, and within 1e-3 of pi about
    each axis and an oblique one (the Shepperd branches other than w)."""
    return np.concatenate([
        rng.uniform(-3.1, 3.1, (64, 3)), rng.uniform(-1e-4, 1e-4, (8, 3)),
        [[math.pi - 1e-3, 0, 0], [0, math.pi / 2 - 1e-3, 0], [0, 0, math.pi - 1e-3],
         [0.2, 0.1, math.pi - 1e-3], [0, 0, 0]]]).astype(np.float32)


def test_quaternions_vs_jax():
    """mat_to_quat, quat_to_mat and quat_slerp to <= 2e-6."""
    rng = np.random.default_rng(0)
    rots = trot.euler_to_mat(_t(_rotations(rng))).numpy()
    with jax.enable_x64(False):
        qj = np.asarray(jse3.mat_to_quat(jnp.asarray(rots)))
        mj = np.asarray(jse3.quat_to_mat(jnp.asarray(qj)))
        q1 = qj[::-1].copy()
        alpha = rng.random((len(qj), 1)).astype(np.float32)
        sj = np.asarray(jse3.quat_slerp(jnp.asarray(qj), jnp.asarray(q1), jnp.asarray(alpha)))
    qt = tse3.mat_to_quat(_t(rots)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tse3.quat_to_mat(_t(qj)).numpy(), mj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tse3.quat_slerp(_t(qj), _t(q1), _t(alpha)).numpy(), sj,
                               rtol=0, atol=2e-6)
    # the lerp fallback of near-parallel pairs
    with jax.enable_x64(False):
        lj = np.asarray(jse3.quat_slerp(jnp.asarray(qj), jnp.asarray(qj), jnp.asarray(alpha)))
    np.testing.assert_allclose(tse3.quat_slerp(_t(qj), _t(qj), _t(alpha)).numpy(), lj,
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("which", [0, 64, 68, 70, 72])
def test_interpolate_pose_vs_jax(which):
    """Per-point slerp of a random, a near-identity and ~pi rotations with a
    translation, at 2,000 fractions: rotations and translations <= 2e-6."""
    rng = np.random.default_rng(1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = trot.euler_to_mat(_t(_rotations(rng)[which][None]))[0].numpy()
    pose[:3, 3] = [1.2, -0.4, 0.1]
    alphas = rng.random(2000).astype(np.float32)
    with jax.enable_x64(False):
        rj, tj = jse3.interpolate_pose(jnp.asarray(pose), jnp.asarray(alphas))
    rt, tt = tse3.interpolate_pose(_t(pose), _t(alphas))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=2e-6)


def test_estimate_timestamps_vs_jax():
    """Sweep fractions of a seeded cloud (10% masked out) to <= 1e-6 off the
    azimuth seam.  The seam is x < 0, y ~ 0, where -atan2(y, x) - pi wraps
    from 0 to 2 pi: one ulp of atan2 there moves a point from alpha ~0 to
    ~1.  The cloud holds 200 points within 1e-6 rad of it; their flips are
    counted (none on this cloud), and the masked min and max, which such a
    flip would move, still agree."""
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(20000, 3)) * 10).astype(np.float32)
    pts[:200, 0] = -np.abs(pts[:200, 0])
    pts[:200, 1] = pts[:200, 0] * rng.uniform(-1e-6, 1e-6, 200).astype(np.float32)
    mask = rng.random(20000) > 0.1
    with jax.enable_x64(False):
        aj = np.asarray(jproj.estimate_timestamps(jnp.asarray(pts), True, math.pi,
                                                  jnp.asarray(mask)))
    at = tproj.estimate_timestamps(_t(pts), True, math.pi, _t(mask)).numpy()
    phis = -np.arctan2(pts[:, 1].astype(np.float64), pts[:, 0]) - math.pi
    seam = (np.abs(phis) < 1e-5) | (np.abs(phis + 2 * math.pi) < 1e-5)
    flips = int(np.sum(np.abs(at - aj)[seam] > 0.5))
    print(f"\n{int(seam.sum())} seam points, {flips} flipped")
    assert seam.sum() >= 200 and flips == 0
    np.testing.assert_allclose(at[~seam], aj[~seam], rtol=0, atol=1e-6)
    assert np.all((at[mask] >= 0) & (at[mask] <= 1))
    # the host version, unmasked
    np.testing.assert_allclose(tproj.np_estimate_timestamps(pts, True, math.pi),
                               jproj.np_estimate_timestamps(pts, True, math.pi),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_map_centered_vs_jax(seed):
    """Centered normals of a 32x256 scan against the compiled JAX fit.

    Where the covariance's two smallest eigenvalues are at least 3% of the
    largest apart (~85% of the valid pixels), normals agree to <= 1e-5.
    Closer eigenvalues turn the closed-form eigenvector on one rounding
    (ROADMAP.md section C): there at most 1% of all pixels may differ by
    more than 1e-3.  Zero and non-zero pixels are identical."""
    loader = TLoader(TCfg(lidar_height=32, lidar_width=256, num_frames=2,
                          num_walls=40, num_pillars=25, seed=seed))
    cloud = torch.from_numpy(loader.sequences()[0][0][0][1]["numpy_pc"])
    idx, hit = tam.rasterize_encoded(cloud, loader.projector(),
                                     torch.ones(cloud.shape[0], dtype=torch.bool))
    vmap = tam._gather_image(cloud, idx, hit, 32, 256)
    with jax.enable_x64(False):
        nj = np.asarray(jax.jit(jgeo.compute_normal_map_centered, static_argnums=1)(
            jnp.asarray(vmap.numpy()), 5))
    nt = tgeo.compute_normal_map_centered(vmap, 5).numpy()
    assert np.array_equal(np.abs(nt).max(-1) > 0, np.abs(nj).max(-1) > 0)
    # the relative eigenvalue gap of each pixel's window covariance (float64)
    vp = np.pad(vmap.numpy().astype(np.float64), ((2, 2), (2, 2), (0, 0)))
    win = np.stack([vp[r:r + 32, c:c + 256] for r in range(5) for c in range(5)], axis=2)
    ok = np.linalg.norm(win, axis=-1) > 0
    mean = (win * ok[..., None]).sum(2) / np.maximum(ok.sum(2), 1)[..., None]
    u = (win - mean[:, :, None]) * ok[..., None]
    ev = np.linalg.eigvalsh(np.einsum("hwki,hwkj->hwij", u, u))
    gap = (ev[..., 1] - ev[..., 0]) / np.maximum(ev[..., 2], 1e-30)
    valid = np.abs(nj).max(-1) > 0
    well = valid & (gap > 0.03)
    assert well.sum() > 0.8 * valid.sum()
    diff = np.abs(nt - nj).max(-1)
    print(f"\nseed {seed}: {well.sum()} of {valid.sum()} pixels well conditioned, max "
          f"{diff[well].max():.2e} there; {int((diff > 1e-5).sum())} pixels > 1e-5, "
          f"{int((diff > 1e-3).sum())} > 1e-3 overall")
    assert diff[well].max() <= 1e-5
    assert (diff > 1e-3).sum() <= 0.01 * valid.sum()


@pytest.mark.parametrize("reflect", [False, True])
def test_weighted_procrustes_vs_jax(reflect):
    """Weighted Kabsch fit of 500 noisy correspondences to <= 1e-5; with
    the target mirrored (det H < 0) the sign flip keeps a proper rotation."""
    rng = np.random.default_rng(3)
    ref = (rng.normal(size=(2, 500, 3)) * [5.0, 3.0, 1.0]).astype(np.float32)
    rot = trot.euler_to_mat(_t(np.float32([[0.1, -0.2, 0.7], [2.0, 0.3, -1.0]]))).numpy()
    tgt = np.einsum("bnj,bjk->bnk", ref - [1.0, 2.0, 3.0], rot)
    tgt = (tgt + rng.normal(size=tgt.shape) * 0.01).astype(np.float32)
    if reflect:
        tgt[..., 2] *= -1.0
    wts = rng.random((2, 500)).astype(np.float32)
    with jax.enable_x64(False):
        mj = np.asarray(jreg.weighted_procrustes(jnp.asarray(ref), jnp.asarray(tgt),
                                                 jnp.asarray(wts)))
        uj = np.asarray(jreg.weighted_procrustes(jnp.asarray(ref), jnp.asarray(tgt)))
    mt = treg.weighted_procrustes(_t(ref), _t(tgt), _t(wts)).numpy()
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(treg.weighted_procrustes(_t(ref), _t(tgt)).numpy(), uj,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(mt[:, :3, :3]), 1.0, atol=1e-5)


def test_point_to_point_residuals_and_jacobian_vs_jax():
    """Residuals and Jacobian at zero and non-zero params, masked rows and
    a zero-distance row: identical on zero params (exact), <= 1e-6 of
    their scale otherwise (the pose matrix's trig rounds per framework)."""
    rng = np.random.default_rng(4)
    tp = (rng.normal(size=(4000, 3)) * 8).astype(np.float32)
    ref = (tp + rng.normal(size=tp.shape) * 0.05).astype(np.float32)
    ref[7] = tp[7]
    mask = rng.random(4000) > 0.2
    for params, atol in [(np.zeros(6, np.float32), 0.0),
                         (np.float32([0.1, -0.2, 0.05, 0.01, -0.02, 0.03]), 1e-6 * 8)]:
        with jax.enable_x64(False):
            rj = np.asarray(jopt.point_to_point_residuals(*map(jnp.asarray, (params, tp, ref, mask))))
            jj = np.asarray(jopt.point_to_point_jacobian(*map(jnp.asarray, (params, tp, ref, mask))))
        rt = topt.point_to_point_residuals(*map(_t, (params, tp, ref, mask))).numpy()
        jt = topt.point_to_point_jacobian(*map(_t, (params, tp, ref, mask))).numpy()
        np.testing.assert_allclose(rt, rj, rtol=0, atol=atol)
        np.testing.assert_allclose(jt, jj, rtol=0, atol=atol)
        assert np.all(rt[~mask] == 0) and np.all(jt[~mask] == 0)
        if atol == 0.0:
            assert rt[7] == 0.0


def test_gn_prior_terms_solve_exactly():
    """With no data residuals the priors are the solve: dx == -d (the JAX
    package's test_gn_prior_terms_solve_exactly case), <= 1e-6."""
    d = np.float32([0.1, -0.2, 0.3, 0.01, -0.02, 0.03])
    pw = np.full(6, 5.0, np.float32)
    dx, _, singular = topt.gauss_newton_step(torch.zeros(8), torch.zeros(8, 6),
                                             torch.zeros(8), prior_res=_t(d),
                                             prior_weight=_t(pw))
    assert not bool(singular)
    np.testing.assert_allclose(dx.numpy(), -d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("damping", [0.0, 0.1])
def test_gauss_newton_step_with_priors_vs_jax(damping):
    """A weighted system plus priors (and Levenberg damping after them, in
    JAX's order): dx to <= 1e-6, the loss to 1e-6 relative; the B1 path's
    solve_normal_equations with the same priors gives the same dx."""
    rng = np.random.default_rng(5)
    res = rng.normal(size=3000).astype(np.float32) * 0.1
    jac = rng.normal(size=(3000, 6)).astype(np.float32)
    w = rng.random(3000).astype(np.float32)
    d = (rng.normal(size=6) * 0.05).astype(np.float32)
    pw = (rng.random(6) * 300).astype(np.float32)
    with jax.enable_x64(False):
        dj, lj, sj = jopt.gauss_newton_step(*map(jnp.asarray, (res, jac, w)), damping=damping,
                                            prior_res=jnp.asarray(d), prior_weight=jnp.asarray(pw))
    dt, lt, st = topt.gauss_newton_step(*map(_t, (res, jac, w)), damping=damping,
                                        prior_res=_t(d), prior_weight=_t(pw))
    assert bool(st) == bool(sj) is False
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    if damping == 0.0:
        wj = _t(jac) * _t(w)[:, None]
        h = wj.T @ wj
        g = wj.T @ (_t(res) * _t(w))
        ds, _ = topt.solve_normal_equations(h, g, prior_res=_t(d), prior_weight=_t(pw))
        np.testing.assert_allclose(ds.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


def _rot_z(a):
    m = np.eye(4)
    m[0, 0] = m[1, 1] = np.cos(a)
    m[0, 1] = -np.sin(a)
    m[1, 0] = np.sin(a)
    return m


def test_ct_pose_surface_vs_jax():
    """_pose_fraction_f64 and _ct_relative_poses on a random float64 chain
    (and the identity, and an angle under 1e-12) to <= 1e-12."""
    rng = np.random.default_rng(6)
    rel = [np.eye(4)]
    for _ in range(12):
        m = _rot_z(rng.uniform(-0.1, 0.1))
        m[:3, :3] = m[:3, :3] @ trot.euler_to_mat(torch.tensor(
            [[rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), 0.0]],
            dtype=torch.float64))[0].numpy()
        m[:3, 3] = rng.uniform(-0.3, 1.2, 3)
        rel.append(m)
    rel.append(np.eye(4))
    rel = np.stack(rel)
    for frac in (0.0, 0.3, 0.5, 1.0):
        for m in rel:
            np.testing.assert_allclose(ticp._pose_fraction_f64(m, frac),
                                       jicp._pose_fraction_f64(m, frac), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ticp._ct_relative_poses(rel, frac),
                                   jicp._ct_relative_poses(rel, frac), rtol=0, atol=1e-12)


def test_get_ct_relative_poses_surfaces():
    """The port's odometry reports begin / mid / end surfaces from its
    float64 ledger: begin_pose is the raw params ledger (<= 1e-12, JAX
    tests/test_ct_poses.py:113-146), mid and end are _ct_relative_poses of
    it, and get_relative_poses follows pose_type in elastic mode."""
    cfg = tacc.profile_configs()["ct_icp"]
    odom = ticp.ICPFrameToModel(cfg, projector=TLoader(TCfg(lidar_height=16, lidar_width=128))
                                .projector(), device="cpu")
    rng = np.random.default_rng(7)
    params = (rng.normal(size=(6, 6)) * [0.5, 0.5, 0.05, 0.01, 0.01, 0.05]).astype(np.float32)
    odom._params_log = [torch.zeros((1, 6)), torch.from_numpy(params)]
    raw = np.stack([ticp._pose_matrix_f64(p) for p in odom.fetch_params_log()])
    np.testing.assert_allclose(odom.get_ct_relative_poses("begin_pose"), raw, rtol=0, atol=1e-12)
    for name, frac in [("mid_pose", 0.5), ("end_pose", 1.0)]:
        np.testing.assert_allclose(odom.get_ct_relative_poses(name),
                                   jicp._ct_relative_poses(raw, frac), rtol=0, atol=1e-12)
    np.testing.assert_allclose(odom.get_relative_poses(), odom.get_ct_relative_poses(),
                               rtol=0, atol=0)
    assert not np.allclose(odom.get_relative_poses(), raw, atol=1e-6)


def test_rolling_shutter_frames_identical():
    """The rolling-shutter sequence (skew, turn rate 0.08) at 16x128, the
    first frames: clouds and ground truth identical to the JAX package's."""
    kw = dict(tacc.ROLLING_SHUTTER_KW, lidar_height=16, lidar_width=128, num_frames=4)
    tl, jl = TLoader(TCfg(**kw)), JLoader(JCfg(**kw))
    ts, js = tl.sequences()[0][0][0], jl.sequences()[0][0][0]
    for i in range(4):
        a, b = ts[i], js[i]
        assert np.array_equal(a["numpy_pc"], np.asarray(b["numpy_pc"]))
        assert np.array_equal(a["absolute_pose_gt"], np.asarray(b["absolute_pose_gt"]))
    assert np.array_equal(tl.get_ground_truth("synth_00"), jl.get_ground_truth("synth_00"))
