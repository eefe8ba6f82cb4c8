"""PyTorch port vs the JAX package: the ops under the aggregated slice.

Inputs are numpy arrays made from a seed (or the recorded reference
fixture) and fed to both implementations; JAX runs on the CPU in float32.
Tolerances: the same bars as tests/test_reference_parity.py where the port
is held against the reference fixture; against JAX, a few float32 ulps
(the two frameworks' sin/cos/atan2/sqrt differ by up to an ulp on the CPU)
unless the op is exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

from pylidar_slam_tpu.ops import bev as jbev
from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import optimization as jopt
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.ops import rotation as jrot
from pylidar_slam_tpu.ops import se3 as jse3
from pylidar_slam_tpu.eval import eval_odometry as jev

from pylidar_slam_tpu_torch.ops import bev as tbev
from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import optimization as topt
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.ops import rotation as trot
from pylidar_slam_tpu_torch.ops import se3 as tse3
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu.dataset.synthetic import (
    SyntheticConfig as JCfg, SyntheticDatasetLoader as JLoader)

FIXTURE = Path(__file__).parent / "fixtures" / "reference_parity.npz"
SEQ = dict(lidar_height=32, lidar_width=256, num_frames=3, num_walls=40,
           num_pillars=25)


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def scans():
    """Frames 0-1 of a 32x256 synthetic sequence, from both loaders."""
    t = TLoader(TCfg(**SEQ)).sequences()[0][0][0]
    j = JLoader(JCfg(**SEQ)).sequences()[0][0][0]
    return [t[i]["numpy_pc"] for i in range(2)], [j[i]["numpy_pc"] for i in range(2)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_synthetic_frames_identical(scans):
    tframes, jframes = scans
    for a, b in zip(tframes, jframes):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tl, jl = TLoader(TCfg(**SEQ)), JLoader(JCfg(**SEQ))
    assert np.array_equal(tl.get_ground_truth("synth_00"),
                          jl.get_ground_truth("synth_00"))
    assert tuple(tl.projector()) == tuple(jl.projector())


# ----------------------------------------------------------------------------
# se3 / rotation (exact: the same float32 operations in the same order)
# ----------------------------------------------------------------------------

def test_pose_matrix_and_jacobian_vs_fixture(fx):
    params = torch.as_tensor(fx["pose_params"])
    np.testing.assert_allclose(_np(tse3.build_pose_matrix(params)),
                               fx["pose_matrices"], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(_np(trot.pose_matrix_jacobian(params)),
                               fx["pose_jacobian"], rtol=1e-6, atol=1e-10)


def test_se3_vs_jax():
    rng = np.random.default_rng(0)
    params = (rng.normal(size=(5, 6)) * [1, 1, 0.2, 0.1, 0.1, 0.5]).astype(np.float32)
    pts = (rng.normal(size=(5, 200, 3)) * 20).astype(np.float32)
    with jax.enable_x64(False):
        jm = jse3.build_pose_matrix(jnp.asarray(params))
        ref = {
            "build": jm,
            "from": jse3.from_pose_matrix(jm),
            "inverse": jse3.inverse_pose_matrix(jm),
            "normalize": jse3.normalize_pose_matrix(jm),
            "apply": jse3.apply_transformation(jnp.asarray(pts), jm),
            "rotate": jse3.apply_rotation(jnp.asarray(pts), jm),
            "motion": jse3.pose_motion_magnitude(jm[1]),
            "euler": jrot.mat_to_euler(jm[:, :3, :3]),
            "jac": jrot.pose_matrix_jacobian(jnp.asarray(params)),
        }
    tm = tse3.build_pose_matrix(_t(params))
    ours = {
        "build": tm,
        "from": tse3.from_pose_matrix(tm),
        "inverse": tse3.inverse_pose_matrix(tm),
        "normalize": tse3.normalize_pose_matrix(tm),
        "apply": tse3.apply_transformation(_t(pts), tm),
        "rotate": tse3.apply_rotation(_t(pts), tm),
        "motion": tse3.pose_motion_magnitude(tm[1]),
        "euler": trot.mat_to_euler(tm[:, :3, :3]),
        "jac": trot.pose_matrix_jacobian(_t(params)),
    }
    for k in ref:
        # cos/sin/atan2 differ by <= 1 ulp between the frameworks
        np.testing.assert_allclose(_np(ours[k]), np.asarray(ref[k]),
                                   rtol=2e-6, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(trot.np_euler_to_mat(params[:, 3:]),
                               jrot.np_euler_to_mat(params[:, 3:]), rtol=0, atol=0)


def test_poses_interpolator_vs_jax():
    rng = np.random.default_rng(1)
    with jax.enable_x64(False):
        poses = np.asarray(jse3.build_pose_matrix(jnp.asarray(
            rng.normal(size=(4, 6)).astype(np.float32) * 0.3)), np.float64)
    ts = np.array([0.0, 1.0, 2.5, 4.0])
    q = np.linspace(-0.5, 4.5, 23)
    np.testing.assert_array_equal(tse3.PosesInterpolator(poses, ts)(q),
                                  jse3.PosesInterpolator(poses, ts)(q))


# ----------------------------------------------------------------------------
# optimization
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["huber", "geman_mcclure", "cauchy", "neighborhood"])
def test_robust_weights_vs_fixture(fx, scheme):
    res = torch.as_tensor(fx["scheme_residuals"])
    if scheme == "neighborhood":
        sq_d = np.sum((fx["scheme_nb_target"] - fx["scheme_nb_reference"]) ** 2, axis=-1)
        ours = topt.robust_weights(scheme, res, 0.2, sq_dists=torch.as_tensor(sq_d))
    else:
        ours = topt.robust_weights(scheme, res, 0.3)
    np.testing.assert_allclose(_np(ours), fx[f"scheme_weights_{scheme}"],
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("scheme", topt.SCHEMES)
def test_robust_cost_and_weights_vs_jax(scheme):
    rng = np.random.default_rng(2)
    res = (rng.normal(size=4096) * 0.3).astype(np.float32)
    res[:8] = [0.0, 1e-5, -5e-5, 1e-4, -2e-4, 0.4, -0.4, 2.0]
    sq_d = (rng.random(4096) * 0.36).astype(np.float32)
    with jax.enable_x64(False):
        jc = jopt.robust_cost(scheme, jnp.asarray(res), 0.4, jnp.asarray(sq_d))
        jw = jopt.robust_weights(scheme, jnp.asarray(res), 0.4, jnp.asarray(sq_d))
    tc = topt.robust_cost(scheme, _t(res), 0.4, _t(sq_d))
    tw = topt.robust_weights(scheme, _t(res), 0.4, _t(sq_d))
    # exp/log/sqrt and fused products round differently between the
    # frameworks: a few float32 ulps (1 ulp ~ 1.2e-7 relative)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-6, atol=1e-12)


def test_gauss_newton_step_vs_fixture_and_jax(fx):
    tgt, ref, nrm = (torch.as_tensor(fx[k]) for k in
                     ("gn_target_points", "gn_ref_points", "gn_ref_normals"))
    zero = torch.zeros(6, dtype=tgt.dtype)
    res = topt.point_to_plane_residuals(zero, tgt, ref, nrm)
    jac = topt.point_to_plane_jacobian(zero, tgt, nrm)
    dx, _, singular = topt.gauss_newton_step(res, jac, torch.ones_like(res))
    assert not bool(singular)
    np.testing.assert_allclose(_np(dx), fx["gn_dx"], rtol=1e-5, atol=1e-8)

    # float32 against JAX, with a masked + weighted system
    rng = np.random.default_rng(3)
    t32, r32, n32 = (fx[k].astype(np.float32) for k in
                     ("gn_target_points", "gn_ref_points", "gn_ref_normals"))
    mask = rng.random(t32.shape[0]) < 0.8
    wts = rng.random(t32.shape[0]).astype(np.float32)
    with jax.enable_x64(False):
        z = jnp.zeros(6, jnp.float32)
        jres = jopt.point_to_plane_residuals(z, *map(jnp.asarray, (t32, r32, n32, mask)))
        jjac = jopt.point_to_plane_jacobian(z, *map(jnp.asarray, (t32, n32, mask)))
        jdx, jloss, jsing = jopt.gauss_newton_step(jres, jjac, jnp.asarray(wts))
    z = torch.zeros(6)
    tres = topt.point_to_plane_residuals(z, *map(_t, (t32, r32, n32, mask)))
    tjac = topt.point_to_plane_jacobian(z, *map(_t, (t32, n32, mask)))
    np.testing.assert_allclose(_np(tres), np.asarray(jres), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tjac), np.asarray(jjac), rtol=1e-6, atol=1e-6)
    tdx, tloss, tsing = topt.gauss_newton_step(tres, tjac, _t(wts))
    assert bool(tsing) == bool(jsing) is False
    # a 6x6 float32 solve: LU (JAX) vs Cholesky here
    np.testing.assert_allclose(_np(tdx), np.asarray(jdx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_singular_normal_equations_give_zero_step():
    h = torch.zeros(6, 6)
    h[:3, :3] = torch.eye(3)  # rank 3: det == 0
    dx, singular = topt.solve_normal_equations(h, torch.ones(6))
    assert bool(singular) and torch.equal(dx, torch.zeros(6))
    dx, singular = topt.solve_normal_equations(torch.eye(6) * 2.0, torch.ones(6))
    assert not bool(singular)
    np.testing.assert_allclose(_np(dx), -0.5 * np.ones(6))


# ----------------------------------------------------------------------------
# projection + rimg8 codec
# ----------------------------------------------------------------------------

def test_project_vs_fixture_and_jax(fx):
    h, w, up, down = fx["proj_params"]
    jp = jproj.SphericalProjection(int(h), int(w), float(up), float(down))
    tp = tproj.SphericalProjection(int(h), int(w), float(up), float(down))
    pc = fx["pointcloud"].astype(np.float32)
    with jax.enable_x64(False):
        ref = jp.project(jnp.asarray(pc))
    ours = tp.project(_t(pc))
    for a, b in zip(ours, ref):
        # atan2/asin differ by <= 1 ulp; the pixel scale is ~163 px/rad
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=5e-5)


def test_rimg8_bytes_and_decode_vs_jax(scans):
    tframes, _ = scans
    proj = (32, 256, 3.0, -24.0)
    jp, tp = jproj.SphericalProjection(*proj), tproj.SphericalProjection(*proj)
    for pts in tframes:
        tbuf = tproj.np_encode_range_image(pts, tp)
        jbuf = jproj.np_encode_range_image(pts, jp, planes=True)
        assert tbuf.dtype == np.uint8 and np.array_equal(tbuf, jbuf)
        padded = np.zeros((tbuf.shape[0] + 100, 2), np.uint8)
        padded[:tbuf.shape[0]] = tbuf
        with jax.enable_x64(False):
            jpts, jvalid = jproj.decode_range_image(jnp.asarray(padded), jp)
        tpts, tvalid = tproj.decode_range_image(torch.from_numpy(padded), tp)
        assert np.array_equal(_np(tvalid), np.asarray(jvalid))
        # the same points, to the float32 rounding of cos/sin (<= 1 ulp) at
        # up to 70 m range
        np.testing.assert_allclose(_np(tpts), np.asarray(jpts), rtol=0, atol=2e-5)


def test_rimg8_numpy_fallback_matches_jax_fallback(scans, monkeypatch):
    from pylidar_slam_tpu.utils import native as jnative
    from pylidar_slam_tpu_torch.utils import native as tnative
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    proj = (32, 256, 3.0, -24.0)
    pts = scans[0][1]
    assert np.array_equal(
        tproj.np_encode_range_image(pts, tproj.SphericalProjection(*proj)),
        jproj.np_encode_range_image(pts, jproj.SphericalProjection(*proj), planes=True))


# ----------------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------------

def test_box_filter_exact_vs_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(16, 64, 9)) * 300).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jgeo.box_filter(jnp.asarray(x), 5))
    # same taps, same order: bit-identical
    assert np.array_equal(_np(tgeo.box_filter(_t(x), 5)), ref)


def test_inverse_3x3_vs_jax():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(500, 3, 3)).astype(np.float32)
    m[:5] = 0.0  # singular -> zero inverse
    with jax.enable_x64(False):
        jinv, jdet = jgeo.inverse_3x3(jnp.asarray(m))
    tinv, tdet = tgeo.inverse_3x3(_t(m))
    np.testing.assert_allclose(_np(tdet), np.asarray(jdet), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tinv), np.asarray(jinv), rtol=1e-4, atol=1e-4)
    assert np.all(_np(tinv)[:5] == 0)


def test_normal_map_vs_fixture(fx):
    ref_vmap = fx["vertex_map"].astype(np.float32)
    ours = _np(tgeo.compute_normal_map(_t(ref_vmap), 5))
    ref = fx["normal_map"]
    valid_ours = np.linalg.norm(ours, axis=-1) > 0.5
    valid_ref = np.linalg.norm(ref, axis=-1) > 0.5
    # the bars of test_reference_parity.py::test_normal_map_parity
    assert (valid_ours == valid_ref).all()
    valid = valid_ours & valid_ref
    assert valid.mean() > 0.5
    cos = np.abs(np.sum(ours * ref, axis=-1))[valid]
    assert np.median(cos) > 0.999
    assert np.quantile(cos, 0.1) > 0.98
    assert cos.mean() > 0.97


def test_normal_map_vs_jax(fx):
    vmap = fx["vertex_map"].astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jgeo.compute_normal_map(jnp.asarray(vmap), 5))
    ours = _np(tgeo.compute_normal_map(_t(vmap), 5))
    assert np.array_equal(np.linalg.norm(ours, axis=-1) > 0.5,
                          np.linalg.norm(ref, axis=-1) > 0.5)
    cos = np.abs(np.sum(ours * ref, axis=-1))[np.linalg.norm(ref, axis=-1) > 0.5]
    # identical window sums; the 3x3 solve rounds differently only where
    # the window covariance is near-singular (depth edges)
    assert np.median(cos) > 1 - 1e-6
    assert np.quantile(cos, 0.01) > 0.999


# ----------------------------------------------------------------------------
# BEV (EI bootstrap)
# ----------------------------------------------------------------------------

def test_ground_mask_and_elevation_image_vs_jax(scans):
    pts = scans[0][0]
    padded = np.zeros((pts.shape[0] + 1001, 3), np.float32)  # odd count too
    padded[:pts.shape[0]] = pts
    for cloud in (pts, padded, pts[:-1]):
        with jax.enable_x64(False):
            jm = jbev.ground_suppressed_mask(jnp.asarray(cloud))
            jimg = jbev.build_elevation_image(jnp.asarray(cloud), jm, 0.5, 128)
        tm = tbev.ground_suppressed_mask(_t(cloud))
        assert np.array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_array_equal(
            _np(tbev.build_elevation_image(_t(cloud), tm, 0.5, 128)),
            np.asarray(jimg))


def test_rotate_and_register_bev_vs_jax(scans):
    with jax.enable_x64(False):
        imgs = [np.asarray(jbev.build_elevation_image(
            jnp.asarray(p), jbev.ground_suppressed_mask(jnp.asarray(p)), 0.5, 128))
            for p in scans[1]]
        yaws = np.linspace(-1.0472, 1.0472, 64, endpoint=False).astype(np.float32)
        jrot_imgs = np.stack([np.asarray(jbev._rotate_image(jnp.asarray(imgs[1]), y))
                              for y in yaws[::9]])
        jres = jbev.register_bev(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                                 num_yaw_steps=64, yaw_range=1.0472)
        jmat = np.asarray(jbev.bev_transform_to_se3(jres, 0.5))
    trot_imgs = tbev._rotate_image(_t(imgs[1]), _t(yaws[::9]))
    # cos/sin of the yaw may differ by an ulp, moving sample coordinates by
    # ~1e-5 px on a (0, 1]-valued image
    np.testing.assert_allclose(_np(trot_imgs), jrot_imgs, rtol=0, atol=2e-5)
    tres = tbev.register_bev(_t(imgs[0]), _t(imgs[1]), num_yaw_steps=64,
                             yaw_range=1.0472)
    assert float(tres.yaw) == pytest.approx(float(jres.yaw), abs=1e-7)
    np.testing.assert_allclose(
        [float(tres.dy), float(tres.dx), float(tres.score)],
        [float(jres.dy), float(jres.dx), float(jres.score)], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tbev.bev_transform_to_se3(tres, 0.5)), jmat,
                               rtol=0, atol=1e-4)


# ----------------------------------------------------------------------------
# eval
# ----------------------------------------------------------------------------

def test_eval_metrics_vs_fixture(fx):
    pred, gt = fx["eval_pred_absolute"], fx["eval_gt_absolute"]
    tr_err, rot_err, _ = tev.compute_kitti_metrics(pred, gt)
    np.testing.assert_allclose(tr_err, float(fx["eval_tr_err"]), rtol=1e-10)
    np.testing.assert_allclose(rot_err, float(fx["eval_rot_err"]), rtol=1e-10)
    ate = tev.compute_ate(tev.compute_relative_poses(pred),
                          tev.compute_relative_poses(gt))
    np.testing.assert_allclose(ate, fx["eval_ate"], rtol=1e-10)
    assert tev.compute_kitti_metrics(pred, gt) [:2] == jev.compute_kitti_metrics(pred, gt)[:2]
    assert math.isclose(tev.compute_ate(pred, gt)[0], jev.compute_ate(pred, gt)[0],
                        rel_tol=0, abs_tol=0)


def test_point_to_plane_at_identity_vs_jax():
    """The surfel map's residuals and Jacobian at the zero pose delta against
    the JAX package's general composite at params = 0."""
    rng = np.random.default_rng(12)
    pts = (rng.normal(size=(500, 3)) * 20).astype(np.float32)
    ref = pts + rng.normal(size=(500, 3)).astype(np.float32) * 0.1
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.random(500) < 0.8
    zero = jnp.zeros(6, jnp.float32)
    with jax.enable_x64(False):
        jres = jopt.point_to_plane_residuals(zero, *map(jnp.asarray, (pts, ref, nrm, mask)))
        jjac = jopt.point_to_plane_jacobian(zero, *map(jnp.asarray, (pts, nrm, mask)))
    res, jac = topt.point_to_plane_at_identity(*map(_t, (pts, ref, nrm, mask)))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    # the cross product rounds once per term; the composite's einsum may fuse
    np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), rtol=0, atol=1e-5)
    assert np.all(jac.numpy()[~mask] == 0)
