"""The port's PoseNet losses against the JAX package's, on the CPU, with
seeded numpy inputs and the JAX side in float32 (``jax.enable_x64(False)``).

Tolerances: the value to 1e-4 relative, the gradient with respect to the
pose parameters (and exp_s) to 1e-4 of its norm.  The unsupervised loss is
taken at poses that move no point near a pixel's rounding edge, and with
the JAX package's normals (the normal map is ill-conditioned on a few
pixels, where the JAX package's own jitted and op-by-op maps differ); the
two normal maps agree to 1e-4 on 98% of the pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.training import loss_modules as jloss

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.training import loss_modules as tloss

LOSS_TOL = 1e-4


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------

PROJ = (32, 128, 3.0, -24.0)


def _vertex_maps(seed=0):
    """(B, 2, 3, H, W) stacked vertex maps of a smooth scene (two planes
    seen from a moving sensor), rasterized by the JAX package."""
    from pylidar_slam_tpu_torch.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
    loader = SyntheticDatasetLoader(SyntheticConfig(lidar_height=PROJ[0], lidar_width=PROJ[1],
                                                    num_frames=4, seed=seed))
    ds = loader.sequences()[0][0][0]
    clouds = [np.asarray(ds[i]["numpy_pc"], np.float32) for i in range(4)]
    proj = jproj.SphericalProjection(*PROJ)
    with jax.enable_x64(False):
        vms = [np.asarray(jproj.build_vertex_map(jnp.asarray(c), proj)) for c in clouds]
    vms = np.stack(vms).transpose(0, 3, 1, 2)  # (4, 3, H, W)
    return np.stack([vms[[0, 1]], vms[[1, 2]], vms[[2, 3]]])  # (3, 2, 3, H, W)


def _edge_free_pose(vmaps, seed):
    """Small random poses under which no target point lands within 1e-4 px
    of a rounding edge (about ten float32 ulps of a column: there one ulp of
    atan2 or asin may decide the pixel)."""
    from pylidar_slam_tpu_torch.ops import se3
    rng = np.random.default_rng(seed)
    proj = tproj.SphericalProjection(*PROJ)
    pts = torch.from_numpy(vmaps[:, 1].transpose(0, 2, 3, 1).reshape(len(vmaps), -1, 3)).double()
    for _ in range(1000):
        params = np.concatenate([rng.uniform(-0.3, 0.3, (len(vmaps), 3)),
                                 rng.uniform(-0.01, 0.01, (len(vmaps), 3))], axis=1)
        moved = se3.apply_transformation(pts, se3.build_pose_matrix(torch.from_numpy(params)))
        rows, cols, r = proj.project(moved)
        hit = np.tile(r.numpy().ravel() > 0, 2)
        frac = np.concatenate([rows.numpy().ravel(), cols.numpy().ravel()])[hit] % 1.0
        if np.abs(frac - 0.5).min() > 1e-4:
            return params.astype(np.float32)
    raise AssertionError("no edge-free pose in 1000 draws")


@pytest.mark.parametrize("scheme", ["geman_mcclure", "least_square", "cauchy"])
def test_point_to_plane_loss_matches_jax(scheme, monkeypatch):
    vmaps = _vertex_maps()
    params = _edge_free_pose(vmaps, seed=len(scheme))
    proj_j = jproj.SphericalProjection(*PROJ)
    # The reference's normal map is ill-conditioned on a few pixels: the
    # JAX package's own jitted and op-by-op normal maps differ by up to 1.9
    # there, and move its loss by 2e-3.  The two maps must agree to 1e-4 on 98% of
    # the pixels; then the port's loss takes the JAX normals, so that the
    # rest of the loss (transform, raster, residuals, robust cost, gradient)
    # is held to 1e-4.
    ref_vm = vmaps[:, 0].transpose(0, 2, 3, 1)
    with jax.enable_x64(False):
        normals = np.asarray(jax.vmap(lambda v: jgeo.compute_normal_map(v, 5))(
            jnp.asarray(ref_vm)))
    ours_n = tgeo.compute_normal_map(torch.from_numpy(ref_vm), 5).numpy()
    assert (np.abs(ours_n - normals).max(axis=-1) <= 1e-4).mean() >= 0.98
    monkeypatch.setattr(tloss.geometry, "compute_normal_map",
                        lambda vm, kernel_size: torch.from_numpy(normals))
    with jax.enable_x64(False):
        def f(p):
            return jloss.point_to_plane_loss(jnp.asarray(vmaps), p, proj_j, scheme=scheme,
                                             sigma=0.5)[0]
        ref, ref_grad = jax.value_and_grad(f)(jnp.asarray(params))
    p = torch.from_numpy(params).requires_grad_(True)
    ours, logs = tloss.point_to_plane_loss(torch.from_numpy(vmaps), p,
                                           tproj.SphericalProjection(*PROJ), scheme=scheme,
                                           sigma=0.5)
    ours.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_TOL)
    assert logs["loss_icp"] is ours
    ref_grad = np.asarray(ref_grad)
    assert np.linalg.norm(ref_grad) > 0
    err = np.linalg.norm(p.grad.numpy() - ref_grad) / np.linalg.norm(ref_grad)
    assert err <= LOSS_TOL, f"gradient error {err:.3e} of its norm"


def _relative_gt(rng, b):
    from pylidar_slam_tpu_torch.ops.rotation import np_euler_to_mat
    gt = np.tile(np.eye(4), (b, 1, 1))
    gt[:, :3, :3] = np_euler_to_mat(rng.uniform(-0.1, 0.1, (b, 3)))
    gt[:, :3, 3] = rng.uniform(-2, 2, (b, 3))
    return gt.astype(np.float32)


@pytest.mark.parametrize("exp_weights", [False, True], ids=["fixed", "exp"])
@pytest.mark.parametrize("degrees", [True, False], ids=["deg", "rad"])
@pytest.mark.parametrize("option", ["l2", "l1"])
def test_supervised_loss_matches_jax(option, degrees, exp_weights):
    rng = np.random.default_rng(hash((option, degrees, exp_weights)) % 1000)
    b = 4
    gt = _relative_gt(rng, b)
    params = np.concatenate([rng.uniform(-2, 2, (b, 3)), rng.uniform(-0.1, 0.1, (b, 3))],
                            axis=1).astype(np.float32)
    exp_s = np.array([-3.0, -2.5], np.float32)
    kw = dict(loss_option=option, loss_degrees=degrees, with_exp_weights=exp_weights,
              loss_weights=[1.0, 2.0])
    jcfg, tcfg = jloss.SupervisedLossConfig(**kw), tloss.SupervisedLossConfig(**kw)
    with jax.enable_x64(False):
        def f(p, s):
            return jloss.supervised_loss(p, jnp.asarray(gt), jcfg, exp_s=s)
        (ref, ref_logs), (g_p, g_s) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(params), jnp.asarray(exp_s))
    p = torch.from_numpy(params).requires_grad_(True)
    s = torch.from_numpy(exp_s).requires_grad_(True)
    ours, logs = tloss.supervised_loss(p, torch.from_numpy(gt), tcfg, exp_s=s)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_TOL)
    assert set(logs) == set(ref_logs)
    for key in logs:
        np.testing.assert_allclose(logs[key].item(), float(ref_logs[key]), rtol=LOSS_TOL,
                                   atol=1e-7)
    for ours_g, ref_g in ((p.grad, g_p), (s.grad, g_s)):
        ref_g = np.asarray(ref_g)
        if not exp_weights and ref_g.shape == (2,):
            assert ours_g is None and not ref_g.any()
            continue
        err = np.linalg.norm(ours_g.numpy() - ref_g) / np.linalg.norm(ref_g)
        assert err <= LOSS_TOL, f"gradient error {err:.3e} of its norm"
