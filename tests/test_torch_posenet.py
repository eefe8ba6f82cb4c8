"""The port's PoseResNet, its weight carrier and its losses against the JAX
package's, on the CPU, with seeded numpy inputs and the JAX side in float32
(``jax.enable_x64(False)``).

Tolerances:
- forward (depths 18, 34 and 50, eval and train mode, 16x64, batch 2):
  1e-4 of the output's largest magnitude; after a train-mode pass, every
  BatchNorm's running mean and variance to 1e-4 of its largest magnitude
  (flax moves them with the BIASED batch variance, torch's BatchNorm2d
  with the unbiased one: at the last stage's 4 pixels per channel that is
  a factor of 4/3, which this catches);
- initialisation: moments over the largest layers, not values (the two
  frameworks draw from different generators): conv weights' std within 2%
  of 1/sqrt(fan_in) and none beyond two of the truncated normal's scale;
  the heads' uniform limit within 1% of sqrt(3e-4 / fan_avg); biases 0;
- losses: the value to 1e-4 relative, the gradient with respect to the pose
  parameters (and exp_s) to 1e-4 of its norm.  The unsupervised loss is
  taken at poses that move no point near a pixel's rounding edge, and
  with the JAX package's normals (the normal map is ill-conditioned on a
  few pixels, where the JAX package's own jitted and op-by-op maps
  differ); the two normal maps agree to 1e-4 on 98% of the pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.models.posenet import PoseResNet as JPoseResNet
from pylidar_slam_tpu.models.posenet import PoseResNetConfig as JConfig
from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.training import loss_modules as jloss

from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig
from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.training import loss_modules as tloss

H, W = 16, 64
FWD_TOL = 1e-4
LOSS_TOL = 1e-4

_INIT = {}


def _init_variables(depth):
    """The JAX module and its initial variables, as numpy trees."""
    if depth not in _INIT:
        module = JPoseResNet(JConfig(resnet_model=depth))
        with jax.enable_x64(False):
            v = module.init(jax.random.PRNGKey(depth), jnp.zeros((1, 2, 3, H, W), jnp.float32),
                            train=False)
        _INIT[depth] = (module, jax.tree_util.tree_map(np.asarray, v))
    return _INIT[depth]


def _jax_variables(depth):
    """The initial variables with every 1-D leaf (the BatchNorm affine and
    statistics, the translation head's bias) moved off its 1/0 start, so
    the carrier's mapping of each of them is exercised."""
    module, v = _init_variables(depth)
    rng = np.random.default_rng(depth)
    v = jax.tree_util.tree_map(
        lambda a: a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32) if a.ndim == 1 else a, v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return module, v


def _ported(depth):
    module, v = _jax_variables(depth)
    net = PoseResNet(PoseResNetConfig(resnet_model=depth))
    load_jax_variables(net, v["params"], v["batch_stats"])
    return module, v, net


def _frames(seed=0, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 2, 3, H, W)).astype(np.float32) * 10.0
    x[rng.uniform(size=x.shape) < 0.1] = 0.0  # empty pixels
    return x


def _bn_layers(net):
    """The port's BatchNorms in the flax tree's order: (block index, j)."""
    out = []
    for bi, block in enumerate(net.encoder.blocks):
        norms = [block.bn1, block.bn2] + ([block.bn3] if hasattr(block, "bn3") else [])
        out.extend((bi, j, bn) for j, bn in enumerate(norms))
    return out


def _close(ours, ref, tol, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(ours - ref).max() / scale
    assert err <= tol, f"{what}: max error {err:.3e} of the scale {scale:.3e} > {tol}"


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("depth", [18, 34, 50])
def test_forward_matches_jax(depth, train):
    module, v, net = _ported(depth)
    x = _frames(depth)
    net.train(train)
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    with jax.enable_x64(False):
        if train:
            ref, mutated = module.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            ref = module.apply(v, jnp.asarray(x), train=False)
    assert ours.shape == (2, 1, 6)
    _close(ours, ref, FWD_TOL, f"PoseResNet-{depth} {'train' if train else 'eval'} output")
    if not train:
        return
    name = "BasicBlock" if depth < 50 else "Bottleneck"
    stats = mutated["batch_stats"]["ResNetEncoder_0"]
    for bi, j, bn in _bn_layers(net):
        ref_bn = stats[f"{name}_{bi}"][f"BatchNorm_{j}"]
        _close(bn.running_mean.numpy(), ref_bn["mean"], FWD_TOL, f"{name}_{bi} BN_{j} mean")
        _close(bn.running_var.numpy(), ref_bn["var"], FWD_TOL, f"{name}_{bi} BN_{j} var")


def test_carrier_orders_blocks_by_integer_suffix():
    """Depth 50 has Bottleneck_10..15, which sort as strings before
    Bottleneck_2: each port block must hold its own flax block's weights."""
    _, v, net = _ported(50)
    tree = v["params"]["ResNetEncoder_0"]
    for bi in (2, 10, 15):
        kernel = np.asarray(tree[f"Bottleneck_{bi}"]["Conv_0"]["kernel"])
        np.testing.assert_array_equal(net.encoder.blocks[bi].conv1.weight.detach().numpy(),
                                      kernel.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        load_jax_variables(PoseResNet(PoseResNetConfig(resnet_model=34)), v["params"],
                           v["batch_stats"])


def test_initialisation_matches_flax_distributions():
    _, v = _init_variables(18)
    net = PoseResNet(PoseResNetConfig(resnet_model=18), generator=torch.Generator().manual_seed(3))
    params = v["params"]
    enc = params["ResNetEncoder_0"]
    # a 3x3x512x512 conv (2.4 M weights) and the 7x7x6x64 stem
    pairs = [(net.encoder.blocks[7].conv2.weight, enc["BasicBlock_7"]["Conv_1"]["kernel"]),
             (net.encoder.stem.weight, enc["Conv_0"]["kernel"])]
    for ours, ref in pairs:
        target = 1.0 / np.sqrt(ours.shape[1] * ours.shape[2] * ours.shape[3])  # 1/sqrt(fan_in)
        ours = ours.detach().numpy().ravel()
        ref = np.asarray(ref).ravel()
        for w in (ours, ref):
            assert abs(w.std() / target - 1.0) < 0.02
            assert abs(w.mean()) < 0.02 * target
            assert np.abs(w).max() <= 2.0 * target / 0.87962566103423978 + 1e-7
        assert abs(ours.std() / ref.std() - 1.0) < 0.02
    for head in ("fc_rot", "fc_trans"):
        ours = getattr(net, head).weight.detach().numpy()
        ref = np.asarray(params[head]["kernel"])
        limit = np.sqrt(3e-4 / (0.5 * (512 + 3)))
        for w in (ours, ref):
            assert abs(np.abs(w).max() / limit - 1.0) < 0.01
            assert abs(w.std() / (limit / np.sqrt(3.0)) - 1.0) < 0.1
    assert net.fc_rot.bias is None and "bias" not in params["fc_rot"]
    assert float(net.fc_trans.bias.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(np.asarray(params["fc_trans"]["bias"]), 0.0)
    for _, _, bn in _bn_layers(net):
        assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and not bn.bias.any()


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
