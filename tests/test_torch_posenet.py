"""The port's PoseResNet and its weight carrier against the JAX package's,
on the CPU, with seeded numpy inputs and the JAX side in float32
(``jax.enable_x64(False)``).  The losses are in
test_torch_posenet_losses.py.

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
  the heads' uniform limit within 1% of sqrt(3e-4 / fan_avg); biases 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.models.posenet import PoseResNet as JPoseResNet
from pylidar_slam_tpu.models.posenet import PoseResNetConfig as JConfig

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch.models.from_jax import load_jax_variables
from pylidar_slam_tpu_torch.models.posenet import PoseResNet, PoseResNetConfig

H, W = 16, 64
FWD_TOL = 1e-4

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
