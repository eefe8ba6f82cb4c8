"""ResNet encoder for pose regression (torch port of
``pylidar_slam_tpu.models.resnet``), in NCHW.

A 7x7 stride-2 stem WITHOUT normalization, a 3x3 max-pool, four stages of
BasicBlock / Bottleneck (BatchNorm inside the blocks, the downsample a bare
1x1 conv), depths {18, 34, 50}.

Two things follow the JAX package's flax modules rather than torch's
defaults, so that a seed draws the same distributions and a train-mode pass
leaves the same running statistics:

* ``BatchNorm2d`` normalizes with the biased batch variance taken as
  E[x^2] - E[x]^2 (clamped at 0) and moves its running mean and variance by
  ``ra = 0.9 ra + 0.1 batch`` with that same biased variance (torch's
  ``nn.BatchNorm2d`` keeps the unbiased one); under data parallelism the
  batch is the global batch, whose slices the ranks of its ``group`` hold;
* convolutions draw lecun-normal weights (a normal truncated at two
  standard deviations, variance 1 / fan_in), as ``flax.linen.Conv``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.nn.functional import all_reduce

ACTIVATIONS = {
    "relu": F.relu,
    # flax.linen.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sin": torch.sin,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}

# std of a unit normal truncated to [-2, 2]: dividing by it gives the
# truncated draw the variance asked for (jax.nn.initializers.variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def get_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise KeyError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default conv kernel init on an OIHW weight: a normal truncated
    at +-2 std, scaled to variance 1 / fan_in (fan_in = I * H * W)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    With a data-parallel process ``group`` set, each rank holds a slice of
    the batch, and the statistics are those of the whole batch: the sums of
    x and x^2 and the count are all-reduced over the group (autograd
    carries the all-reduce) before E[x^2] - E[x]^2, as the JAX package's
    jit over a sharded global batch computes them."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(channels))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group is not None:
            count = torch.full((1,), x.numel() / x.shape[1], dtype=x.dtype, device=x.device)
            sums = all_reduce(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                                         count]), group=self.group)
            c = x.shape[1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        elif self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if self.training:
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, activation: str = "relu"):
        super().__init__()
        self.act = get_activation(activation)
        self.conv1 = conv(in_ch, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes * self.expansion:
            self.downsample = conv(in_ch, planes * self.expansion, 1, stride)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, activation: str = "relu"):
        super().__init__()
        self.act = get_activation(activation)
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * self.expansion, 1)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.downsample = None
        if stride != 1 or in_ch != planes * self.expansion:
            self.downsample = conv(in_ch, planes * self.expansion, 1, stride)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


MODEL_TABLE = {
    18: ([2, 2, 2, 2], BasicBlock),
    34: ([3, 4, 6, 3], BasicBlock),
    50: ([3, 4, 6, 3], Bottleneck),
}


class ResNetEncoder(nn.Module):
    """Four-stage ResNet encoder over (B, C, H, W); returns the last
    stage's feature map.  ``blocks`` holds every block in order (the flax
    tree's ``BasicBlock_i`` / ``Bottleneck_i``)."""

    def __init__(self, in_ch: int, model: int = 18, activation: str = "relu"):
        super().__init__()
        if model not in MODEL_TABLE:
            raise KeyError(f"Unsupported resnet_model {model} "
                           f"(choose from {sorted(MODEL_TABLE)})")
        layers, block = MODEL_TABLE[model]
        self.act = get_activation(activation)
        self.stem = conv(in_ch, 64, 7, 2, 3)
        blocks, ch = [], 64
        for stage, (planes, count) in enumerate(zip((64, 128, 256, 512), layers)):
            for i in range(count):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(ch, planes, stride, activation))
                ch = planes * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = ch

    def forward(self, x):
        x = self.act(self.stem(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        return x
