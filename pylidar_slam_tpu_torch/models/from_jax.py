"""Carries the JAX package's PoseResNet weights into the port's module.

The flax trees are nested dicts of arrays (numpy, or anything ``np.asarray``
takes):

* ``params``: ``ResNetEncoder_0`` (the stem ``Conv_0``, then ``BasicBlock_i``
  or ``Bottleneck_i`` in network order, each with ``Conv_j`` / ``BatchNorm_j``
  and its bare downsample conv last), ``fc_rot`` (kernel) and ``fc_trans``
  (kernel, bias);
* ``batch_stats``: the same BatchNorm names, each with ``mean`` and ``var``.

Blocks are ordered by their integer suffix (sorted as strings,
``Bottleneck_10`` would come before ``Bottleneck_2``).  Conv kernels go from
HWIO to OIHW, dense kernels are transposed.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from pylidar_slam_tpu_torch.models.posenet import PoseResNet
from pylidar_slam_tpu_torch.models.resnet import BasicBlock


def _by_suffix(tree: Mapping, prefix: str) -> list:
    keys = [k for k in tree if re.fullmatch(rf"{prefix}_\d+", k)]
    return [tree[k] for k in sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))]


def _copy(dst: torch.Tensor, src, transpose=None):
    value = torch.from_numpy(np.array(src, dtype=np.float32))
    if transpose is not None:
        value = value.permute(*transpose)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(value)


def _conv(conv: torch.nn.Conv2d, tree: Mapping):
    _copy(conv.weight, tree["kernel"], (3, 2, 0, 1))  # HWIO -> OIHW


def _norm(bn, params: Mapping, stats: Mapping):
    _copy(bn.weight, params["scale"])
    _copy(bn.bias, params["bias"])
    _copy(bn.running_mean, stats["mean"])
    _copy(bn.running_var, stats["var"])


def load_jax_variables(module: PoseResNet, params: Mapping, batch_stats: Mapping) -> PoseResNet:
    """Fills `module` (in place) from the JAX package's flax trees."""
    enc_p = params["ResNetEncoder_0"]
    enc_s = batch_stats.get("ResNetEncoder_0", {})
    encoder = module.encoder
    _conv(encoder.stem, enc_p["Conv_0"])
    name = "BasicBlock" if isinstance(encoder.blocks[0], BasicBlock) else "Bottleneck"
    block_params = _by_suffix(enc_p, name)
    block_stats = _by_suffix(enc_s, name)
    if len(block_params) != len(encoder.blocks) or len(block_stats) != len(encoder.blocks):
        raise ValueError(f"{len(block_params)} {name} trees for {len(encoder.blocks)} blocks")
    for block, bp, bs in zip(encoder.blocks, block_params, block_stats):
        convs = _by_suffix(bp, "Conv")
        norms = [(p, s) for p, s in zip(_by_suffix(bp, "BatchNorm"), _by_suffix(bs, "BatchNorm"))]
        own_convs = [block.conv1, block.conv2] + ([block.conv3] if hasattr(block, "conv3") else [])
        own_norms = [block.bn1, block.bn2] + ([block.bn3] if hasattr(block, "bn3") else [])
        if block.downsample is not None:
            own_convs.append(block.downsample)
        if len(convs) != len(own_convs) or len(norms) != len(own_norms):
            raise ValueError(f"{name}: {len(convs)} convs / {len(norms)} norms for "
                             f"{len(own_convs)} / {len(own_norms)}")
        for conv, tree in zip(own_convs, convs):
            _conv(conv, tree)
        for bn, (p, s) in zip(own_norms, norms):
            _norm(bn, p, s)
    _copy(module.fc_rot.weight, params["fc_rot"]["kernel"], (1, 0))
    _copy(module.fc_trans.weight, params["fc_trans"]["kernel"], (1, 0))
    _copy(module.fc_trans.bias, params["fc_trans"]["bias"])
    return module
