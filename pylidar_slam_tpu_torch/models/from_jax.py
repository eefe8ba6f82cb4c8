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

``read_jax_checkpoint`` reads the JAX trainer's ``checkpoint.ckp`` (a pickle
of those trees, ``exp_s``, optax's optimizer state and the counters)
without importing JAX, flax or optax.
"""
from __future__ import annotations

import collections
import copy
import functools
import pickle
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


# optax's state classes a JAX PoseNet checkpoint holds, by class name (their
# module paths moved between optax releases; names and fields did not)
_OPTAX_FIELDS = {
    "InjectStatefulHyperparamsState": ("count", "hyperparams", "hyperparams_states",
                                       "inner_state"),
    "InjectHyperparamsState": ("count", "hyperparams", "inner_state"),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByRmsState": ("nu",),
    "TraceState": ("trace",),
    "EmptyState": (),
}
_NUMPY_GLOBALS = {(m, n) for m in ("numpy._core.multiarray", "numpy.core.multiarray")
                  for n in ("_reconstruct", "scalar")} | \
    {(m, "_frombuffer") for m in ("numpy._core.numeric", "numpy.core.numeric")} | \
    {("numpy", "ndarray"), ("numpy", "dtype")}
_BUILTIN_GLOBALS = {("builtins", n) for n in ("dict", "list", "tuple", "set", "frozenset",
                                              "int", "float", "complex", "bool", "str",
                                              "bytes", "bytearray", "slice")} | \
    {("collections", "OrderedDict")}


class JaxObject(dict):
    """Stand-in for a JAX, flax or optax object the reader has no fields
    for: its module and class, its constructor arguments (``args``) and its
    pickled state (``state``)."""

    def __init__(self, *args):
        super().__init__(args=args, state=None)

    def __setstate__(self, state):
        self["state"] = state


@functools.lru_cache(maxsize=None)
def _stand_in(module: str, name: str):
    if name in _OPTAX_FIELDS:
        return collections.namedtuple(name, _OPTAX_FIELDS[name])
    if name == "FrozenDict":  # pickled as FrozenDict(dict)
        return dict
    return type(name, (JaxObject,), {"module": module})


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS or (module, name) in _BUILTIN_GLOBALS:
            return super().find_class(module, name)
        if module.split(".", 1)[0] in ("jax", "jaxlib", "flax", "optax"):
            return _stand_in(module, name)
        raise pickle.UnpicklingError(
            f"a JAX checkpoint holds no {module}.{name}: refused (only numpy arrays, "
            f"builtins and JAX/flax/optax state classes are read)")


def read_jax_checkpoint(path) -> dict:
    """The JAX trainer's ``checkpoint.ckp``: ``params`` and ``batch_stats``
    (flax trees of numpy arrays; a ``FrozenDict`` reads as a dict),
    ``exp_s`` (array or None), ``opt_state`` (optax's state as named tuples
    of the same trees), ``num_train_epochs``, ``train_iter`` and
    ``eval_iter``.  Imports none of JAX, flax and optax; any other global
    in the pickle is refused."""
    with open(path, "rb") as f:
        state = _CheckpointUnpickler(f).load()
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{path} is not a JAX PoseNet checkpoint")
    return {"params": state["params"], "batch_stats": state.get("batch_stats", {}),
            "exp_s": state.get("exp_s"), "opt_state": state.get("opt_state"),
            "num_train_epochs": int(state.get("num_train_epochs", 0)),
            "train_iter": int(state.get("train_iter", 0)),
            "eval_iter": int(state.get("eval_iter", 0))}


def param_tensors(module: PoseResNet, params: Mapping, batch_stats: Mapping) -> dict:
    """A tree shaped like ``params`` (e.g. an optimizer moment) in the
    module's layout: {parameter name: tensor}, through a zeroed copy of
    the module."""
    twin = copy.deepcopy(module)
    with torch.no_grad():
        for p in twin.parameters():
            p.zero_()
    load_jax_variables(twin, params, batch_stats)
    return {name: p.detach() for name, p in twin.named_parameters()}
