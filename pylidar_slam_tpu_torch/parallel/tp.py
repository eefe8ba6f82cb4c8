"""Tensor parallelism of PoseNet's weights over the ranks of a ``tp`` group
(torch port of ``pylidar_slam_tpu.parallel.tp``).

The JAX package places each weight with a ``NamedSharding`` that splits a
feature dimension and lets GSPMD insert the collectives.  The port applies
the same rule to the same weights -- read on the flax layout of each
parameter, conv kernels ``(kh, kw, in, out)`` and dense kernels ``(in,
out)``: the last dimension when ``tp`` divides it, else the one before,
everything 1-D replicated -- and inserts the collectives itself:

* a split of the output features is column-parallel: each rank computes
  its slice of the channels, and an all-reduce of a zero-filled buffer that
  holds each rank's slice in its place gathers them (adding zeros is exact,
  and gloo has no all-gather of CUDA tensors);
* a split of the input features is row-parallel: each rank multiplies its
  slice of the input channels, and an all-reduce adds the partial products.

Both all-reduces are ``torch.distributed.nn.functional.all_reduce``, whose
backward all-reduces the gradient.  Activations between the layers are
replicated over the group, so each rank backpropagates its share 1/tp of the
loss: a replicated weight's gradient is then the sum of the
ranks' gradients, and a sharded weight's is already whole.  Optimizer
moments follow their parameters (the same slices).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.nn.functional import all_reduce


def flax_shape(param: torch.Tensor) -> Tuple[int, ...]:
    """The flax layout of a port parameter: OIHW conv weights -> HWIO,
    (out, in) dense weights -> (in, out); other shapes as they are."""
    shape = tuple(param.shape)
    if len(shape) == 4:
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if len(shape) == 2:
        return (shape[1], shape[0])
    return shape


def leaf_split(shape: Tuple[int, ...], tp: int) -> Optional[int]:
    """The dimension of the flax-layout `shape` split over `tp` ranks, or
    None (replicated): the JAX package's ``leaf_sharding`` rule."""
    if tp > 1 and len(shape) >= 2:
        for d in (len(shape) - 1, len(shape) - 2):
            if shape[d] % tp == 0 and shape[d] >= tp:
                return d
    return None


class ParallelLayer(nn.Module):
    """A Conv2d (bias-free) or Linear whose weight is split over `group`:
    ``column`` splits the output features, ``row`` the input features."""

    def __init__(self, layer: nn.Module, kind: str, group: dist.ProcessGroup):
        super().__init__()
        self.kind, self.group = kind, group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.conv = isinstance(layer, nn.Conv2d)
        if self.conv:
            self.stride, self.padding = layer.stride, layer.padding
        weight = layer.weight.detach()
        dim = 0 if kind == "column" else 1
        self.full = weight.shape[dim]
        local = self.full // self.size
        self.weight = nn.Parameter(weight.narrow(dim, self.rank * local, local).clone())
        self.bias = None if layer.bias is None else nn.Parameter(layer.bias.detach().clone())

    def _local(self, x):
        if self.conv:
            return F.conv2d(x, self.weight, None, self.stride, self.padding)
        return F.linear(x, self.weight)

    def forward(self, x):
        ch = 1 if self.conv else x.dim() - 1  # the feature dimension
        local = self.full // self.size
        if self.kind == "row":
            y = all_reduce(self._local(x.narrow(ch, self.rank * local, local)),
                           group=self.group)
        else:
            y = self._local(x)
            before, after = self.rank * local, self.full - (self.rank + 1) * local
            pad = [0, 0] * (y.dim() - 1 - ch) + [before, after]
            y = all_reduce(F.pad(y, pad), group=self.group)
        if self.bias is not None:
            y = y + (self.bias[:, None, None] if self.conv else self.bias)
        return y


def shard_module(module: nn.Module, group: dist.ProcessGroup) -> Dict[str, Tuple[str, int]]:
    """Replaces each Conv2d / Linear of `module` whose weight the rule
    splits by a ParallelLayer holding this rank's slice.  Returns, per
    split parameter name (``state_dict`` names are unchanged), its kind and
    its port-layout dimension."""
    tp = dist.get_world_size(group)
    split = {}
    for name, layer in list(module.named_modules()):
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            continue
        flax = flax_shape(layer.weight)
        d = leaf_split(flax, tp)
        if d is None:
            continue
        kind = "column" if d == len(flax) - 1 else "row"
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, child, ParallelLayer(layer, kind, group))
        split[f"{name}.weight"] = (kind, 0 if kind == "column" else 1)
    return split


def take_slice(full: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's slice of `full` along `dim`."""
    local = full.shape[dim] // dist.get_world_size(group)
    return full.narrow(dim, dist.get_rank(group) * local, local).clone()


def gather_slices(local: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The whole tensor from each rank's slice along `dim` (an all-reduce of
    a zero-filled buffer, exact)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    shape = list(local.shape)
    shape[dim] *= size
    full = local.new_zeros(shape)
    full.narrow(dim, rank * local.shape[dim], local.shape[dim]).copy_(local)
    dist.all_reduce(full, group=group)
    return full
