"""The process layout of a multi-rank run (torch port of
``pylidar_slam_tpu.parallel.mesh``).

Named axes over the ranks of the default ``torch.distributed`` process
group:

* ``dp`` -- data parallelism over training batches (PoseNet training),
* ``sp`` -- point sharding of ICP normal equations (one all-reduce of the
  6x6 system per Gauss-Newton iteration),
* ``tp`` -- tensor parallelism of weight feature dimensions (``parallel.tp``).

Ranks are laid out row-major over the axes, as ``np.reshape`` lays out the
JAX package's device array, and every axis has one ``ProcessGroup`` per
line of ranks along it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """This rank's place in the layout: the axes' names and sizes, its
    coordinate on each axis and the group of ranks along each axis."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_sizes: Optional[Sequence[Tuple[str, int]]] = None) -> Mesh:
    """Builds the Mesh from (axis, size) pairs over the initialized default
    process group; the sizes must multiply to its world size.

    Default: all ranks on a single ``dp`` axis.  Every rank must call this
    with the same pairs (``dist.new_group`` is collective).
    """
    world, rank = dist.get_world_size(), dist.get_rank()
    if axis_sizes is None:
        axis_sizes = [("dp", world)]
    names = tuple(a for a, _ in axis_sizes)
    sizes = tuple(int(s) for _, s in axis_sizes)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"Mesh sizes {list(sizes)} do not multiply to {world} ranks")
    layout = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = {}
    for axis, name in enumerate(names):
        lines = np.moveaxis(layout, axis, -1).reshape(-1, sizes[axis])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return Mesh(names, sizes, coords, groups)


def factorize_two(n: int) -> Tuple[int, int]:
    """Splits n into the most balanced (a, b) with a*b = n (a >= b)."""
    best = (n, 1)
    for b in range(1, int(np.sqrt(n)) + 1):
        if n % b == 0:
            best = (n // b, b)
    return best


def rank_device(device: torch.device) -> torch.device:
    """The device of this rank: ``cuda:(local_rank % device_count)`` when
    `device` is the card, else `device`."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_from_env(device: torch.device) -> bool:
    """Joins the default process group described by ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
    when there is one and the group is not up yet.  NCCL when every rank has
    a card of its own, else gloo (NCCL refuses two ranks on one card).
    Returns whether a group of more than one rank is up."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        own_card = device.type == "cuda" and world <= torch.cuda.device_count()
        dist.init_process_group("nccl" if own_card else "gloo")
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main_rank() -> bool:
    """True outside a process group and on rank 0 inside one: the rank that
    writes a run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0
