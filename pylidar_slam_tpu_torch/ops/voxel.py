"""Voxel quantization, hashing and grid sampling on fixed-size padded clouds
(torch port of the part of ``pylidar_slam_tpu.ops.voxel`` the surfel map
needs; ``voxel_normal_distribution`` waits for the voxel map, ROADMAP.md
A.11).

The spatial hash is the reference's three-prime hash evaluated in int32
with wrap-around.  The port computes it exactly in int64 and wraps it back
to signed int32 explicitly, so it does not rest on how a backend overflows
int32 products.
"""
from __future__ import annotations

from typing import Optional

import torch

HASH_PRIMES = (73856093, 19349669, 83492791)
INT32_MAX = 2 ** 31 - 1


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the signed int32 value of their low 32 bits (as
    int64), i.e. what an int32 computation with wrap-around gives."""
    low = x & 0xFFFFFFFF
    return torch.where(low > INT32_MAX, low - (1 << 32), low)


def voxelise(points: torch.Tensor, voxel_x: float, voxel_y: float = -1.0,
             voxel_z: float = -1.0) -> torch.Tensor:
    """(N, 3) points -> (N, 3) int32 voxel coordinates (round half to
    even, as ``jnp.round``)."""
    if voxel_y <= 0:
        voxel_y = voxel_x
    if voxel_z <= 0:
        voxel_z = voxel_x
    # a float32 product with each axis' float32 scale, as the JAX package's
    # (built per column, so no host tensor is copied to the device)
    scaled = torch.stack([points[..., i] * (1.0 / v)
                          for i, v in enumerate((voxel_x, voxel_y, voxel_z))], dim=-1)
    return torch.round(scaled).to(torch.int32)


def voxel_hash(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 voxel coords -> (N,) spatial hashes: the int32
    wrap-around values, held in int64."""
    c = coords.to(torch.int64)
    return wrap_int32(HASH_PRIMES[0] * c[..., 0] + HASH_PRIMES[1] * c[..., 1]
                      + HASH_PRIMES[2] * c[..., 2])


def grid_sample_mask(points: torch.Tensor, voxel_size: float,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Marks one point per voxel: the first (lowest-index) point of each
    voxel, among the points `mask` keeps.  Returns an (N,) bool mask."""
    n = points.shape[0]
    hashes = voxel_hash(voxelise(points, voxel_size))
    if mask is not None:
        # Invalid points get an out-of-band key so they never win a voxel.
        hashes = torch.where(mask, hashes, torch.full_like(hashes, INT32_MAX))
    order = torch.argsort(hashes, stable=True)
    sorted_h = hashes[order]
    first = torch.ones_like(sorted_h, dtype=torch.bool)
    first[1:] = sorted_h[1:] != sorted_h[:-1]
    if mask is not None:
        first = first & mask[order]
    keep = torch.zeros((n,), dtype=torch.bool, device=points.device)
    return keep.index_put((order,), first)
