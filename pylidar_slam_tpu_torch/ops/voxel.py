"""Voxel quantization, hashing, grid sampling and per-voxel normal
distributions on fixed-size padded clouds (torch port of
``pylidar_slam_tpu.ops.voxel``).

The spatial hash is the reference's three-prime hash evaluated in int32
with wrap-around.  The port computes it exactly in int64 and wraps it back
to signed int32 explicitly, so it does not rest on how a backend overflows
int32 products.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class VoxelStats(NamedTuple):
    """Per-voxel normal distribution over a padded capacity of V slots."""
    sizes: torch.Tensor  # (V,) int32 points in each voxel (0 = empty)
    means: torch.Tensor  # (V, 3)
    covariances: torch.Tensor  # (V, 3, 3)
    point_voxel_ids: torch.Tensor  # (N,) int32 voxel slot of each input point


def voxel_normal_distribution(points: torch.Tensor, voxel_size: float,
                              mask: Optional[torch.Tensor] = None,
                              capacity: Optional[int] = None) -> VoxelStats:
    """Per-voxel mean and (unnormalized, mean-corrected) covariance by a
    sweep over the points sorted by voxel hash: voxel slots are in
    ascending hash order, unused slots have size 0, and voxels past
    `capacity` (default N) are dropped."""
    n = points.shape[0]
    v = capacity or n
    dev = points.device
    hashes = voxel_hash(voxelise(points, voxel_size))
    if mask is not None:
        hashes = torch.where(mask, hashes, torch.full_like(hashes, INT32_MAX))
    order = torch.argsort(hashes, stable=True)
    sorted_h = hashes[order]
    sorted_pts = points[order]
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = sorted_h[1:] != sorted_h[:-1]
    seg_ids = torch.cumsum(first.to(torch.int64), 0) - 1  # 0..V-1, sorted order

    valid = torch.ones((n,), dtype=torch.bool, device=dev) if mask is None \
        else mask[order]
    w = valid.to(points.dtype)
    slots = max(v, n)  # segments past `capacity` land in rows sliced off

    def segment_sum(values):
        out = values.new_zeros((slots,) + values.shape[1:])
        return out.index_add_(0, seg_ids, values)[:v]

    sizes = segment_sum(valid.to(torch.int32))
    sums = segment_sum(sorted_pts * w[:, None])
    outer = (sorted_pts[:, :, None] * sorted_pts[:, None, :]) * w[:, None, None]
    sq_sums = segment_sum(outer)
    counts = torch.clamp(sizes, min=1).to(points.dtype)
    means = sums / counts[:, None]
    covs = sq_sums - counts[:, None, None] * (means[:, :, None] * means[:, None, :])
    point_ids = torch.zeros((n,), dtype=torch.int32, device=dev).index_put(
        (order,), seg_ids.to(torch.int32))
    return VoxelStats(sizes=sizes, means=means, covariances=covs,
                      point_voxel_ids=point_ids)
