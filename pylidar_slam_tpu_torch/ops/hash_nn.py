"""Voxel-hash candidate k-NN: a bucketed pre-filter for the surfel map
(torch port of ``pylidar_slam_tpu.ops.hash_nn``).

The map is scattered once into a table of ``n_buckets`` buckets x ``cap``
point slots, keyed by the voxel of edge ``voxel_size``.  Each query probes
the 2x2x2 voxel block starting at ``floor((q - r) / voxel)``; with
``voxel_size >= 2 r`` every map point within ``r`` of the query is among
the candidates, so the result equals brute force within the gate unless a
bucket overflows ``cap``.  Hash collisions only add far candidates, ranked
by their true distance.

The uint32 hash arithmetic of the JAX package is done exactly in int64 and
masked to 32 bits.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import torch

from pylidar_slam_tpu_torch.ops.voxel import HASH_PRIMES

_U32 = 0xFFFFFFFF
# the 2x2x2 probe block, in the JAX package's meshgrid(..., indexing="ij")
# order
_PROBE = [(a, b, c) for a in range(2) for b in range(2) for c in range(2)]


@functools.lru_cache(maxsize=None)
def _probe_offsets(device: torch.device) -> torch.Tensor:
    return torch.tensor(_PROBE, dtype=torch.int64, device=device)

Slots = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _bucket_of(coords: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(..., 3) int voxel coords -> (...,) int64 bucket id in [0, n_buckets).

    Three-prime spatial hash with an avalanche finalizer (the prime mix
    alone leaves neighbouring voxels correlated in the low bits that the
    power-of-two mask keeps)."""
    c = coords.to(torch.int64)
    h = (HASH_PRIMES[0] * c[..., 0] ^ HASH_PRIMES[1] * c[..., 1]
         ^ HASH_PRIMES[2] * c[..., 2]) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _U32
    h = h ^ (h >> 16)
    return h & (n_buckets - 1)


def _voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return torch.floor(points / voxel_size).to(torch.int32)


def build_hash_grid(points: torch.Tensor, valid: torch.Tensor,
                    voxel_size: float, n_buckets: int, cap: int) -> torch.Tensor:
    """Scatters (V, 3) points into an (n_buckets * cap,) slot table of int32
    point indices, -1 for empty slots.  Overflowing residents (rank >= cap
    within their bucket, by point index) are dropped.  ``n_buckets`` must be
    a power of two."""
    assert n_buckets & (n_buckets - 1) == 0, "n_buckets must be a power of 2"
    v = points.shape[0]
    dev = points.device
    bucket = _bucket_of(_voxel_coords(points, voxel_size), n_buckets)
    # Invalid points sort past every real bucket and land in the dropped
    # sentinel slot.
    bucket = torch.where(valid, bucket, torch.full_like(bucket, n_buckets))

    order = torch.argsort(bucket, stable=True)
    sorted_b = bucket[order]
    idx = torch.arange(v, dtype=torch.int64, device=dev)
    first = torch.ones((v,), dtype=torch.bool, device=dev)
    first[1:] = sorted_b[1:] != sorted_b[:-1]
    seg_start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0)[0]
    rank = idx - seg_start
    keep = (rank < cap) & (sorted_b < n_buckets)
    sentinel = n_buckets * cap
    slot = torch.where(keep, sorted_b * cap + rank, torch.full_like(rank, sentinel))
    slots = torch.full((sentinel + 1,), -1, dtype=torch.int32, device=dev)
    # kept slots are distinct; every dropped point writes the sentinel row,
    # which is sliced off
    return slots.index_put((slot,), order.to(torch.int32))[:sentinel]


def pack_grid(points: torch.Tensor, slots: torch.Tensor,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densifies a slot table into per-bucket coordinate rows:
    ``(table_pts (B, cap, 3), table_ids (B, cap))``.  A probe then gathers
    8 contiguous bucket rows per query instead of 8 * cap scattered point
    rows; results are bit-identical to probing the raw slot table."""
    table_ids = slots.reshape(-1, cap)
    table_pts = points[torch.clamp(slots, min=0).to(torch.int64)]
    return table_pts.reshape(-1, cap, 3), table_ids


def _candidate_distances(queries: torch.Tensor, points: torch.Tensor,
                         slots: Slots, voxel_size: float, n_buckets: int,
                         cap: int, radius: float):
    """Shared probe: (M, 8 * cap) candidate point ids (-1 empty) and their
    squared distances (+inf where empty)."""
    m = queries.shape[0]
    base = _voxel_coords(queries - radius, voxel_size).to(torch.int64)
    buckets = _bucket_of(base[:, None, :] + _probe_offsets(queries.device)[None],
                         n_buckets)  # (M, 8)
    # Two probed voxels can hash into the SAME bucket; gather its residents
    # only once, or k-NN sees duplicates.
    same = buckets[:, :, None] == buckets[:, None, :]
    dup = torch.any(torch.tril(same, diagonal=-1), dim=-1)  # (M, 8)
    if isinstance(slots, tuple):  # pack_grid form: bucket-row gathers
        table_pts, table_ids = slots
        cand = table_ids[buckets].reshape(m, 8 * cap)
        cand_pts = table_pts[buckets].reshape(m, 8 * cap, 3)
    else:
        slot_ids = buckets[..., None] * cap + torch.arange(
            cap, dtype=torch.int64, device=queries.device)
        cand = slots[slot_ids.reshape(m, 8 * cap)]
        cand_pts = points[torch.clamp(cand, min=0).to(torch.int64)]
    cand = torch.where(torch.repeat_interleave(dup, cap, dim=1),
                       torch.full_like(cand, -1), cand)
    e = cand_pts - queries[:, None, :]
    d = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    d = torch.where(cand >= 0, d, torch.full_like(d, math.inf))
    return cand, d


def hash_grid_nn(queries: torch.Tensor, points: torch.Tensor, slots: Slots,
                 voxel_size: float, n_buckets: int, cap: int,
                 radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed 1-NN: (M, 3) queries -> (idx (M,) int32, sq_dist (M,)).
    Queries with no candidate get index 0 and +inf."""
    cand, d = _candidate_distances(queries, points, slots, voxel_size,
                                   n_buckets, cap, radius)
    sq, best = torch.min(d, dim=1)  # the first minimum
    idx = torch.gather(cand, 1, best[:, None])[:, 0]
    return torch.clamp(idx, min=0), sq


def hash_grid_knn(queries: torch.Tensor, points: torch.Tensor, slots: Slots,
                  voxel_size: float, n_buckets: int, cap: int, radius: float,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed k-NN: (M, 3) queries -> (idx (M, k) int32, sq_dist (M, k)),
    by ascending distance, the lower candidate first on ties (as
    ``lax.top_k``; a stable sort, since ``torch.topk`` does not promise the
    order of ties).  Missing neighbours carry +inf and index 0."""
    cand, d = _candidate_distances(queries, points, slots, voxel_size,
                                   n_buckets, cap, radius)
    sq, pos = torch.sort(d, dim=1, stable=True)
    idx = torch.gather(cand, 1, pos[:, :k])
    return torch.clamp(idx, min=0), sq[:, :k]
