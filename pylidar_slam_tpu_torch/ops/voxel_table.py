"""Persistent voxel-surfel hash table, the voxel map's store (torch port of
``pylidar_slam_tpu.ops.voxel_table``).

The table lives in a fixed ANCHOR frame.  One slot holds at most one surfel
(point, normal, insert frame, the voxel's full 32-bit hash).  A point claims
its voxel's slot only if the slot is empty or its resident has aged out of
the `k_live`-frame window; among same-frame candidates of one slot the
highest packed (hash priority | index) key wins.  A query probes the 27
voxels of the 3x3x3 block around it, one gathered row each: with the probe
radius at most a voxel edge every in-radius surfel lives in that block, so
the search is exact within the gate except for surfels lost to hash
collisions at insert time.  Point selection is one scatter-max of packed
keys into a small slot table, with no sort.

The JAX package's uint32 arithmetic is done exactly in int64 and masked to
32 bits.  Its dropped out-of-range scatters write a sentinel row that is
sliced off (every kept slot has exactly one writer, so only that row sees
racing writes on the card).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from pylidar_slam_tpu_torch.ops.voxel import HASH_PRIMES

_U32 = 0xFFFFFFFF


def _mix(h: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche finalizer on int64-held uint32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _U32
    return h ^ (h >> 16)


def _voxel_hash(coords: torch.Tensor, salt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., 3) int voxel coords -> (...,) full-width hash (uint32 values in
    int64).  A `salt` (the frame index) is XORed in before the mix."""
    c = coords.to(torch.int64)
    h = (HASH_PRIMES[0] * c[..., 0] ^ HASH_PRIMES[1] * c[..., 1]
         ^ HASH_PRIMES[2] * c[..., 2]) & _U32
    if salt is not None:
        h = h ^ ((0x9E3779B9 * salt.to(torch.int64)) & _U32)
    return _mix(h)


def _voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return torch.floor(points / voxel_size).to(torch.int32)


def _packed_keys(h: torch.Tensor, cand: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """(hash priority + 1) << idx_bits | index for the candidates, 0 for the
    rest: a slot's scatter-max keeps one candidate, deterministically."""
    idx_bits = max(int(n - 1).bit_length(), 1)
    assert idx_bits + 2 <= 32, "too many input points to pack"
    prio_bits = min(32 - idx_bits - 1, 14)
    prio = (h >> (32 - prio_bits)) + 1  # >= 1
    packed = (prio << idx_bits) | torch.arange(n, dtype=torch.int64, device=h.device)
    return torch.where(cand, packed, torch.zeros_like(packed)), idx_bits


def _scatter_max(slot: torch.Tensor, packed: torch.Tensor, n_slots: int) -> torch.Tensor:
    return torch.zeros((n_slots,), dtype=torch.int64, device=slot.device).scatter_reduce(
        0, slot, packed, "amax")


def _set_rows(table: torch.Tensor, safe_slot: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """table[safe_slot] = rows, out of place; rows aimed at len(table) (the
    losers) go to a sentinel row that is sliced off."""
    n = table.shape[0]
    rows = rows.expand((safe_slot.shape[0],) + table.shape[1:]).to(table.dtype)
    pad = torch.cat([table, table[:1]], dim=0)
    return pad.index_put((safe_slot,), rows)[:n]


def scatter_select(points: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                   n_out: int, salt: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free spatial subsample: one representative per hash slot of an
    `n_out`-slot table keyed by the point's voxel, the highest packed key
    winning.  A `salt` rotates the per-voxel priorities between calls.

    Returns ``(sel_points (n_out, 3), sel_idx (n_out,) int32, sel_valid
    (n_out,))``."""
    assert n_out & (n_out - 1) == 0, "n_out must be a power of 2"
    n = points.shape[0]
    h = _voxel_hash(_voxel_coords(points, voxel_size), salt)
    slot = h & (n_out - 1)
    packed, idx_bits = _packed_keys(h, valid, n)
    table = _scatter_max(slot, packed, n_out)
    sel_valid = table > 0
    sel_idx = table & ((1 << idx_bits) - 1)
    sel_pts = torch.where(sel_valid[:, None], points[sel_idx],
                          torch.zeros((), dtype=points.dtype, device=points.device))
    return sel_pts, sel_idx.to(torch.int32), sel_valid


class VoxelTable(NamedTuple):
    """Direct-mapped surfel table (every array has ``n_slots`` rows)."""
    points: torch.Tensor   # (T, 3) float32, anchor coordinates
    normals: torch.Tensor  # (T, 3) float32
    meta: torch.Tensor     # (T,) int32 insert frame, -1 = empty
    key: torch.Tensor      # (T,) int64 full voxel hash (a uint32 value)


def init_table(n_slots: int, device) -> VoxelTable:
    assert n_slots & (n_slots - 1) == 0, "n_slots must be a power of 2"
    return VoxelTable(points=torch.zeros((n_slots, 3), dtype=torch.float32, device=device),
                      normals=torch.zeros((n_slots, 3), dtype=torch.float32, device=device),
                      meta=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
                      key=torch.zeros((n_slots,), dtype=torch.int64, device=device))


def _live(table: VoxelTable, frame: torch.Tensor, k_live: int) -> torch.Tensor:
    return (table.meta >= 0) & (frame - table.meta < k_live)


def table_insert(table: VoxelTable, points: torch.Tensor, valid: torch.Tensor,
                 frame: torch.Tensor, k_live: int, voxel_size: float
                 ) -> Tuple[VoxelTable, torch.Tensor, torch.Tensor]:
    """Claims table slots for (S, 3) anchor-frame points: a point wins its
    voxel's slot iff the slot is empty or its resident is stale, and it has
    the slot's highest packed key.  The winners' normals are zeroed until
    :func:`table_set_normals` commits them.

    Returns ``(table', won (S,) bool, slot (S,) int64)``."""
    n_slots = table.meta.shape[0]
    s = points.shape[0]
    h = _voxel_hash(_voxel_coords(points, voxel_size))
    slot = h & (n_slots - 1)
    res_meta = table.meta[slot]
    cand = valid & ((res_meta < 0) | (frame - res_meta >= k_live))
    packed, _ = _packed_keys(h, cand, s)
    aux = _scatter_max(slot, packed, n_slots)
    won = cand & (aux[slot] == packed)
    safe_slot = torch.where(won, slot, torch.full_like(slot, n_slots))
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    return (VoxelTable(_set_rows(table.points, safe_slot, points),
                       _set_rows(table.normals, safe_slot, zero),
                       _set_rows(table.meta, safe_slot, frame),
                       _set_rows(table.key, safe_slot, h)), won, slot)


def table_set_normals(table: VoxelTable, won: torch.Tensor, won_slot: torch.Tensor,
                      normals: torch.Tensor) -> VoxelTable:
    """Commits (S, 3) normals for the winners of :func:`table_insert`."""
    n_slots = table.meta.shape[0]
    safe_slot = torch.where(won, won_slot.to(torch.int64),
                            torch.full_like(won_slot, n_slots, dtype=torch.int64))
    return table._replace(normals=_set_rows(table.normals, safe_slot, normals))


@functools.lru_cache(maxsize=None)
def _probe_offsets(radius: float, voxel_size: float, device) -> torch.Tensor:
    """(P, 3) voxel offsets of the block covering `radius`, in the JAX
    package's meshgrid(..., indexing="ij") order."""
    reach = max(int(-(-radius // voxel_size)), 1)  # ceil
    r = range(-reach, reach + 1)
    return torch.tensor([(a, b, c) for a in r for b in r for c in r],
                        dtype=torch.int64, device=device)


def _probe_candidates(table: VoxelTable, queries: torch.Tensor, frame: torch.Tensor,
                      k_live: int, voxel_size: float, radius: float):
    """(M, P) probed slots and their squared distances (+inf for a dead or
    colliding resident, or one beyond `radius`)."""
    n_slots = table.meta.shape[0]
    offs = _probe_offsets(float(radius), float(voxel_size), queries.device)
    coords = _voxel_coords(queries, voxel_size).to(torch.int64)
    h = _voxel_hash(coords[:, None, :] + offs[None])  # (M, P)
    slot = h & (n_slots - 1)
    meta = table.meta[slot]
    ok = (meta >= 0) & (frame - meta < k_live) & (table.key[slot] == h)
    e = table.points[slot] - queries[:, None, :]
    d = torch.sum(e * e, dim=-1)
    d = torch.where(ok & (d <= radius * radius), d, torch.full_like(d, math.inf))
    return slot, d


def table_nn(table: VoxelTable, queries: torch.Tensor, frame: torch.Tensor,
             k_live: int, voxel_size: float,
             radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN among live surfels: (M, 3) -> (slot (M,), sq_dist (M,)); misses
    carry the first probe's slot and +inf (``argmin`` takes the first
    minimum, as ``jnp.argmin``)."""
    slot, d = _probe_candidates(table, queries, frame, k_live, voxel_size, radius)
    best = torch.argmin(d, dim=1, keepdim=True)
    return torch.gather(slot, 1, best)[:, 0], torch.gather(d, 1, best)[:, 0]


def table_knn(table: VoxelTable, queries: torch.Tensor, frame: torch.Tensor,
              k_live: int, voxel_size: float, radius: float,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN among live surfels: (slots (M, k), sq_dists (M, k)) by ascending
    distance, the lower probe first on ties (``lax.top_k``'s order, by a
    stable sort); missing neighbours carry +inf."""
    slot, d = _probe_candidates(table, queries, frame, k_live, voxel_size, radius)
    sq, pos = torch.sort(d, dim=1, stable=True)
    return torch.gather(slot, 1, pos[:, :k]), sq[:, :k]


def table_reanchor(table: VoxelTable, new_from_old: torch.Tensor,
                   voxel_size: float) -> VoxelTable:
    """Re-expresses every surfel in a new anchor frame and re-hashes it into
    a fresh table; two surfels landing in one slot keep the higher packed
    key."""
    n_slots = table.meta.shape[0]
    rot = new_from_old[:3, :3]
    pts = table.points @ rot.T + new_from_old[:3, 3]
    nrm = table.normals @ rot.T
    alive = table.meta >= 0
    h = _voxel_hash(_voxel_coords(pts, voxel_size))
    slot = h & (n_slots - 1)
    assert min(32 - int(n_slots - 1).bit_length() - 1, 14) >= 1, \
        "n_slots too large to pack re-anchor keys"
    packed, _ = _packed_keys(h, alive, n_slots)
    aux = _scatter_max(slot, packed, n_slots)
    won = alive & (aux[slot] == packed)
    safe_slot = torch.where(won, slot, torch.full_like(slot, n_slots))
    fresh = init_table(n_slots, pts.device)
    return VoxelTable(points=_set_rows(fresh.points, safe_slot, pts),
                      normals=_set_rows(fresh.normals, safe_slot, nrm),
                      meta=_set_rows(fresh.meta, safe_slot, table.meta),
                      key=_set_rows(fresh.key, safe_slot, h))
