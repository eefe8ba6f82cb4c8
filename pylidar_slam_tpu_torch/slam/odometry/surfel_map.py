"""Surfel ring local map with exact nearest neighbours, the
"kdtree_local_map" (torch port of
``pylidar_slam_tpu.slam.odometry.surfel_map``).

The map is a fixed ring of K slots x S grid-sampled points per inserted
frame, each with a normal, held in the frame of a past insert (the
"anchor").  Every ICP iteration re-associates the frame's M grid-sampled
targets with their nearest map points: exactly, with kernel B2
(``ops.kernels.nn_argmin``), or through the voxel-hash grid
(``ops.hash_nn``, ``nn_backend="hash"``).  Map normals come from a k-NN
plane fit over the accumulated map ("knn") or from the scan's normal map
("image").

Control flow runs on the device with no host sync, as in the aggregated
map: the JAX early-exit ``while_loop`` is a fixed ``max_num_alignments``
trip whose carries freeze once the stop condition holds, and each
``lax.cond`` computes both branches and selects.  The exact search takes
the loop's condition as a device flag, so a frozen trip costs no NN pass.

With ``shard_points`` = S ranks, each rank registers a block of the targets
and every GN trip all-reduces the 6x6 normal equations (gloo, which the
card's ranks share, stages each one through the host).  Without a process
group the step is graph-safe: ``ICPFrameToModel`` replays its batched
frames on the card as one CUDA graph a frame.

A frame's step opens the spans ``odometry.dequant``, ``odometry.register``
and ``odometry.map_update`` (the aggregated map's names) and counts its
work in ``utils.timer``: ``surfel.nn_calls``, the exact searches enqueued
(host); on the device, ``surfel.nn_active_calls``, the searches whose flag
held, ``surfel.nn_pairs``, valid queries x valid map points over those, and
``surfel.knn_dropped``, the map points that the hash grid built at an
insert left out of a full bucket.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.ops import geometry, projection, se3, voxel
from pylidar_slam_tpu_torch.ops.hash_nn import (build_hash_grid, hash_grid_knn,
                                                hash_grid_nn, pack_grid)
from pylidar_slam_tpu_torch.ops.kernels.nn_argmin import nn_argmin
from pylidar_slam_tpu_torch.ops.optimization import (gauss_newton_step,
                                                     point_to_plane_at_identity,
                                                     robust_weights)
from pylidar_slam_tpu_torch.slam.odometry.aggregated_map import (
    _gather_image, dequant_upload, rasterize_encoded)
from pylidar_slam_tpu_torch.slam.odometry.local_map import (
    LocalMap, LocalMapConfig, icp_args, insert_rule, make_batch_step, select_state)
from pylidar_slam_tpu_torch.utils import assert_debug
from pylidar_slam_tpu_torch.utils.timer import count, device_counts, span


@dataclass
class SurfelRingMapConfig(LocalMapConfig):
    type: str = "kdtree_local_map"
    local_map_size: int = 20  # K frames kept
    num_neighbors_normals: int = 10  # k of the knn map normals
    points_per_frame: int = 4096  # S grid-sampled map points per frame
    sample_voxel_size: float = 0.3  # map-point grid sampling
    target_samples: int = 16384  # grid-sampled ICP targets per frame (M)
    target_voxel_size: float = 0.4
    max_neighbor_dist: float = 1.0
    normals_kernel_size: int = 5
    # Levenberg regularization of the GN normal equations (0 = plain GN).
    levenberg_damping: float = 0.0
    # "exact" (kernel B2) or "hash" (voxel-hash bucket grid, exact within
    # the gate unless a bucket overflows hash_capacity).
    nn_backend: str = "exact"
    hash_buckets: int = 8192  # power of two
    hash_capacity: int = 32  # map points kept per bucket
    hash_voxel: float = 0.0  # bucket edge; 0 -> 2 * max_neighbor_dist
    # "knn": plane fit over the num_neighbors_normals nearest points of the
    # accumulated map; "image": the scan's normal map.
    normals_mode: str = "knn"
    # Re-express the map into the current frame when the anchor falls this
    # far behind (meters).
    reanchor_dist: float = 20.0


class SurfelMapState(NamedTuple):
    """Ring map in the ANCHOR frame (the frame of a past insert).

    ``table_pts`` / ``table_ids`` are the packed hash grid of the map
    (``ops.hash_nn.pack_grid``), built at each insert and carried until the
    next; the exact backend carries empty tables."""
    points: torch.Tensor  # (K * S, 3) in the anchor frame
    normals: torch.Tensor  # (K * S, 3)
    valid: torch.Tensor  # (K * S,) bool
    write_slot: torch.Tensor  # () int32 ring slot of the next insert
    anchor_from_cur: torch.Tensor  # (4, 4) current frame -> anchor frame
    table_pts: torch.Tensor  # (n_buckets, cap, 3) packed grid coordinates
    table_ids: torch.Tensor  # (n_buckets, cap) int32 packed grid point ids


_STATE_DTYPES = {"valid": torch.bool, "write_slot": torch.int32,
                 "table_ids": torch.int32}


def init_surfel_map(k: int, s: int, device, dtype=torch.float32,
                    hash_buckets: int = 0, hash_capacity: int = 0) -> SurfelMapState:
    """hash_buckets / hash_capacity size the carried packed grid; pass 0 for
    the exact backend, which carries empty tables."""
    nb, cap = int(hash_buckets), max(int(hash_capacity), 0)
    return SurfelMapState(
        points=torch.zeros((k * s, 3), dtype=dtype, device=device),
        normals=torch.zeros((k * s, 3), dtype=dtype, device=device),
        valid=torch.zeros((k * s,), dtype=torch.bool, device=device),
        write_slot=torch.zeros((), dtype=torch.int32, device=device),
        anchor_from_cur=torch.eye(4, dtype=dtype, device=device),
        table_pts=torch.zeros((nb, cap, 3), dtype=dtype, device=device),
        table_ids=torch.full((nb, cap), -1, dtype=torch.int32, device=device))


def surfel_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> SurfelMapState:
    """Map state from numpy arrays keyed by field name (e.g. the JAX
    package's ``SurfelMapState._asdict()`` fetched to the host)."""
    fields = {name: torch.tensor(np.asarray(arrays[name]),
                                 dtype=_STATE_DTYPES.get(name, torch.float32),
                                 device=device)
              for name in SurfelMapState._fields}
    # the JAX package's initial state holds the table as (n_buckets * cap, 3)
    fields["table_pts"] = fields["table_pts"].reshape(
        *fields["table_ids"].shape, 3)
    return SurfelMapState(**fields)


def surfel_state_to_numpy(state: SurfelMapState) -> Dict[str, np.ndarray]:
    return {name: t.detach().cpu().numpy()
            for name, t in zip(SurfelMapState._fields, state)}


def _grid_sample_fixed(points: torch.Tensor, mask: torch.Tensor,
                       voxel_size: float, capacity: int):
    """Grid-samples to exactly `capacity` slots: (points (capacity, 3),
    their indices, their validity).

    The first point of each voxel wins (``voxel.grid_sample_mask``).  With
    more winners than `capacity`, the kept subset follows voxel-hash order:
    an XOR hash of the floor coordinates, viewed as uint32 and shifted right
    by one, losers keyed 0xFFFFFFFF, under a stable argsort.  The keys are
    built in int64 so that the order, and so the kept subset, is the JAX
    package's.
    """
    keep = voxel.grid_sample_mask(points, voxel_size, mask=mask)
    c = torch.floor(points / voxel_size).to(torch.int32).to(torch.int64)
    h = ((c[:, 0] * 73856093) ^ (c[:, 1] * 19349669) ^ (c[:, 2] * 83492791)) \
        & 0xFFFFFFFF
    priority = torch.where(keep, h >> 1, torch.full_like(h, 0xFFFFFFFF))
    idx = torch.argsort(priority, stable=True)[:capacity]
    return points[idx], idx, keep[idx]


def _rows_write(table: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
                k: int) -> torch.Tensor:
    """Writes `rows` (S, ...) into ring slot `slot` (a device int) of the
    flat (K * S, ...) `table`, out of place and without a host sync."""
    ring = table.reshape((k, -1) + table.shape[1:])
    return ring.index_copy(0, slot.reshape(1).to(torch.int64),
                           rows[None]).reshape(table.shape)


def make_surfel_icp_frame_step(proj: projection.SphericalProjection,
                               map_cfg: SurfelRingMapConfig,
                               max_num_alignments: int,
                               threshold_delta_pose: float,
                               threshold_trans: float,
                               threshold_rot: float,
                               gn_scheme: str,
                               gn_sigma: float,
                               gn_eps: float = 1.0e-4,
                               upload_quantization: float = 0.0,
                               reassoc_every: int = 1,
                               reassoc_motion_m: float = 0.0,
                               group=None):
    """Builds (step, first_frame, batch_step) for the surfel-ring odometry.

    `max_num_alignments` GN iterations; the nearest neighbours are searched
    anew every `reassoc_every` iterations and, when `reassoc_motion_m` > 0,
    whenever the pose moved more than that since the last search.  In
    between, the held pairs are reused with distances recomputed at the
    current pose.

    With a process `group` of S ranks, the ICP targets are sharded: the map
    state and the pose are replicated, rank r registers the contiguous block
    ``targets[r*M/S:(r+1)*M/S]``, and each GN iteration all-reduces the
    partial normal equations once, so every rank computes the same pose
    (and the same stop condition).  The match count is all-reduced once per
    registration.
    """
    h, w = proj.height, proj.width
    k = int(map_cfg.local_map_size)
    s = int(map_cfg.points_per_frame)
    m_targets = int(map_cfg.target_samples)
    max_nd = float(map_cfg.max_neighbor_dist)
    nks = int(map_cfg.normals_kernel_size)
    damping = float(map_cfg.levenberg_damping)
    reassoc_every = max(int(reassoc_every or 1), 1)
    backend = str(map_cfg.nn_backend)
    if backend not in ("exact", "hash"):
        raise ValueError(f"unknown nn_backend '{backend}' (exact or hash)")
    use_hash = backend == "hash"
    normals_mode = str(map_cfg.normals_mode)
    if normals_mode not in ("knn", "image"):
        raise ValueError(f"unknown normals_mode '{normals_mode}' (knn or image)")
    hash_buckets = int(map_cfg.hash_buckets)
    hash_cap = int(map_cfg.hash_capacity)
    hash_voxel = float(map_cfg.hash_voxel) or 2.0 * max_nd
    assert hash_voxel >= 2.0 * max_nd or not use_hash, (
        f"hash_voxel {hash_voxel} < 2 * max_neighbor_dist {2 * max_nd}: the "
        f"2x2x2 probe would miss in-gate neighbours (ops/hash_nn.py)")
    reanchor_dist = float(map_cfg.reanchor_dist)
    if group is not None:
        n_shard, shard = dist.get_world_size(group), dist.get_rank(group)
        assert_debug(m_targets % n_shard == 0,
                     f"target_samples {m_targets} must divide over {n_shard} ranks")
        block = slice(shard * m_targets // n_shard, (shard + 1) * m_targets // n_shard)
    # the work a frame counts on the device, in one add: B2's searches where
    # it runs them, and what the hash grid of an insert left out
    counted = (() if use_hash else ("surfel.nn_active_calls", "surfel.nn_pairs")) + \
        (("surfel.knn_dropped",) if use_hash or normals_mode == "knn" else ())

    def build_grid(points: torch.Tensor, valid: torch.Tensor):
        """Bucket grid + dense packing of the map, built once per insert."""
        return pack_grid(points, build_hash_grid(points, valid, hash_voxel,
                                                 hash_buckets, hash_cap),
                         hash_cap)

    def research(state: SurfelMapState, moved: torch.Tensor,
                 flag: torch.Tensor):
        """Nearest map point of every moved target -> (ref, normal, sq_d).
        `flag` False lets the exact kernel skip the pass (its result is then
        discarded by the caller's select)."""
        if use_hash:
            idx, sq = hash_grid_nn(moved, state.points,
                                   (state.table_pts, state.table_ids),
                                   hash_voxel, hash_buckets, hash_cap, max_nd)
            # No-candidate queries carry sq = inf; zero their normals so that
            # held-pair reuse can never resurrect them through the gate.
            found = torch.isfinite(sq)[:, None]
            idx = idx.to(torch.int64)
            zero = torch.zeros_like(moved)
            return (torch.where(found, state.points[idx], zero),
                    torch.where(found, state.normals[idx], zero), sq)
        count("surfel.nn_calls")
        idx, sq = nn_argmin(moved, state.points, state.valid, active=flag)
        idx = idx.to(torch.int64)
        return state.points[idx], state.normals[idx], sq

    def register(state: SurfelMapState, targets: torch.Tensor,
                 t_valid: torch.Tensor, t_init: torch.Tensor):
        """Solves ta = anchor_from_new; targets arrive in the new frame and
        t_init is the anchor-frame initialization.  Returns (ta, iterations
        run, loss, matches, searches run) as device tensors."""
        dev, dt = targets.device, targets.dtype
        t = t_init
        ref = torch.zeros_like(targets)
        nrm = torch.zeros_like(targets)
        t_assoc = t_init
        delta_norm = torch.full((), math.inf, dtype=dt, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        loss = torch.zeros((), dtype=dt, device=dev)
        matches = torch.zeros((), dtype=torch.int32, device=dev)
        reused = torch.zeros((), dtype=torch.int32, device=dev)  # trips that held pairs
        for trip in range(max_num_alignments):
            # The JAX loop's condition; once false every carry stays frozen.
            # While it holds, the JAX iteration counter equals `trip`.
            active = delta_norm >= threshold_delta_pose
            moved = se3.apply_transformation(targets, t)

            if trip % reassoc_every == 0:
                do_research = True
            elif reassoc_motion_m > 0.0:
                # Motion gate: the held pairs go stale with the pose.
                d_pre = t @ se3.inverse_pose_matrix(t_assoc)
                do_research = se3.pose_motion_magnitude(d_pre) > reassoc_motion_m
            else:
                do_research = False
            if do_research is True:
                ref_k, nrm_k, sq_k = research(state, moved, active)
                t_assoc_k = t
            else:
                # reuse: the held pairs, distances at the current pose
                e = moved - ref
                sq_reuse = torch.sum(e * e, dim=-1)
                if do_research is False:
                    ref_k, nrm_k, sq_k, t_assoc_k = ref, nrm, sq_reuse, t_assoc
                    reused = reused + active.to(torch.int32)
                else:
                    f_ref, f_nrm, f_sq = research(state, moved,
                                                  active & do_research)
                    ref_k = torch.where(do_research, f_ref, ref)
                    nrm_k = torch.where(do_research, f_nrm, nrm)
                    sq_k = torch.where(do_research, f_sq, sq_reuse)
                    t_assoc_k = torch.where(do_research, t, t_assoc)
                    reused = reused + (active & ~do_research).to(torch.int32)

            ok = t_valid & (sq_k < max_nd * max_nd) & \
                (torch.amax(torch.abs(nrm_k), dim=-1) > 0)
            res, jac = point_to_plane_at_identity(moved, ref_k, nrm_k, ok)
            weights = robust_weights(gn_scheme, res, gn_sigma, sq_dists=sq_k,
                                     eps=gn_eps)
            weights = torch.where(ok, weights, torch.zeros_like(weights))
            dx, loss_k, singular = gauss_newton_step(res, jac, weights,
                                                     damping=damping, group=group)
            dn = torch.linalg.vector_norm(dx)
            apply = (dn >= threshold_delta_pose) & (~singular)
            new_t = se3.normalize_pose_matrix(
                (se3.build_pose_matrix(dx[None])[0] @ t)[None])[0]
            t_out = torch.where(apply, new_t, t)

            t = torch.where(active, t_out, t)
            ref = torch.where(active, ref_k, ref)
            nrm = torch.where(active, nrm_k, nrm)
            t_assoc = torch.where(active, t_assoc_k, t_assoc)
            delta_norm = torch.where(active, dn, delta_norm)
            it = it + active.to(torch.int32)
            loss = torch.where(active, loss_k, loss)
            matches = torch.where(active, ok.sum().to(torch.int32), matches)
        if group is not None:
            # every rank froze at the same trip: the sum of the ranks' counts
            # is that trip's count over all targets
            dist.all_reduce(matches, group=group)
        return t, it, loss, matches, it - reused

    def insert(state: SurfelMapState, points: torch.Tensor, mask: torch.Tensor,
               ta: torch.Tensor):
        """Writes the new frame's S grid-sampled surfels into the ring slot,
        in the anchor frame (`ta` = anchor_from_new); the rest of the map is
        untouched, and the packed grid is rebuilt.  Returns (state, map
        points the grid left out of a full bucket, or None where no grid is
        built)."""
        idx_img, hit = rasterize_encoded(points, proj, mask)
        vmap = _gather_image(points, idx_img, hit, h, w)
        vpix = vmap.reshape(-1, 3)
        pix_valid = torch.amax(torch.abs(vpix), dim=-1) > 0
        sel_pts, sel_idx, sel_valid = _grid_sample_fixed(
            vpix, pix_valid, float(map_cfg.sample_voxel_size), s)
        sel_a = se3.apply_transformation(sel_pts, ta)
        sel_a = torch.where(sel_valid[:, None], sel_a, torch.zeros_like(sel_a))

        slot = state.write_slot
        new_points = _rows_write(state.points, slot, sel_a, k)
        pre_valid = _rows_write(state.valid, slot, sel_valid, k)

        grid = build_grid(new_points, pre_valid) if use_hash else None
        if normals_mode == "knn":
            # Cross-frame normals: a plane fit over the nearest points of the
            # accumulated map, the new frame included.
            if grid is None:
                grid = build_grid(new_points, pre_valid)
            idxk, sqk = hash_grid_knn(sel_a, new_points, grid, hash_voxel,
                                      hash_buckets, hash_cap, max_nd,
                                      int(map_cfg.num_neighbors_normals))
            nb = new_points[idxk.to(torch.int64)]
            sel_nrm = geometry.knn_plane_normals(nb, torch.isfinite(sqk))
        else:
            nmap = geometry.compute_normal_map(vmap, nks)
            sel_nrm = se3.apply_rotation(nmap.reshape(-1, 3)[sel_idx], ta)
        sel_valid = sel_valid & (torch.amax(torch.abs(sel_nrm), dim=-1) > 0)

        out = state._replace(
            points=new_points,
            normals=_rows_write(state.normals, slot, sel_nrm, k),
            valid=_rows_write(state.valid, slot, sel_valid, k),
            write_slot=(slot + 1) % k, anchor_from_cur=ta)
        if use_hash:
            out = out._replace(table_pts=grid[0], table_ids=grid[1])
        dropped = None if grid is None else pre_valid.sum() - (grid[1] >= 0).sum()
        return out, dropped

    def reanchor(st: SurfelMapState) -> SurfelMapState:
        """Re-expresses the map in the current frame."""
        inv_a = se3.inverse_pose_matrix(st.anchor_from_cur)
        pts = se3.apply_transformation(st.points, inv_a)
        pts = torch.where(st.valid[:, None], pts, torch.zeros_like(pts))
        st = st._replace(points=pts,
                         normals=se3.apply_rotation(st.normals, inv_a),
                         anchor_from_cur=torch.eye(4, dtype=pts.dtype,
                                                   device=pts.device))
        if use_hash:
            tp, ti = build_grid(pts, st.valid)
            st = st._replace(table_pts=tp, table_ids=ti)
        return st

    def step(state: SurfelMapState, delta_since_update: torch.Tensor,
             points: torch.Tensor, mask: torch.Tensor, init_rpose: torch.Tensor):
        """Full frame: register + thresholded insert + re-anchor.  Returns
        (state', delta', rpose, pose_params, (loss, iters, matches, inserted))."""
        with span("odometry.dequant"):
            points, mask, _ = dequant_upload(points, mask, proj, upload_quantization)
        with span("odometry.register"):
            targets, _, t_valid = _grid_sample_fixed(
                points, mask, float(map_cfg.target_voxel_size), m_targets)
            if group is not None:
                targets, t_valid = targets[block], t_valid[block]

            # Registration runs in the anchor frame; init and result convert
            # through anchor_from_cur (cur = the previous frame).
            ta_init = state.anchor_from_cur @ init_rpose
            ta, it, loss, matches, searched = register(state, targets, t_valid, ta_init)
            work = [] if use_hash else [
                searched.to(torch.int64),
                searched * t_valid.sum() * state.valid.sum()]  # valid query x map pairs

        with span("odometry.map_update"):
            inv_anchor = se3.inverse_pose_matrix(state.anchor_from_cur)
            t_final = se3.normalize_pose_matrix((inv_anchor @ ta)[None])[0]

            do_insert, delta_out = insert_rule(delta_since_update, t_final,
                                               threshold_trans, threshold_rot)

            # Both branches of each JAX lax.cond, selected on the device.  A
            # non-insert frame only moves the anchor pose.
            inserted, dropped = insert(state, points, mask, ta)
            if dropped is not None:
                work.append(dropped * do_insert)
            state = select_state(do_insert, inserted, state._replace(anchor_from_cur=ta))
            far = torch.linalg.vector_norm(state.anchor_from_cur[:3, 3]) > reanchor_dist
            state = select_state(far, reanchor(state), state)
            pose_params = se3.from_pose_matrix(t_final[None])[0]
        if counted:
            device_counts(counted, torch.stack(work))
        return state, delta_out, t_final, pose_params, (loss, it, matches,
                                                        do_insert)

    def first_frame(state: SurfelMapState, points: torch.Tensor,
                    mask: torch.Tensor) -> SurfelMapState:
        points, mask, _ = dequant_upload(points, mask, proj, upload_quantization)
        state, dropped = insert(state, points, mask,
                                torch.eye(4, dtype=torch.float32, device=points.device))
        if dropped is not None:
            device_counts(("surfel.knn_dropped",), dropped[None])
        return state

    return step, first_frame, make_batch_step(step)


def _shard_group(n_shard: int):
    """The process group of `shard_points` = n_shard: None for n_shard <= 1;
    else the first n_shard ranks of the initialized default group (ranks
    beyond them register alone).  Raises when fewer ranks are up."""
    if n_shard <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert_debug(world >= n_shard,
                 f"shard_points={n_shard} but only {world} rank(s) in the process "
                 f"group (run under torchrun --nproc_per_node {n_shard})")
    if world == n_shard:
        return dist.group.WORLD
    group = dist.new_group(list(range(n_shard)))  # collective: every rank calls it
    return group if dist.get_rank() < n_shard else None


def kdtree_local_map(config, proj: projection.SphericalProjection, map_dict: dict,
                     gn, alignment: dict) -> LocalMap:
    """The surfel map's record.  Its step has fixed shapes and reads
    nothing back to the host, so the odometry may capture it in a CUDA
    graph, unless it is sharded over `shard_points` ranks (its all-reduces
    pass the host)."""
    cfg = dataclass_from_dict(SurfelRingMapConfig, map_dict)
    group = _shard_group(int(config.shard_points or 0))
    step, first_frame, batch_step = make_surfel_icp_frame_step(
        group=group, proj=proj, map_cfg=cfg,
        reassoc_every=int(config.reassoc_every or 1), **icp_args(config, gn))
    k, s = int(cfg.local_map_size), int(cfg.points_per_frame)
    use_hash = str(cfg.nn_backend) == "hash"

    def init_state(device) -> SurfelMapState:
        return init_surfel_map(k, s, device,
                               hash_buckets=int(cfg.hash_buckets) if use_hash else 0,
                               hash_capacity=int(cfg.hash_capacity) if use_hash else 0)
    return LocalMap(cfg, init_state, step, first_frame, batch_step,
                    graph_safe=group is None)
