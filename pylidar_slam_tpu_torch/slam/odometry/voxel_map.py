"""Incremental voxel-table local map odometry, the "voxel_local_map"
(torch port of ``pylidar_slam_tpu.slam.odometry.voxel_map``).

Point-to-plane ICP with exact-in-gate nearest neighbours, like the surfel
map, on the persistent anchor-frame table of ``ops.voxel_table``.  Per
frame:

1. decode the upload and scatter-select M targets (salted by the frame);
2. ICP in anchor coordinates: transform the targets, probe the table for
   their neighbours (re-searched every `reassoc_every` trips and when the
   pose moved more than `reassoc_motion_m`, the held pairs reused in
   between), one robust point-to-plane GN step;
3. when the motion since the last insert passes the thresholds, insert the
   same M points (keep-old-unless-stale) and fit k-NN plane normals for the
   winners;
4. re-anchor (transform and re-hash the table) once the pose has drifted
   `reanchor_dist` from the anchor.

Control flow runs on the device with no host sync, as in the other maps:
the early-exit ``while_loop`` is a fixed trip whose carries freeze, and
each ``lax.cond`` (the insert, the re-anchor, the re-search) computes both
branches and selects.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.ops import geometry, projection, se3
from pylidar_slam_tpu_torch.ops.optimization import (gauss_newton_step,
                                                     point_to_plane_at_identity,
                                                     robust_weights)
from pylidar_slam_tpu_torch.ops.voxel_table import (VoxelTable, init_table,
                                                    scatter_select, table_insert,
                                                    table_knn, table_nn,
                                                    table_reanchor,
                                                    table_set_normals)
from pylidar_slam_tpu_torch.slam.odometry.aggregated_map import dequant_upload
from pylidar_slam_tpu_torch.slam.odometry.local_map import (
    LocalMap, LocalMapConfig, icp_args, insert_rule, make_batch_step, select_state)


@dataclass
class VoxelTableMapConfig(LocalMapConfig):
    type: str = "voxel_local_map"
    local_map_size: int = 30      # K: staleness window in frames
    map_voxel: float = 0.4        # voxel edge = map resolution (m)
    max_neighbor_dist: float = 0.4  # NN gate; the probe block covers it
    table_slots: int = 262144     # power of 2
    target_samples: int = 8192    # scatter-selected targets (= insert candidates)
    num_neighbors_normals: int = 10
    reanchor_dist: float = 50.0   # re-anchor when drifted this far (m)


class VoxelMapState(NamedTuple):
    table: VoxelTable
    anchor_t_last: torch.Tensor  # (4, 4) anchor <- last registered frame
    frame: torch.Tensor          # () int32 insert clock


def init_voxel_map(cfg: VoxelTableMapConfig, device) -> VoxelMapState:
    return VoxelMapState(table=init_table(int(cfg.table_slots), device),
                         anchor_t_last=torch.eye(4, dtype=torch.float32, device=device),
                         frame=torch.zeros((), dtype=torch.int32, device=device))


def voxel_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> VoxelMapState:
    """Map state from numpy arrays keyed by field name, the table's fields
    under "table" (e.g. the JAX package's state with the table as
    ``VoxelTable._asdict()``, fetched to the host); the uint32 keys become
    int64."""
    tab = arrays["table"]
    dtypes = {"meta": torch.int32, "key": torch.int64}
    table = VoxelTable(*[torch.tensor(np.asarray(tab[name]).astype(np.int64)
                                      if name == "key" else np.asarray(tab[name]),
                                      dtype=dtypes.get(name, torch.float32),
                                      device=device)
                         for name in VoxelTable._fields])
    return VoxelMapState(
        table=table,
        anchor_t_last=torch.tensor(np.asarray(arrays["anchor_t_last"]),
                                   dtype=torch.float32, device=device),
        frame=torch.tensor(np.asarray(arrays["frame"]), dtype=torch.int32,
                           device=device))


def make_voxel_icp_frame_step(proj: projection.SphericalProjection,
                              map_cfg: VoxelTableMapConfig,
                              max_num_alignments: int,
                              threshold_delta_pose: float,
                              threshold_trans: float,
                              threshold_rot: float,
                              gn_scheme: str,
                              gn_sigma: float,
                              gn_eps: float = 1.0e-4,
                              upload_quantization: float = 0.0,
                              reassoc_every: int = 1,
                              reassoc_motion_m: float = 0.0):
    """Builds (step, first_frame, batch_step) for the voxel-table odometry,
    with the surfel map's contract (``ICPFrameToModel`` drives both)."""
    k_live = int(map_cfg.local_map_size)
    vox = float(map_cfg.map_voxel)
    max_nd = float(map_cfg.max_neighbor_dist)
    m_targets = int(map_cfg.target_samples)
    n_knn = int(map_cfg.num_neighbors_normals)
    reanchor_d = float(map_cfg.reanchor_dist)
    reassoc_every = max(int(reassoc_every or 1), 1)

    def research(table: VoxelTable, frame: torch.Tensor, moved: torch.Tensor):
        slot, sq = table_nn(table, moved, frame, k_live, vox, max_nd)
        # a miss gets zero point and normal, so held-pair reuse can never
        # resurrect it through the gate
        found = torch.isfinite(sq)[:, None]
        zero = torch.zeros_like(moved)
        return (torch.where(found, table.points[slot], zero),
                torch.where(found, table.normals[slot], zero), sq)

    def register(state: VoxelMapState, targets: torch.Tensor,
                 t_valid: torch.Tensor, q_init: torch.Tensor):
        """ICP in anchor coordinates: optimizes q = anchor <- sensor.
        Returns (q, iterations run, loss, matches) as device tensors."""
        table, frame = state.table, state.frame
        dev, dt = targets.device, targets.dtype
        q, q_assoc = q_init, q_init
        ref = torch.zeros_like(targets)
        nrm = torch.zeros_like(targets)
        delta_norm = torch.full((), math.inf, dtype=dt, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        loss = torch.zeros((), dtype=dt, device=dev)
        matches = torch.zeros((), dtype=torch.int32, device=dev)
        for trip in range(max_num_alignments):
            # The JAX loop's condition; once false every carry stays frozen.
            # While it holds, the JAX iteration counter equals `trip`.
            active = delta_norm >= threshold_delta_pose
            moved = se3.apply_transformation(targets, q)
            if trip % reassoc_every == 0:
                ref_k, nrm_k, sq_k = research(table, frame, moved)
                q_assoc_k = q
            else:
                e = moved - ref
                sq_reuse = torch.sum(e * e, dim=-1)
                if reassoc_motion_m > 0.0:
                    # motion gate: the held pairs go stale with the pose
                    d_pre = q @ se3.inverse_pose_matrix(q_assoc)
                    do_research = se3.pose_motion_magnitude(d_pre) > reassoc_motion_m
                    f_ref, f_nrm, f_sq = research(table, frame, moved)
                    ref_k = torch.where(do_research, f_ref, ref)
                    nrm_k = torch.where(do_research, f_nrm, nrm)
                    sq_k = torch.where(do_research, f_sq, sq_reuse)
                    q_assoc_k = torch.where(do_research, q, q_assoc)
                else:
                    ref_k, nrm_k, sq_k, q_assoc_k = ref, nrm, sq_reuse, q_assoc

            ok = t_valid & (sq_k < max_nd * max_nd) & \
                (torch.amax(torch.abs(nrm_k), dim=-1) > 0)
            res, jac = point_to_plane_at_identity(moved, ref_k, nrm_k, ok)
            weights = robust_weights(gn_scheme, res, gn_sigma, sq_dists=sq_k,
                                     eps=gn_eps)
            weights = torch.where(ok, weights, torch.zeros_like(weights))
            dx, loss_k, singular = gauss_newton_step(res, jac, weights, damping=0.0)
            dn = torch.linalg.vector_norm(dx)
            apply = (dn >= threshold_delta_pose) & (~singular)
            new_q = se3.normalize_pose_matrix(
                (se3.build_pose_matrix(dx[None])[0] @ q)[None])[0]
            q_out = torch.where(apply, new_q, q)

            q = torch.where(active, q_out, q)
            ref = torch.where(active, ref_k, ref)
            nrm = torch.where(active, nrm_k, nrm)
            q_assoc = torch.where(active, q_assoc_k, q_assoc)
            delta_norm = torch.where(active, dn, delta_norm)
            it = it + active.to(torch.int32)
            loss = torch.where(active, loss_k, loss)
            matches = torch.where(active, ok.sum().to(torch.int32), matches)
        return q, it, loss, matches

    def insert(state: VoxelMapState, sel_anchor: torch.Tensor,
               sel_valid: torch.Tensor) -> VoxelTable:
        """Claims slots for the selected anchor-frame points and fits k-NN
        plane normals for the winners over the table (the new points
        included).  A degenerate fit stays zero, and the ICP gate skips such
        surfels until enough neighbours accumulate."""
        table, won, won_slot = table_insert(state.table, sel_anchor, sel_valid,
                                            state.frame, k_live, vox)
        slots_k, sq_k = table_knn(table, sel_anchor, state.frame, k_live, vox,
                                  max_nd, n_knn)
        nrm = geometry.knn_plane_normals(table.points[slots_k], torch.isfinite(sq_k))
        return table_set_normals(table, won, won_slot, nrm)

    def step(state: VoxelMapState, delta_since_update: torch.Tensor,
             points: torch.Tensor, mask: torch.Tensor, init_rpose: torch.Tensor):
        """Full frame: register + thresholded insert + re-anchor.  Returns
        (state', delta', rpose, pose_params, (loss, iters, matches, inserted))."""
        points, mask, _ = dequant_upload(points, mask, proj, upload_quantization)
        targets, _, t_valid = scatter_select(points, mask, vox, m_targets,
                                             salt=state.frame)
        q_init = state.anchor_t_last @ init_rpose
        q_final, it, loss, matches = register(state, targets, t_valid, q_init)
        t_final = se3.inverse_pose_matrix(state.anchor_t_last) @ q_final

        do_insert, delta_out = insert_rule(delta_since_update, t_final,
                                           threshold_trans, threshold_rot)

        # Both branches of each JAX lax.cond, selected on the device.
        sel_anchor = se3.apply_transformation(targets, q_final)
        inserted = VoxelMapState(table=insert(state, sel_anchor, t_valid),
                                 anchor_t_last=q_final, frame=state.frame + 1)
        state = select_state(do_insert, inserted, state._replace(anchor_t_last=q_final))

        # Re-anchor to the current frame when the pose drifted too far for
        # comfortable float32 coordinates.
        far = torch.linalg.vector_norm(state.anchor_t_last[:3, 3]) > reanchor_d
        moved_anchor = state._replace(
            table=table_reanchor(state.table,
                                 se3.inverse_pose_matrix(state.anchor_t_last), vox),
            anchor_t_last=torch.eye(4, dtype=torch.float32, device=q_final.device))
        state = select_state(far, moved_anchor, state)
        pose_params = se3.from_pose_matrix(t_final[None])[0]
        return state, delta_out, t_final, pose_params, (loss, it, matches, do_insert)

    def first_frame(state: VoxelMapState, points: torch.Tensor,
                    mask: torch.Tensor) -> VoxelMapState:
        points, mask, _ = dequant_upload(points, mask, proj, upload_quantization)
        sel, _, sel_valid = scatter_select(points, mask, vox, m_targets,
                                           salt=state.frame)
        return state._replace(table=insert(state, sel, sel_valid),
                              frame=state.frame + 1)

    return step, first_frame, make_batch_step(step)


def voxel_local_map(config, proj: projection.SphericalProjection, map_dict: dict,
                    gn, alignment: dict) -> LocalMap:
    """The voxel map's record.  Its step is not declared graph-safe: it
    steps eagerly."""
    cfg = dataclass_from_dict(VoxelTableMapConfig, map_dict)
    step, first_frame, batch_step = make_voxel_icp_frame_step(
        proj=proj, map_cfg=cfg, reassoc_every=int(config.reassoc_every or 1),
        **icp_args(config, gn))
    return LocalMap(cfg, lambda device: init_voxel_map(cfg, device), step, first_frame,
                    batch_step, graph_safe=False)
