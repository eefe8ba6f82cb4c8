"""Local-map configs and the projective ring-buffer map (torch port of
``pylidar_slam_tpu.slam.odometry.local_map``).

The projective map is a fixed ring of the last K frames' vertex and normal
maps with their poses in the current frame.  After every frame all K are
re-projected into the current image plane (the "model"), and a target
pixel's neighbour is the closest of the K model vertices at that pixel.
The state is a NamedTuple of device tensors; the insert is both branches of
the JAX ``lax.cond`` computed and selected on the device.

It also holds what every map shares with the odometry: ``LocalMap``, the
record through which ``ICPFrameToModel`` drives a map (each map module
builds its own with a function named after its ``type``), the insert rule
the four steps apply, and the batched loop over a map's step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.ops import geometry, projection, se3


@dataclass
class LocalMapConfig:
    pose: str = "euler"
    type: str = MISSING


def select_state(cond: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    """Per-field torch.where(cond, a, b) of two map states (NamedTuples of
    tensors, nested ones included), for a scalar bool tensor: both branches
    of a JAX ``lax.cond``, selected on the device."""
    return type(a)(*[select_state(cond, x, y) if isinstance(x, tuple)
                     else torch.where(cond, x, y) for x, y in zip(a, b)])


class LocalMap(NamedTuple):
    """A local map as ``ICPFrameToModel`` drives it."""
    config: Any  # the map's config (local_map_size and its own fields)
    init_state: Callable  # device -> the empty map state
    step: Callable
    first_frame: Callable
    batch_step: Optional[Callable]  # None where the map steps one frame a call
    # the step may be captured in a CUDA graph: fixed shapes, no host read
    graph_safe: bool
    # state -> the (H, W) model image ``viz_debug`` shows, or None
    model_image: Optional[Callable] = None
    # the projective map's rasterizer of a device cloud into the vertex map
    # its step takes; None for a map that steps host upload buffers
    vertex_map: Optional[Callable] = None

    @property
    def uploads(self) -> bool:
        """The map steps host upload buffers (every map but the projective
        one, which steps vertex maps)."""
        return self.vertex_map is None


def icp_args(config, gn) -> dict:
    """The step makers' arguments that the odometry's config and its
    Gauss-Newton config give each map that steps uploads."""
    return dict(max_num_alignments=int(config.max_num_alignments),
                threshold_delta_pose=float(config.threshold_delta_pose),
                threshold_trans=float(config.threshold_trans),
                threshold_rot=float(config.threshold_rot),
                reassoc_motion_m=float(config.reassoc_motion_m or 0.0),
                gn_scheme=gn.scheme, gn_sigma=float(gn.sigma), gn_eps=float(gn.eps),
                upload_quantization=float(config.upload_quantization or 0.0))


def insert_rule(delta_since_update: torch.Tensor, rpose: torch.Tensor,
                threshold_trans: float, threshold_rot: float):
    """The maps' insert rule: the frame goes into the map when the motion
    since the last insert, this frame's `rpose` included, passes the
    translation (m) or rotation (deg) threshold, and that motion restarts
    from the identity.  Returns (insert, a device bool; the motion after
    this frame)."""
    new_delta = delta_since_update @ rpose
    d_params = se3.from_pose_matrix(new_delta[None])[0]
    insert = (torch.linalg.vector_norm(d_params[:3]) > threshold_trans) | \
        (torch.linalg.vector_norm(d_params[3:]) * 180.0 / math.pi > threshold_rot)
    eye = torch.eye(4, dtype=new_delta.dtype, device=new_delta.device)
    return insert, torch.where(insert, eye, new_delta)


def make_batch_step(step):
    """``batch_step(state, delta_since_update, last_rpose, points_batch,
    masks_batch)`` of a map's per-frame `step`: the B frames in order, frame
    i's constant-velocity prior frame i-1's relative pose, chained on the
    device.  Returns (state', delta', last_rpose', params (B, 6),
    diagnostics (loss, iters, matches, inserted), each (B,))."""

    def batch_step(state, delta_since_update: torch.Tensor, last_rpose: torch.Tensor,
                   points_batch: torch.Tensor, masks_batch: torch.Tensor):
        params, diags = [], []
        delta, rpose = delta_since_update, last_rpose
        for i in range(points_batch.shape[0]):
            state, delta, rpose, p, diag = step(state, delta, points_batch[i],
                                                masks_batch[i], rpose)
            params.append(p)
            diags.append(diag)
        stacked = tuple(torch.stack(d) for d in zip(*diags))
        return state, delta, rpose, torch.stack(params), stacked

    return batch_step


@dataclass
class ProjectiveLocalMapConfig(LocalMapConfig):
    type: str = "projective_local_map"
    local_map_size: int = 20
    normals_kernel_size: int = 5


class ProjectiveMapState(NamedTuple):
    """Ring buffer of the last <= K frames (float32, channels-last).

    ``poses[k]`` maps stored-frame-k coordinates into the current frame and
    is re-expressed (left-multiplied by inv(new_rpose)) at every update."""
    vmaps: torch.Tensor  # (K, H, W, 3) vertex maps in their own sensor frame
    nmaps: torch.Tensor  # (K, H, W, 3) normal maps in their own sensor frame
    poses: torch.Tensor  # (K, 4, 4) stored frame -> current frame
    count: torch.Tensor  # () int32 valid frames
    write_idx: torch.Tensor  # () int32 next ring slot
    model_vmaps: torch.Tensor  # (K, H, W, 3) re-projected model vertex maps
    model_nmaps: torch.Tensor  # (K, H, W, 3) re-projected model normal maps


def init_projective_map(k: int, h: int, w: int, device,
                        dtype=torch.float32) -> ProjectiveMapState:
    def zeros():
        return torch.zeros((k, h, w, 3), dtype=dtype, device=device)

    return ProjectiveMapState(
        vmaps=zeros(), nmaps=zeros(),
        poses=torch.eye(4, dtype=dtype, device=device).repeat(k, 1, 1),
        count=torch.zeros((), dtype=torch.int32, device=device),
        write_idx=torch.zeros((), dtype=torch.int32, device=device),
        model_vmaps=zeros(), model_nmaps=zeros())


def projective_state_from_numpy(arrays: Dict[str, np.ndarray],
                                device) -> ProjectiveMapState:
    """Map state from numpy arrays keyed by field name (e.g. the JAX
    package's ``ProjectiveMapState._asdict()`` fetched to the host)."""
    ints = ("count", "write_idx")
    return ProjectiveMapState(*[
        torch.tensor(np.asarray(arrays[name]),
                     dtype=torch.int32 if name in ints else torch.float32,
                     device=device)
        for name in ProjectiveMapState._fields])


def projective_state_to_numpy(state: ProjectiveMapState) -> Dict[str, np.ndarray]:
    return {name: t.detach().cpu().numpy()
            for name, t in zip(ProjectiveMapState._fields, state)}


def build_model(state: ProjectiveMapState,
                proj: projection.SphericalProjection) -> ProjectiveMapState:
    """Re-projects every stored frame into the current frame's image plane:
    each stored cloud and its normals go through the frame's pose and are
    rasterized together, all K maps in one batched scatter."""
    k, h, w, _ = state.vmaps.shape
    slot_valid = torch.arange(k, device=state.count.device) < state.count
    pts = state.vmaps.reshape(k, h * w, 3)
    nrm = state.nmaps.reshape(k, h * w, 3)
    mask = (torch.amax(torch.abs(pts), dim=-1) > 0) & slot_valid[:, None]
    tpts = se3.apply_transformation(pts, state.poses)
    tnrm = se3.apply_rotation(nrm, state.poses)
    img = projection.build_vertex_map(tpts, proj, mask=mask,
                                      channels=torch.cat([tpts, tnrm], dim=-1))
    return state._replace(model_vmaps=img[..., :3].contiguous(),
                          model_nmaps=img[..., 3:].contiguous())


def update_projective_map(state: ProjectiveMapState, new_rpose: torch.Tensor,
                          new_vmap: torch.Tensor,
                          proj: projection.SphericalProjection,
                          insert: torch.Tensor,
                          normals_kernel_size: int = 5) -> ProjectiveMapState:
    """Per-frame map update: re-expresses the stored poses in the new frame,
    inserts the new (H, W, 3) vertex map into the ring when `insert` (a
    device bool) holds, and rebuilds the model."""
    k = state.vmaps.shape[0]
    inv = se3.inverse_pose_matrix(new_rpose)
    shifted = torch.einsum("ij,kjl->kil", inv, state.poses)
    slot = state.write_idx.reshape(1).to(torch.int64)
    nmap = geometry.compute_normal_map(new_vmap, normals_kernel_size)
    eye = torch.eye(4, dtype=shifted.dtype, device=shifted.device)
    inserted = state._replace(
        vmaps=state.vmaps.index_copy(0, slot, new_vmap[None]),
        nmaps=state.nmaps.index_copy(0, slot, nmap[None]),
        poses=shifted.index_copy(0, slot, eye[None]),
        count=torch.clamp(state.count + 1, max=k),
        write_idx=(state.write_idx + 1) % k)
    state = select_state(insert, inserted, state._replace(poses=shifted))
    return build_model(state, proj)


def nearest_neighbors(state: ProjectiveMapState,
                      target_vmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projective NN search: (H, W, 3) target -> (neighbors, normals)."""
    return geometry.compute_neighbors(target_vmap, state.model_vmaps,
                                      state.model_nmaps)


def projective_local_map(config, proj: projection.SphericalProjection, map_dict: dict,
                         gn, alignment: dict) -> LocalMap:
    """The projective map's record.  Its step maker is
    ``icp_odometry.make_icp_frame_step``, where the JAX package has it; the
    step takes a vertex map and steps one frame a call."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import make_icp_frame_step
    cfg = dataclass_from_dict(ProjectiveLocalMapConfig, map_dict)
    step, first_frame, build_vmap = make_icp_frame_step(
        proj=proj,
        max_num_alignments=int(config.max_num_alignments),
        threshold_delta_pose=float(config.threshold_delta_pose),
        threshold_trans=float(config.threshold_trans),
        threshold_rot=float(config.threshold_rot),
        gn=gn,
        normals_kernel_size=int(cfg.normals_kernel_size))
    k, h, w = int(cfg.local_map_size), proj.height, proj.width
    return LocalMap(cfg, lambda device: init_projective_map(k, h, w, device), step,
                    first_frame, batch_step=None, graph_safe=False,
                    model_image=lambda st: torch.linalg.vector_norm(st.vmaps[0], dim=-1),
                    vertex_map=build_vmap)
