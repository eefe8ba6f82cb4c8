"""Local-map configs and the projective ring-buffer map (torch port of
``pylidar_slam_tpu.slam.odometry.local_map``).

The projective map is a fixed ring of the last K frames' vertex and normal
maps with their poses in the current frame.  After every frame all K are
re-projected into the current image plane (the "model"), and a target
pixel's neighbour is the closest of the K model vertices at that pixel.
The state is a NamedTuple of device tensors; the insert is both branches of
the JAX ``lax.cond`` computed and selected on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING
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
