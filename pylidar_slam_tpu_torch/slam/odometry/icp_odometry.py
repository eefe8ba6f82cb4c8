"""Frame-to-Model ICP odometry (torch port of
``pylidar_slam_tpu.slam.odometry.icp_odometry``), in the aggregated-map and
surfel ("kdtree_local_map") modes.

The host wrapper keeps the reference's ``data_dict`` key contract
(``init_rpose`` in, ``odometry_pose`` / ``odometry_pc`` out).  Frames are
encoded on the host (rimg8 range image or scrubbed float32 cloud); in
batched mode a whole batch is stacked, uploaded from pinned memory in one
non-blocking copy and run through ``batch_step``, with the
constant-velocity prior chained on the device.  Poses stay on the device
until ``get_relative_poses`` fetches the whole log at once; when a
downstream stage needs them per frame (``emit_batch_poses``), each batch's
params are copied to pinned host memory behind a CUDA event and
``drain_batch_results`` hands over the batches whose copy has landed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.ops import bev, projection
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
from pylidar_slam_tpu_torch.utils import assert_debug
from pylidar_slam_tpu_torch.utils.transfer import copy_to_host_async

# The continuous-time pose surfaces: sweep fraction of each reported pose.
_POSE_FRACTIONS = {"mid_pose": 0.5, "end_pose": 1.0}
POSE_TYPES = ("", "begin_pose") + tuple(_POSE_FRACTIONS)
# Local maps still to port, with their ROADMAP.md items.
_UNPORTED_MAPS = {"voxel_local_map": "A.11", "projective_local_map": "A.12"}


# ----------------------------------------------------------------------------
# Configs (the JAX package's field names and defaults)
# ----------------------------------------------------------------------------

@dataclass
class OdometryConfig:
    algorithm: str = MISSING


@dataclass
class GaussNewtonConfig:
    max_iters: int = 1
    norm_stop_criterion: float = 1.0e-3
    scheme: str = "geman_mcclure"
    sigma: float = 0.3
    eps: float = 1.0e-4
    # Robust-kernel annealing: the first ICP iteration runs at `sigma_start`,
    # shrinking geometrically to `sigma` over `sigma_anneal_iters` (0/0
    # disables).  A wide kernel early restores the capture basin of narrow
    # kernels under large initialization error.
    sigma_start: float = 0.0
    sigma_anneal_iters: int = 0
    # Gate on the point-to-plane residual in meters (0 disables).
    max_dist_to_plane: float = 0.0
    # CT-ICP pose priors: quadratic pulls of the GN solve toward the
    # constant-velocity prior (translation, rotation, both) and toward zero
    # motion, scaled by the match count (0 disables each).
    beta_location_consistency: float = 0.0
    beta_constant_velocity: float = 0.0
    beta_small_velocity: float = 0.0
    beta_orientation_consistency: float = 0.0


@dataclass
class ICPFrameToModelConfig(OdometryConfig):
    """Point-to-plane frame-to-model ICP configuration (field names and
    defaults of the JAX package, so configs carry over unchanged; options
    the port does not run raise when set)."""
    algorithm: str = "icp_F2M"
    device: str = "cuda"
    pose: str = "euler"
    max_num_alignments: int = 100

    local_map: Any = None
    alignment: Any = None

    threshold_delta_pose: float = 1.0e-4
    threshold_trans: float = 0.1
    threshold_rot: float = 0.3
    sigma: float = 0.1

    data_key: str = "vertex_map"
    viz_debug: bool = False

    # EI (elevation-image) bootstrap of the first motion estimate: frame 1
    # is aligned to frame 0 by BEV phase correlation and the result replaces
    # the identity constant-velocity prior, which cannot capture motion
    # beyond the correspondence gate at sequence start.
    ei_bootstrap: bool = True
    ei_bootstrap_size: int = 128  # BEV image side (pixels)
    ei_bootstrap_pixel: float = 0.5  # meters/pixel: +-32 m capture basin
    ei_bootstrap_yaw_steps: int = 64
    ei_bootstrap_yaw_range: float = 1.0472  # +-60 deg sweep
    # A weaker phase-correlation peak keeps the identity prior.
    ei_bootstrap_min_score: float = 0.05

    # Continuous-time pose surface (elastic mode): which per-frame pose
    # get_relative_poses reports.  "mid_pose" / "end_pose" sample scan k at
    # half / all of its frame-to-frame motion; "" or "begin_pose" keeps the
    # scan-start pose.
    pose_type: str = ""

    # Point capacity of a frame on the device (uploads are zero-padded to it).
    num_points_padded: int = 131072
    # Re-rasterize the target every N ICP iterations ...
    reassoc_every: int = 3
    # ... and whenever the pose moved more than this many meters (translation
    # + rotation at a 15 m lever arm) since the last rasterization (0 = off).
    reassoc_motion_m: float = 0.0
    upload_quantization: float = 0.0
    upload_dither: bool = False
    # "f32" (12 B/point) or "rimg8" (2 B/pixel z-buffered range image +
    # per-row/per-col angular offset planes, exact on regular firing
    # patterns; needs num_points_padded >= H*W + (H+W+1)//2).
    upload_format: str = "f32"
    # Frames per batched device run; B > 1 chains the constant-velocity
    # priors on the device.
    batch_size: int = 1
    # Accepted so configs carry over.  shard_points > 1 raises (ROADMAP.md
    # A.13).  The port uploads from pinned memory without an uploader
    # thread and keeps no fetch lag, so the other two change nothing.
    shard_points: int = 0
    async_upload: bool = True
    batch_results_lag: int = 4


# ----------------------------------------------------------------------------
# Host-side odometry module (data_dict protocol)
# ----------------------------------------------------------------------------

class ICPFrameToModel:
    """Host wrapper driving the per-frame / batched device step.

    Input under ``config.data_key``: an (N, 3+) point cloud (numpy or a CPU
    tensor).
    """

    _UPLOAD_BUCKET = 16384

    def __init__(self, config: ICPFrameToModelConfig,
                 projector: projection.SphericalProjection = None,
                 device=None, **kwargs):
        if not isinstance(config, ICPFrameToModelConfig):
            config = dataclass_from_dict(ICPFrameToModelConfig, config)
        self.config = config
        assert_debug(projector is not None, "ICP odometry requires a projector")
        self.projector = projector
        self.device = torch.device(config.device if device is None else device)

        lm_dict = config.local_map if isinstance(config.local_map, dict) else {}
        mode = lm_dict.get("type", "projective_local_map")
        if mode in _UNPORTED_MAPS:
            raise NotImplementedError(
                f"local_map.type='{mode}' is not ported yet: ROADMAP.md "
                f"{_UNPORTED_MAPS[mode]}")
        assert_debug(mode in ("aggregated_local_map", "kdtree_local_map"),
                     f"Unknown local_map type '{mode}'")
        self._mode = mode
        fmt = str(config.upload_format or "f32")
        if fmt not in ("f32", "rimg8"):
            raise NotImplementedError(
                f"upload_format='{fmt}': only rimg8 and f32 are ported "
                f"(ROADMAP.md, 'What the port leaves out')")
        if int(config.shard_points or 0) > 1:
            raise NotImplementedError(
                "shard_points is not ported yet: ROADMAP.md A.13")
        assert_debug(str(config.pose_type or "") in POSE_TYPES,
                     f"Unknown pose_type '{config.pose_type}'")
        if bool(config.viz_debug):
            raise NotImplementedError("viz_debug is ROADMAP.md A.19")
        align_cfg = config.alignment if isinstance(config.alignment, dict) else {}
        gn_cfg = dataclass_from_dict(
            GaussNewtonConfig, align_cfg.get("gauss_newton_config", {}))
        self._elastic = bool(align_cfg.get("elastic", False))

        if mode == "kdtree_local_map":
            self._surfel_cfg = dataclass_from_dict(sm.SurfelRingMapConfig, lm_dict)
            self.local_map_size = int(self._surfel_cfg.local_map_size)
            self._step, self._first, self._batch_step = \
                sm.make_surfel_icp_frame_step(
                    proj=projector,
                    map_cfg=self._surfel_cfg,
                    reassoc_every=int(config.reassoc_every or 1),
                    reassoc_motion_m=float(config.reassoc_motion_m or 0.0),
                    max_num_alignments=int(config.max_num_alignments),
                    threshold_delta_pose=float(config.threshold_delta_pose),
                    threshold_trans=float(config.threshold_trans),
                    threshold_rot=float(config.threshold_rot),
                    gn_scheme=gn_cfg.scheme,
                    gn_sigma=float(gn_cfg.sigma),
                    gn_eps=float(gn_cfg.eps),
                    upload_quantization=float(config.upload_quantization or 0.0))
        else:
            agg_cfg = dataclass_from_dict(am.AggregatedLocalMapConfig, lm_dict)
            self.local_map_size = int(agg_cfg.local_map_size)
            self._step, self._first, self._batch_step = am.make_agg_icp_frame_step(
                proj=projector,
                map_cfg=agg_cfg,
                max_num_alignments=int(config.max_num_alignments),
                reassoc_every=int(config.reassoc_every or 3),
                reassoc_motion_m=float(config.reassoc_motion_m or 0.0),
                threshold_delta_pose=float(config.threshold_delta_pose),
                threshold_trans=float(config.threshold_trans),
                threshold_rot=float(config.threshold_rot),
                gn_scheme=gn_cfg.scheme,
                gn_sigma=float(gn_cfg.sigma),
                gn_eps=float(gn_cfg.eps),
                gn_sigma_start=float(gn_cfg.sigma_start or 0.0),
                gn_sigma_anneal_iters=int(gn_cfg.sigma_anneal_iters or 0),
                max_dist_to_plane=float(gn_cfg.max_dist_to_plane or 0.0),
                beta_location_consistency=float(gn_cfg.beta_location_consistency or 0.0),
                beta_constant_velocity=float(gn_cfg.beta_constant_velocity or 0.0),
                beta_small_velocity=float(gn_cfg.beta_small_velocity or 0.0),
                beta_orientation_consistency=float(
                    gn_cfg.beta_orientation_consistency or 0.0),
                upload_quantization=float(config.upload_quantization or 0.0),
                deskew=bool(align_cfg.get("deskew", False)),
                elastic=self._elastic,
                alignment_mode=str(align_cfg.get("mode", "point_to_plane_gauss_newton")),
            )
        # Batched mode: when True, every flush copies its (B, 6) params to
        # pinned host memory (one transfer per batch, behind a CUDA event)
        # and drain_batch_results hands per-frame float64 relative poses to
        # the downstream stages (loop closure, backend).
        self.emit_batch_poses = False
        self.init()

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        if self._mode == "kdtree_local_map":
            cfg = self._surfel_cfg
            use_hash = str(cfg.nn_backend) == "hash"
            self._map_state = sm.init_surfel_map(
                self.local_map_size, int(cfg.points_per_frame), self.device,
                hash_buckets=int(cfg.hash_buckets) if use_hash else 0,
                hash_capacity=int(cfg.hash_capacity) if use_hash else 0)
        else:
            h, w = self.projector.height, self.projector.width
            self._map_state = am.init_agg_map(h, w, self.device)
        self._delta_since_update = torch.eye(4, dtype=torch.float32,
                                             device=self.device)
        # Device-side pose log: (k, 6) params per flush, fetched once.
        self._params_log: list = []
        self._frame_buffer: list = []  # batched mode: host upload buffers
        self._pending_params: list = []  # ([host params], event or None)
        self._pending_rposes: list = []
        self._iter = 0
        self.last_rpose_device: Optional[torch.Tensor] = None
        self._boot_cloud: Optional[np.ndarray] = None

    # -- EI bootstrap -------------------------------------------------------

    def _boot_cloud_of(self, data_dict: dict, fallback=None) -> Optional[np.ndarray]:
        """Meters (N, 3) host cloud for the EI bootstrap, preferring the raw
        input over (possibly encoded) upload buffers."""
        raw = data_dict.get(self.config.data_key)
        if raw is not None:
            return self._input_cloud(raw)[:, :3].astype(np.float32)
        if isinstance(fallback, np.ndarray) and fallback.dtype == np.float32:
            return fallback[:, :3]
        return None

    def _ei_bootstrap_pose(self, data_dict: dict, fallback=None):
        """BEV phase-correlation alignment of frame 1 to frame 0: a (4, 4)
        float32 device init pose (current frame -> previous frame), or None
        when a cloud is missing or the estimate fails its checks."""
        cur = self._boot_cloud_of(data_dict, fallback)
        prev = self._boot_cloud
        if cur is None or prev is None:
            return None
        cfg = self.config
        size = int(cfg.ei_bootstrap_size)
        px = float(cfg.ei_bootstrap_pixel)

        def image(cloud):
            # Ground suppression is load-bearing: raw single-scan phase
            # correlation locks onto the egocentric ground pattern.
            p = torch.as_tensor(cloud, dtype=torch.float32, device=self.device)
            return bev.build_elevation_image(p, bev.ground_suppressed_mask(p),
                                             px, size)

        res = bev.register_bev(image(prev), image(cur),
                               num_yaw_steps=int(cfg.ei_bootstrap_yaw_steps),
                               yaw_range=float(cfg.ei_bootstrap_yaw_range))
        mat = bev.bev_transform_to_se3(res, px)
        # The one host sync of the bootstrap (the JAX code has it too).
        score, tx, ty = torch.stack([res.score, mat[0, 3], mat[1, 3]]).tolist()
        # A weak correlation peak carries no usable structure; a shift beyond
        # 80% of the correlation half-extent is aliasing territory.
        if score < float(cfg.ei_bootstrap_min_score) or \
                float(np.hypot(tx, ty)) > 0.4 * size * px:
            return None
        return mat

    def _maybe_bootstrap(self, data_dict: dict, init_pose: torch.Tensor,
                         fallback=None):
        """Swaps an uninformative (identity) frame-1 init for the EI
        estimate; a caller-supplied real prior wins."""
        if self._iter != 1 or not bool(self.config.ei_bootstrap) \
                or self._boot_cloud is None:
            return init_pose
        eye = torch.eye(4, dtype=init_pose.dtype, device=init_pose.device)
        # frame 1 only: this reads the prior back to the host
        informative = float(torch.abs(init_pose - eye).max()) > 1e-5
        boot = None if informative else self._ei_bootstrap_pose(data_dict, fallback)
        self._boot_cloud = None
        return init_pose if boot is None else boot

    # -- uploads ------------------------------------------------------------

    def _compact_host_buffer(self, arr: np.ndarray) -> np.ndarray:
        """Encodes a raw scan into the host upload buffer: the rimg8 range
        image, or the NaN-scrubbed float32 cloud bucketed to a multiple of
        16384 rows (zero-padded to capacity on the device)."""
        cap = self.config.num_points_padded
        if str(self.config.upload_format or "f32") == "rimg8":
            h, w = self.projector.height, self.projector.width
            need = h * w + (h + w + 1) // 2
            assert_debug(cap >= need, f"rimg8 upload needs num_points_padded "
                                      f">= {need} (got {cap})")
            return projection.np_encode_range_image(arr[:, :3], self.projector)
        pts = arr[:, :3].astype(np.float32)
        nan_rows = np.isnan(pts).any(axis=1)
        if nan_rows.any():
            pts = pts[~nan_rows]
        if pts.shape[0] > cap:
            # Spatially uniform overflow drop (a stride over scan order is
            # azimuth-uniform; head truncation would keep the top rows only).
            pts = pts[:: -(-pts.shape[0] // cap)][:cap]
        n = min(pts.shape[0], cap)
        bucket = min(cap, max(self._UPLOAD_BUCKET,
                              -(-n // self._UPLOAD_BUCKET) * self._UPLOAD_BUCKET))
        buf = np.zeros((bucket, 3), np.float32)
        buf[:n] = pts[:n]
        return buf

    def encode_upload(self, arr: np.ndarray) -> np.ndarray:
        """Host-side upload encoding, safe to call from prefetch workers;
        store the result under ``data_dict["encoded_upload"]``."""
        return self._compact_host_buffer(np.asarray(arr))

    def _upload(self, stacked: np.ndarray) -> torch.Tensor:
        """(B, rows, C) host buffers -> (B, capacity, C) on the device: one
        non-blocking copy from pinned memory, zero padding on the device."""
        host = torch.from_numpy(np.ascontiguousarray(stacked))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        b, rows, cols = dev.shape
        cap = self.config.num_points_padded
        if rows < cap:
            dev = torch.cat([dev, dev.new_zeros((b, cap - rows, cols))], dim=1)
        return dev

    def _ones_mask(self, *lead) -> torch.Tensor:
        return torch.ones(lead + (self.config.num_points_padded,),
                          dtype=torch.bool, device=self.device)

    def _input_cloud(self, data) -> np.ndarray:
        """The frame's (N, 3+) host point cloud."""
        arr = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        if arr.ndim != 2 or arr.shape[1] < 3:
            raise NotImplementedError(
                f"input of shape {arr.shape}: only (N, 3+) point clouds are "
                f"ported; vertex-map inputs are ROADMAP.md A.13")
        return arr

    def _read_points(self, data_dict: dict):
        """Reads the input as a padded (N, 3) device cloud + validity mask."""
        key = self.config.data_key
        assert_debug(key in data_dict,
                     f"Could not find the key `{key}` in the input dictionary "
                     f"(keys: {list(data_dict.keys())}).")
        buf = self._compact_host_buffer(self._input_cloud(data_dict[key]))
        return self._upload(buf[None])[0], self._ones_mask()

    @staticmethod
    def pointcloud_key() -> str:
        return "odometry_pc"

    @staticmethod
    def relative_pose_key() -> str:
        return "odometry_pose"

    # -- main ---------------------------------------------------------------

    def process_next_frame(self, data_dict: dict):
        if int(self.config.batch_size or 1) > 1 and self._iter > 0:
            return self._buffer_frame(data_dict)

        points, mask = self._read_points(data_dict)
        if self._iter == 0:
            self._map_state = self._first(self._map_state, points, mask)
            self.last_rpose_device = torch.eye(4, dtype=torch.float32,
                                               device=self.device)
            self._params_log.append(torch.zeros((1, 6), dtype=torch.float32,
                                                device=self.device))
            self._iter += 1
            data_dict[self.relative_pose_key()] = self.last_rpose_device
            if bool(self.config.ei_bootstrap):
                self._boot_cloud = self._boot_cloud_of(data_dict)
            return

        # The caller's prior (e.g. the previous frame's pose, still on the
        # device) is used as it is: no host round trip per frame.
        init = data_dict.get("init_rpose", None)
        init_pose = torch.eye(4, dtype=torch.float32, device=self.device) \
            if init is None else torch.as_tensor(init, dtype=torch.float32,
                                                 device=self.device)
        init_pose = self._maybe_bootstrap(data_dict, init_pose)

        (self._map_state, self._delta_since_update, rpose, pose_params,
         _diag) = self._step(self._map_state, self._delta_since_update,
                             points, mask, init_pose)
        self.last_rpose_device = rpose
        self._params_log.append(pose_params[None])
        data_dict[self.relative_pose_key()] = rpose
        data_dict[self.pointcloud_key()] = \
            self._input_cloud(data_dict[self.config.data_key])[:, :3]
        self._iter += 1

    def _buffer_frame(self, data_dict: dict):
        """Batched path: keeps the frame as a host upload buffer; the whole
        batch crosses to the device as one stacked copy at flush."""
        arr = self._input_cloud(data_dict[self.config.data_key])
        # A prefetch worker may already have run encode_upload() off this
        # thread.
        entry = data_dict.get("encoded_upload")
        if entry is None:
            entry = self._compact_host_buffer(arr)
        # Downstream consumers need METERS, not an encoded buffer.
        pc_out = entry if entry.dtype == np.float32 else arr[:, :3]
        if self._iter == 1 and bool(self.config.ei_bootstrap) and \
                self._boot_cloud is not None:
            # The CV chain starts from last_rpose_device (identity after
            # frame 0); the BEV estimate makes frame 1's init real.
            boot = self._ei_bootstrap_pose(data_dict, fallback=pc_out)
            if boot is not None:
                self.last_rpose_device = boot
            self._boot_cloud = None
        self._frame_buffer.append(entry)
        self._iter += 1
        data_dict[self.pointcloud_key()] = pc_out
        if len(self._frame_buffer) >= int(self.config.batch_size):
            self._flush_batch()

    def _stack(self, bufs: list) -> np.ndarray:
        rows = max(b.shape[0] for b in bufs)
        stacked = np.zeros((len(bufs), rows, bufs[0].shape[1]), bufs[0].dtype)
        for i, b in enumerate(bufs):
            stacked[i, :b.shape[0]] = b
        return stacked

    def _flush_batch(self):
        """Runs the buffered frames through one batched device run."""
        if not self._frame_buffer:
            return
        bufs = self._frame_buffer
        self._frame_buffer = []
        pts = self._upload(self._stack(bufs))
        msks = self._ones_mask(len(bufs))
        (self._map_state, self._delta_since_update, self.last_rpose_device,
         params, _diags) = self._batch_step(
            self._map_state, self._delta_since_update,
            self.last_rpose_device, pts, msks)
        self._params_log.append(params)
        if self.emit_batch_poses:
            self._pending_params.append(copy_to_host_async(params))

    def _flush_remainder(self):
        """Processes a final partial buffer with the per-frame step."""
        # the flushed batches' poses come first in the pose stream
        self._collect_params(wait=True)
        for buf in self._frame_buffer:
            points, mask = self._upload(buf[None])[0], self._ones_mask()
            (self._map_state, self._delta_since_update, rpose, pose_params,
             _diag) = self._step(self._map_state, self._delta_since_update,
                                 points, mask, self.last_rpose_device)
            self.last_rpose_device = rpose
            self._params_log.append(pose_params[None])
            if self.emit_batch_poses:
                self._pending_params.append(copy_to_host_async(pose_params[None]))
        self._frame_buffer = []

    def _collect_params(self, wait: bool):
        """Moves the fetched params of finished flushes, in flush order, to
        the pose stream; `wait` waits for every copy, else it stops at the
        first whose event has not completed."""
        while self._pending_params:
            (host,), event = self._pending_params[0]
            if event is not None:
                if wait:
                    event.synchronize()
                elif not event.query():
                    break
            self._pending_params.pop(0)
            self._pending_rposes.extend(
                _pose_matrix_f64(p) for p in host.numpy().astype(np.float64))

    def drain_batch_results(self, final: bool = False) -> list:
        """Returns (and clears) float64 relative poses for the frames of the
        flushes whose params have reached the host since the last drain
        (batched mode only); `final` flushes the partial batch and waits."""
        if final:
            self.finish()
        self._collect_params(wait=final)
        out = self._pending_rposes
        self._pending_rposes = []
        return out

    def finish(self):
        """Flushes a partially filled batch buffer at sequence end."""
        if self._frame_buffer:
            self._flush_remainder()

    def fetch_params_log(self) -> Optional[np.ndarray]:
        """One device->host fetch of all logged pose params (T, 6), float64."""
        self.finish()
        if not self._params_log:
            return None
        return torch.cat(self._params_log, dim=0).cpu().numpy().astype(np.float64)

    def get_relative_poses(self) -> Optional[np.ndarray]:
        """Float64 relative pose matrices, rebuilt from the float32 params
        the device solved for; in elastic mode on the surface `pose_type`
        selects."""
        params = self.fetch_params_log()
        if params is None:
            return None
        rel = np.stack([_pose_matrix_f64(p) for p in params])
        pose_type = str(self.config.pose_type or "")
        if self._elastic and pose_type in _POSE_FRACTIONS:
            return _ct_relative_poses(rel, _POSE_FRACTIONS[pose_type])
        return rel

    def get_ct_relative_poses(self, pose_type: str = "mid_pose") -> Optional[np.ndarray]:
        """Relative poses between consecutive begin / mid / end scan poses,
        in any mode (rigid modes model the sweep by the frame-to-frame
        estimate as well)."""
        params = self.fetch_params_log()
        if params is None:
            return None
        rel = np.stack([_pose_matrix_f64(p) for p in params])
        if pose_type == "begin_pose":
            return rel
        assert_debug(pose_type in _POSE_FRACTIONS, f"Unknown pose_type '{pose_type}'")
        return _ct_relative_poses(rel, _POSE_FRACTIONS[pose_type])

    @property
    def absolute_poses(self) -> list:
        """Float64 absolute pose ledger (computed from the log)."""
        params = self.fetch_params_log()
        if params is None:
            return []
        out = [np.eye(4)]
        for p in params[1:]:
            out.append(out[-1] @ _pose_matrix_f64(p))
        return out


def _pose_fraction_f64(mat: np.ndarray, frac: float) -> np.ndarray:
    """Geodesic fraction of an SE(3) matrix (float64, host): the rotation's
    axis-angle scaled by `frac`, the translation lerped -- the per-point
    interpolation of the elastic warp (se3.interpolate_pose)."""
    r = mat[:3, :3]
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    ang = float(np.arccos(cos))
    out = np.eye(4)
    if ang < 1e-12:
        out[:3, :3] = np.eye(3) + frac * (r - np.eye(3))
    else:
        axis = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                         r[1, 0] - r[0, 1]]) / (2.0 * np.sin(ang))
        a = ang * frac
        k = np.array([[0.0, -axis[2], axis[1]],
                      [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        out[:3, :3] = np.eye(3) + np.sin(a) * k + (1.0 - np.cos(a)) * (k @ k)
    out[:3, 3] = frac * mat[:3, 3]
    return out


def _ct_relative_poses(rel_begin: np.ndarray, frac: float) -> np.ndarray:
    """Relative poses between consecutive scan poses at sweep fraction
    `frac`: scan k's sweep motion is its frame-to-frame motion rel_begin[k],
    so its pose at `frac` is abs_begin_k @ fraction(rel_begin[k], frac)."""
    out = np.empty_like(rel_begin)
    prev_abs_f = None
    abs_begin = np.eye(4)
    for k in range(rel_begin.shape[0]):
        abs_begin = abs_begin @ rel_begin[k]
        abs_f = abs_begin @ _pose_fraction_f64(rel_begin[k], frac)
        out[k] = np.eye(4) if prev_abs_f is None else np.linalg.solve(prev_abs_f, abs_f)
        prev_abs_f = abs_f
    return out


def _pose_matrix_f64(params: np.ndarray) -> np.ndarray:
    """Float64 euler-xyz pose matrix (host-side, for the absolute ledger)."""
    tx, ty, tz, ex, ey, ez = params
    cx, sx = np.cos(ex), np.sin(ex)
    cy, sy = np.cos(ey), np.sin(ey)
    cz, sz = np.cos(ez), np.sin(ez)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    mat = np.eye(4)
    mat[:3, :3] = rz @ ry @ rx
    mat[:3, 3] = [tx, ty, tz]
    return mat
