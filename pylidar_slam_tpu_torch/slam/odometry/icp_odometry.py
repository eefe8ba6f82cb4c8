"""Frame-to-Model ICP odometry (torch port of
``pylidar_slam_tpu.slam.odometry.icp_odometry``) over its four local maps:
the projective ring buffer (the default), the aggregated map, the surfel
map and the voxel table.  Each is driven through the ``local_map.LocalMap``
record its module builds; ``MAPS`` maps a ``local_map.type`` to the
function that builds it.

The host wrapper keeps the reference's ``data_dict`` key contract
(``init_rpose`` in, ``odometry_pose`` / ``odometry_pc`` out).  The input is
an (N, 3+) point cloud or an (H, W, 3) / (3, H, W) vertex map.  The
projective map rasterizes each frame's cloud into a vertex map on the device
and runs one frame per step.  The other maps take clouds encoded on the host
(rimg8 range image or scrubbed float32 cloud); in batched mode a whole batch
is stacked, uploaded from pinned memory in one non-blocking copy and run
through ``batch_step``, with the constant-velocity prior chained on the
device.  Poses stay on the device until ``get_relative_poses`` fetches the
whole log at once; when a downstream stage needs them per frame
(``emit_batch_poses``), each batch's params are copied to pinned host
memory behind a CUDA event and
``drain_batch_results`` hands over the batches whose copy has landed.

On a CUDA device, a map whose record declares its step graph-safe (the
aggregated map; the surfel map with no process group) has its batched
frames stepped by replays of one CUDA graph of that step (``_FrameGraph``)
from the second batch after ``init()`` on: the same kernels in the same
order, enqueued by one call a frame instead of ~2,000 (~3,800 for the
surfel map).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, dataclass_from_dict
from pylidar_slam_tpu_torch.ops import bev, optimization, projection, se3
from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
from pylidar_slam_tpu_torch.slam.odometry import local_map as lm
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
from pylidar_slam_tpu_torch.slam.odometry import voxel_map as vm
from pylidar_slam_tpu_torch.utils import assert_debug
from pylidar_slam_tpu_torch.utils.timer import add_counts, count, recorded_counts, span
from pylidar_slam_tpu_torch.utils.transfer import copy_to_host_async

# The continuous-time pose surfaces: sweep fraction of each reported pose.
_POSE_FRACTIONS = {"mid_pose": 0.5, "end_pose": 1.0}
POSE_TYPES = ("", "begin_pose") + tuple(_POSE_FRACTIONS)
# local_map.type -> the function that builds the map's LocalMap record (the
# first is the default, as in the JAX package); each calls its module's step
# maker by the module's name for it, at the build
MAPS = {"projective_local_map": lm.projective_local_map,
        "aggregated_local_map": am.aggregated_local_map,
        "kdtree_local_map": sm.kdtree_local_map,
        "voxel_local_map": vm.voxel_local_map}
MAP_TYPES = tuple(MAPS)
UPLOAD_FORMATS = ("f32", "packed", "rimg", "rimg16", "rimg8", "rimg12")


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
    # f32 uploads as int16 steps of this many meters (0 = off); points beyond
    # +-32767 steps are dropped.  `upload_dither` adds uniform noise of one
    # step before rounding, drawn from one generator seeded 0, in frame order.
    upload_quantization: float = 0.0
    upload_dither: bool = False
    # "f32" (12 B/point), "packed" (8 B/point: uint16 pixel id, 2 mm range
    # steps, f16 angular offsets; needs H*W <= 65536, else f32), "rimg" (3
    # B/pixel z-buffered range image with 4+4-bit sub-pixel offsets, the
    # real-sensor codec), "rimg16" (4 B/pixel, 8+8-bit offsets), "rimg8" (2
    # B/pixel + per-row/per-col angular offset planes, exact on regular
    # firing patterns) or "rimg12" (1.5 B/pixel: 12-bit 3 cm ranges + the
    # rimg8 planes).  rimg and rimg16 need num_points_padded >= H*W, rimg8
    # >= H*W + (H+W+1)//2; rimg12 needs it equal to 4x its encoded rows.
    upload_format: str = "f32"
    # Frames per batched device run; B > 1 chains the constant-velocity
    # priors on the device.
    batch_size: int = 1
    # kdtree (surfel) mode: shard the ICP targets over this many ranks of
    # the torch.distributed process group (torchrun); each rank searches its
    # block against the replicated map and the 6x6 normal equations are
    # all-reduced.  0/1 = one rank.  The port uploads from pinned memory
    # without an uploader thread and keeps no fetch lag, so the other two
    # are accepted so configs carry over, and change nothing.
    shard_points: int = 0
    async_upload: bool = True
    batch_results_lag: int = 4


class ICPStepResult(NamedTuple):
    pose_params: torch.Tensor  # (6,)
    pose_matrix: torch.Tensor  # (4, 4)
    loss: torch.Tensor  # () final weighted residual loss
    num_iters: torch.Tensor  # () int32 ICP iterations run
    num_matches: torch.Tensor  # () int32 valid correspondences in the last one
    inserted: torch.Tensor  # () bool: the frame went into the map


def make_icp_frame_step(proj: projection.SphericalProjection,
                        max_num_alignments: int,
                        threshold_delta_pose: float,
                        threshold_trans: float,
                        threshold_rot: float,
                        gn: GaussNewtonConfig,
                        normals_kernel_size: int = 5):
    """Builds the projective map's per-frame step:
    ``step(map_state, delta_since_update, vmap, init_pose)`` ->
    ``(map_state', delta_since_update', ICPStepResult)``, plus
    ``first_frame(map_state, vmap)`` and
    ``build_vmap_from_points(points, mask)``.

    Each ICP trip rasterizes the target at the current pose, associates it
    projectively with the K model maps and runs robust point-to-plane GN
    from zero.  The JAX early-exit loop is `max_num_alignments` fixed trips
    whose carries freeze once the stop condition holds.
    """

    def register(map_state: lm.ProjectiveMapState, vmap: torch.Tensor,
                 init_pose: torch.Tensor):
        tgt_pts = vmap.reshape(-1, 3)
        tgt_valid = torch.amax(torch.abs(tgt_pts), dim=-1) > 0
        dev, dt = vmap.device, vmap.dtype
        zero_params = torch.zeros(6, dtype=dt, device=dev)
        pose = init_pose
        delta_norm = torch.full((), math.inf, dtype=dt, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        loss = torch.zeros((), dtype=dt, device=dev)
        matches = torch.zeros((), dtype=torch.int32, device=dev)
        singular = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(max_num_alignments):
            # The JAX loop's condition; once false every carry stays frozen.
            active = (delta_norm >= threshold_delta_pose) & (~singular)
            pts = se3.apply_transformation(tgt_pts, pose)
            tvmap = projection.build_vertex_map(pts, proj, mask=tgt_valid)
            nbrs, nrms = lm.nearest_neighbors(map_state, tvmap)
            t = tvmap.reshape(-1, 3)
            r = nbrs.reshape(-1, 3)
            n = nrms.reshape(-1, 3)
            mask = (torch.amax(torch.abs(t), dim=-1) > 0) & \
                (torch.amax(torch.abs(r), dim=-1) > 0) & \
                (torch.amax(torch.abs(n), dim=-1) > 0)
            sq_dists = torch.sum((t - r) ** 2, dim=-1)
            # Robust GN on the correspondences from zero params (one step by
            # default, the alignment's gauss_newton_config)
            result = optimization.gauss_newton(
                zero_params,
                lambda p: optimization.point_to_plane_residuals(p, t, r, n, mask),
                lambda p: optimization.point_to_plane_jacobian(p, t, n, mask),
                max_iters=gn.max_iters, norm_stop_criterion=gn.norm_stop_criterion,
                scheme=gn.scheme, sigma=gn.sigma, sq_dists=sq_dists, eps=gn.eps)
            dn = torch.linalg.vector_norm(result.params)
            # A sub-threshold delta is not composed (the reference breaks
            # first).
            apply = (dn >= threshold_delta_pose) & (~result.singular)
            new_pose = se3.normalize_pose_matrix(
                (se3.build_pose_matrix(result.params[None])[0] @ pose)[None])[0]
            pose = torch.where(active & apply, new_pose, pose)
            delta_norm = torch.where(active, dn, delta_norm)
            it = it + active.to(torch.int32)
            loss = torch.where(active, result.loss, loss)
            matches = torch.where(active, mask.sum().to(torch.int32), matches)
            singular = torch.where(active, result.singular, singular)
        return se3.from_pose_matrix(pose[None])[0], pose, loss, it, matches

    def step(map_state: lm.ProjectiveMapState, delta_since_update: torch.Tensor,
             vmap: torch.Tensor, init_pose: torch.Tensor):
        pose_params, pose_mat, loss, it, matches = register(map_state, vmap, init_pose)
        insert, delta_out = lm.insert_rule(delta_since_update, pose_mat,
                                           threshold_trans, threshold_rot)
        map_state = lm.update_projective_map(map_state, pose_mat, vmap, proj, insert,
                                             normals_kernel_size=normals_kernel_size)
        return map_state, delta_out, ICPStepResult(pose_params, pose_mat, loss, it,
                                                   matches, insert)

    def first_frame(map_state: lm.ProjectiveMapState, vmap: torch.Tensor):
        """Initializes the map with the first frame."""
        eye = torch.eye(4, dtype=vmap.dtype, device=vmap.device)
        return lm.update_projective_map(
            map_state, eye, vmap, proj, torch.ones((), dtype=torch.bool, device=vmap.device),
            normals_kernel_size=normals_kernel_size)

    def build_vmap_from_points(points: torch.Tensor, mask: torch.Tensor):
        return projection.build_vertex_map(points, proj, mask=mask)

    return step, first_frame, build_vmap_from_points


class _FrameGraph:
    """A map's per-frame step captured once as a CUDA graph over static
    slots: the frame's upload and mask, the map state, the motion since the
    last insert and the last relative pose (the next frame's prior).  The
    graph's last nodes write the step's state and pose back into the slots,
    so replay i+1 reads what replay i wrote; its pose params land in
    ``params``, which each replay copies out.

    What the step counts on the host (B1's and B2's launches, the
    ``utils.timer`` counts) is recorded at the capture, which enqueues the
    frame and runs nothing, and added by each replay; the device counts
    are kernels of the graph."""

    def __init__(self, step, state, delta, rpose, points, mask):
        self.step = step
        self.state = type(state)(*(t.clone() for t in state))
        self.delta, self.rpose = delta.clone(), rpose.clone()
        self.points, self.mask = torch.empty_like(points), torch.empty_like(mask)
        self.graph = None
        self.params = None
        # B1's ticket counter in the graph: the graph's nodes hold its
        # address, so it lives as long as the graph
        self.counter = None
        self.launches = 0  # B1 launches a replay runs
        self.searches = 0  # B2 launches a replay runs
        self.counts: dict = {}  # timer counts a replay makes

    @staticmethod
    def runs_on(device: torch.device) -> bool:
        return device.type == "cuda"

    def load(self, state, delta, rpose):
        """Copies (state, delta, rpose) into the slots, each tensor that is
        not its slot already: what an eager step or another graph left, or,
        inside the step, what it computed."""
        for slot, value in zip(self.state + (self.delta, self.rpose),
                               tuple(state) + (delta, rpose)):
            if slot is not value:
                slot.copy_(value)

    def _frame(self) -> torch.Tensor:
        state, delta, rpose, params, _ = self.step(self.state, self.delta, self.points,
                                                    self.mask, self.rpose)
        self.load(state, delta, rpose)
        return params

    def _record(self, graph) -> torch.Tensor:
        """Enqueues one frame into `graph`'s capture, with what it counts on
        the host recorded for the replays, and returns its params."""
        with b1.capture(self.points.device) as ours, b2.capture() as searches, \
                recorded_counts() as counts:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                params = self._frame()
            finally:
                graph.capture_end()
        self.counter, self.launches = ours.counter, ours.launches
        self.searches, self.counts = searches.launches, counts
        return params

    def _add_counts(self):
        """Counts what a replay ran."""
        b1.add_launches(self.launches)
        b2.add_launches(self.searches)
        add_counts(self.counts)

    def capture(self, points, mask, out):
        """Steps one frame eagerly on a stream of the graph's own, which
        warms what that stream has not run (cuBLAS's workspace, the
        kernels' first calls), then captures the step there.  Other threads
        may use the card meanwhile."""
        main = torch.cuda.current_stream(points.device)
        side = torch.cuda.Stream(points.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.points.copy_(points)
            self.mask.copy_(mask)
            out.copy_(self._frame())
            graph = torch.cuda.CUDAGraph()
            params = self._record(graph)
        main.wait_stream(side)
        self.graph, self.params = graph, params

    def replay(self, points, mask, out):
        self.points.copy_(points)
        self.mask.copy_(mask)
        self.graph.replay()
        out.copy_(self.params)
        self._add_counts()


# ----------------------------------------------------------------------------
# Host-side odometry module (data_dict protocol)
# ----------------------------------------------------------------------------

class ICPFrameToModel:
    """Host wrapper driving the per-frame / batched device step.

    Input under ``config.data_key``: an (N, 3+) point cloud or an
    (H, W, 3) / (3, H, W) vertex map, numpy or a tensor.
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

        map_dict = config.local_map if isinstance(config.local_map, dict) else {}
        mode = map_dict.get("type", MAP_TYPES[0])
        assert_debug(mode in MAPS, f"Unknown local_map type '{mode}'. Known: {list(MAPS)}")
        self._mode = mode
        align_cfg = config.alignment if isinstance(config.alignment, dict) else {}
        gn_cfg = dataclass_from_dict(
            GaussNewtonConfig, align_cfg.get("gauss_newton_config", {}))
        self._elastic = bool(align_cfg.get("elastic", False))
        self._map: lm.LocalMap = MAPS[mode](config, projector, map_dict, gn_cfg, align_cfg)
        self.local_map_size = int(self._map.config.local_map_size)
        fmt = str(config.upload_format or "f32")
        assert_debug(fmt in UPLOAD_FORMATS,
                     f"Unknown upload_format '{fmt}'. Known: {list(UPLOAD_FORMATS)}")
        assert_debug(
            fmt == "f32" or self._map.uploads,
            f"upload_format='{fmt}' has no effect with "
            f"local_map.type={mode} (it consumes vertex maps, "
            f"not host point uploads) -- use another map, or drop the override")
        assert_debug(str(config.pose_type or "") in POSE_TYPES,
                     f"Unknown pose_type '{config.pose_type}'")
        self._viz = None  # the ImageVisualizer of viz_debug, made on first use
        # the dither's generator, made on the first dithered frame and kept
        # across init(), as in the JAX package
        self._dither_rng: Optional[np.random.Generator] = None
        # Batched mode: when True, every flush copies its (B, 6) params to
        # pinned host memory (one transfer per batch, behind a CUDA event)
        # and drain_batch_results hands per-frame float64 relative poses to
        # the downstream stages (loop closure, backend).
        self.emit_batch_poses = False
        self.init()

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        with span("odometry.init"):
            self._map_state = self._map.init_state(self.device)
            self._delta_since_update = torch.eye(4, dtype=torch.float32,
                                                 device=self.device)
            # Device-side pose log: (k, 6) params per flush, fetched once.
            self._params_log: list = []
            # batched mode: host upload buffers, or (points, mask) device pairs
            # of vertex-map inputs
            self._frame_buffer: list = []
            self._pending_params: list = []  # ([host params], event or None)
            self._pending_rposes: list = []
            # the step's CUDA graphs, by the frame upload's (dtype, rows, cols)
            self._graphs: dict = {}
            # the first batch after init() steps eagerly, which warms cuBLAS,
            # cuSOLVER and the allocator before any capture
            self._graph_warm = False
            self._iter = 0
            self.last_rpose_device: Optional[torch.Tensor] = None
            self._boot_cloud: Optional[np.ndarray] = None
            # Where the batched pipeline's thread spends each flush (the
            # `odometry.upload` and `odometry.dispatch` spans' clock reads):
            # staging and enqueueing the upload, and dispatching the batched
            # step.  Read by the benches.
            self.pipe_stats = {"upload_wait_s": 0.0, "dispatch_s": 0.0, "flushes": 0}

    def _viz_update(self):
        """With `viz_debug`, the local map's model image (aggregated and
        projective maps) colormapped to PNGs under ./viz_debug, and to a cv2
        window where one can open.  Debug only: each update fetches the
        model image from the device."""
        if not bool(self.config.viz_debug) or self._map.model_image is None:
            return
        if self._viz is None:
            from pylidar_slam_tpu_torch.viz.visualizer import ImageVisualizer
            self._viz = ImageVisualizer(output_dir="viz_debug", use_window=True)
        self._viz.update(self._map.model_image(self._map_state).cpu().numpy(),
                         tag="model_range")

    # -- EI bootstrap -------------------------------------------------------

    def _boot_cloud_of(self, data_dict: dict) -> np.ndarray:
        """The frame's (N, 3) float32 host cloud in meters, for the EI
        bootstrap: the raw input, not the (possibly encoded) upload."""
        return self._input_cloud(self._input(data_dict))[:, :3].astype(np.float32)

    def _ei_bootstrap_pose(self, data_dict: dict):
        """BEV phase-correlation alignment of frame 1 to frame 0 (the cloud
        ``_boot_cloud``): a (4, 4) float32 device init pose (current frame
        -> previous frame), or None when the estimate fails its checks."""
        with span("odometry.bootstrap"):
            cur, prev = self._boot_cloud_of(data_dict), self._boot_cloud
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

    def _maybe_bootstrap(self, data_dict: dict, init_pose: torch.Tensor) -> torch.Tensor:
        """Frame 1's init pose: the EI estimate in place of `init_pose`
        where it passes its checks (``_boot_cloud`` is held only with
        ``ei_bootstrap`` on).  At batch 1 `init_pose` is the caller's
        prior, and an informative one (not the identity) wins.  Batched, it
        is the start of the chain, the identity after frame 0, so frame 1
        is always bootstrapped."""
        if self._iter != 1 or self._boot_cloud is None:
            return init_pose
        informative = False
        if not self.buffers_uploads:
            eye = torch.eye(4, dtype=init_pose.dtype, device=init_pose.device)
            # frame 1 only: this reads the prior back to the host
            informative = float(torch.abs(init_pose - eye).max()) > 1e-5
        boot = None if informative else self._ei_bootstrap_pose(data_dict)
        self._boot_cloud = None
        return init_pose if boot is None else boot

    # -- uploads ------------------------------------------------------------

    def _compact_host_buffer(self, arr: np.ndarray) -> np.ndarray:
        """Encodes a raw scan into the host upload buffer, by
        ``upload_format``: a fixed-shape range image (rimg, rimg16, rimg8,
        rimg12), or the NaN-scrubbed cloud -- packed, int16-quantized or
        float32 -- bucketed to a multiple of 16384 rows (zero-padded to
        capacity on the device)."""
        with span("odometry.encode"):
            cap = self.config.num_points_padded
            fmt = self._upload_kind()
            if fmt == "rimg12":
                # the buffer is its full static shape (4 pixels a row): no
                # device padding, so the capacity is its decoded point count
                buf = projection.np_encode_rimg12(arr[:, :3], self.projector)
                assert_debug(cap == 4 * buf.shape[0],
                             f"rimg12 upload needs num_points_padded == "
                             f"{4 * buf.shape[0]} (4 x encoded rows; got {cap})")
                return buf
            if fmt in ("rimg", "rimg16", "rimg8"):
                # one point a pixel: no overflow drop; the encoders skip
                # non-finite points themselves
                h, w = self.projector.height, self.projector.width
                need = h * w + ((h + w + 1) // 2 if fmt == "rimg8" else 0)
                assert_debug(cap >= need, f"{fmt} upload needs num_points_padded "
                                          f">= {need} (got {cap})")
                return projection.np_encode_range_image(arr[:, :3], self.projector,
                                                        sub16=(fmt == "rimg16"),
                                                        planes=(fmt == "rimg8"))
            pts = arr[:, :3].astype(np.float32)
            nan_rows = np.isnan(pts).any(axis=1)
            if nan_rows.any():
                pts = pts[~nan_rows]
            if pts.shape[0] > cap:
                # Spatially uniform overflow drop (a stride over scan order is
                # azimuth-uniform; head truncation would keep the top rows only).
                pts = pts[:: -(-pts.shape[0] // cap)][:cap]
            if fmt == "packed":
                enc = projection.np_encode_packed_upload(pts, self.projector)
                n = min(enc.shape[0], cap)
                buf = np.zeros((self._bucket(n), 4), np.uint16)
                buf[:n] = enc[:n]
                return buf
            n = min(pts.shape[0], cap)
            if fmt == "int16":
                q = float(self.config.upload_quantization)
                chunk = pts[:n]
                if self.config.upload_dither:
                    if self._dither_rng is None:
                        self._dither_rng = np.random.default_rng(0)
                    chunk = chunk + (self._dither_rng.random(
                        chunk.shape, dtype=np.float32) - 0.5) * q
                steps = np.round(chunk / q)
                # points beyond the int16 range are dropped: clamping would warp
                # far-field geometry
                steps[(np.abs(steps) > 32767).any(axis=1)] = 0.0
                buf = np.zeros((self._bucket(n), 3), np.int16)
                buf[:n] = steps
                return buf
            buf = np.zeros((self._bucket(n), 3), np.float32)
            buf[:n] = pts[:n]
            return buf

    def _upload_kind(self) -> str:
        """The buffer `_compact_host_buffer` makes: the range-image format's
        name, "packed" (H*W <= 65536, else the point list below), "int16"
        (upload_quantization > 0; not on the projective map, which
        rasterizes the f32 cloud) or "f32"."""
        if not self._map.uploads:
            return "f32"
        fmt = str(self.config.upload_format or "f32")
        if fmt.startswith("rimg") or (
                fmt == "packed" and self.projector.height * self.projector.width <= 65536):
            return fmt
        return "int16" if float(self.config.upload_quantization or 0.0) > 0.0 else "f32"

    def _bucket(self, n: int) -> int:
        """Rows of a point-list upload of n points: a multiple of 16384, at
        most the capacity."""
        return min(self.config.num_points_padded,
                   max(self._UPLOAD_BUCKET, -(-n // self._UPLOAD_BUCKET) * self._UPLOAD_BUCKET))

    def encode_upload(self, arr: np.ndarray) -> Optional[np.ndarray]:
        """Host-side upload encoding, safe to call from prefetch workers;
        store the result under ``data_dict["encoded_upload"]``.  None for a
        dithered upload: its noise comes from one generator in frame order,
        so such a frame is encoded when it is processed."""
        if self.config.upload_dither and self._upload_kind() == "int16":
            return None
        return self._compact_host_buffer(np.asarray(arr))

    def _upload(self, stacked: np.ndarray) -> torch.Tensor:
        """(B, rows, C) host buffers -> (B, capacity, C) on the device: one
        non-blocking copy from pinned memory, zero padding on the device.
        An rimg12 buffer is its full shape already (4 points a row); the
        zero rows of the others decode invalid."""
        host = torch.from_numpy(np.ascontiguousarray(stacked))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        b, rows, cols = dev.shape
        cap = self.config.num_points_padded
        if rows < cap and not (dev.dtype == torch.uint8 and cols == 6):
            # packed uint16 is padded through its int16 view (the same bits)
            flat = dev.view(torch.int16) if dev.dtype == torch.uint16 else dev
            flat = torch.cat([flat, flat.new_zeros((b, cap - rows, cols))], dim=1)
            dev = flat.view(dev.dtype)
        return dev

    def _ones_mask(self, *lead) -> torch.Tensor:
        return torch.ones(lead + (self.config.num_points_padded,),
                          dtype=torch.bool, device=self.device)

    def _vertex_map(self, data):
        """An (H, W, 3) / (3, H, W) vertex-map input as a channels-last
        float32 array (numpy or tensor, NaNs zeroed); None for a cloud."""
        if data.ndim != 3:
            return None
        if data.shape[0] == 3 and data.shape[-1] != 3:
            data = data.permute(1, 2, 0) if isinstance(data, torch.Tensor) \
                else np.transpose(data, (1, 2, 0))
        assert_debug(tuple(data.shape) == (self.projector.height, self.projector.width, 3),
                     f"vertex map of shape {tuple(data.shape)} does not fit the "
                     f"{self.projector.height}x{self.projector.width} projector")
        if isinstance(data, torch.Tensor):
            return torch.nan_to_num(data.to(torch.float32))
        return np.nan_to_num(np.asarray(data, np.float32))

    def _input_cloud(self, data) -> np.ndarray:
        """The frame's (N, 3+) host point cloud; a vertex map's pixels in
        row-major order."""
        vmap = self._vertex_map(data)
        if vmap is not None:
            data = vmap.reshape(-1, 3)
        arr = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        assert_debug(arr.ndim == 2 and arr.shape[1] >= 3,
                     f"Cannot interpret data under '{self.config.data_key}' "
                     f"with shape {arr.shape}")
        return arr

    def _input(self, data_dict: dict):
        key = self.config.data_key
        assert_debug(key in data_dict,
                     f"Could not find the key `{key}` in the input dictionary "
                     f"(keys: {list(data_dict.keys())}).")
        return data_dict[key]

    def _read_points(self, data_dict: dict):
        """Reads the input as a device cloud + validity mask: a vertex map's
        H*W pixels as they are, a cloud padded to capacity."""
        data = self._input(data_dict)
        vmap = self._vertex_map(data)
        if vmap is not None:
            pts = torch.as_tensor(vmap, device=self.device).reshape(-1, 3)
            return pts, torch.amax(torch.abs(pts), dim=-1) > 0
        buf = self._compact_host_buffer(self._input_cloud(data))
        with span("odometry.upload", self._iter):
            return self._upload(buf[None])[0], self._ones_mask()

    def _read_input(self, data_dict: dict) -> torch.Tensor:
        """The projective map's (H, W, 3) device vertex map: a vertex-map
        input as it is, a cloud rasterized on the device (uploaded as the
        f32 upload of the other maps: NaN rows dropped, thinned by a stride
        past capacity)."""
        data = self._input(data_dict)
        vmap = self._vertex_map(data)
        if vmap is not None:
            return torch.as_tensor(vmap, device=self.device)
        return self._map.vertex_map(*self._read_points(data_dict))

    @staticmethod
    def pointcloud_key() -> str:
        return "odometry_pc"

    @staticmethod
    def relative_pose_key() -> str:
        return "odometry_pose"

    # -- main ---------------------------------------------------------------

    @property
    def buffers_uploads(self) -> bool:
        """Frames after the first are kept as host upload buffers and
        stepped a batch at a time: a map that steps uploads, at
        ``batch_size`` > 1.  Such a frame's upload may be encoded ahead, in
        a prefetch worker (``encode_upload``)."""
        return self._map.uploads and int(self.config.batch_size or 1) > 1

    def process_next_frame(self, data_dict: dict):
        if self.buffers_uploads and self._iter > 0:
            return self._buffer_frame(data_dict)
        # one frame a step: frame 0, batch 1, and the projective map, which
        # ignores batch_size
        uploads = self._map.uploads
        frame = self._read_points(data_dict) if uploads else (self._read_input(data_dict),)
        if self._iter == 0:  # into the map at the identity pose
            with span("odometry.dispatch", 0):
                self._map_state = self._map.first_frame(self._map_state, *frame)
            count("odometry.frames_stepped")
            self.last_rpose_device = torch.eye(4, dtype=torch.float32, device=self.device)
            self._params_log.append(torch.zeros((1, 6), dtype=torch.float32,
                                                device=self.device))
            self._iter += 1
            data_dict[self.relative_pose_key()] = self.last_rpose_device
            if bool(self.config.ei_bootstrap):  # kept for the frame-1 EI bootstrap
                self._boot_cloud = self._boot_cloud_of(data_dict)
            return

        init_pose = self._maybe_bootstrap(data_dict, self._init_pose(data_dict))
        with span("odometry.dispatch", self._iter):
            out = self._map.step(self._map_state, self._delta_since_update, *frame,
                                 init_pose)
        count("odometry.frames_stepped")
        if uploads:
            self._map_state, self._delta_since_update, rpose, pose_params, _diag = out
            pc_out = self._input_cloud(data_dict[self.config.data_key])[:, :3]
        else:  # the projective step's ICPStepResult; its vertex map goes downstream
            self._map_state, self._delta_since_update, result = out
            rpose, pose_params, pc_out = result.pose_matrix, result.pose_params, frame[0]
        self.last_rpose_device = rpose
        self._params_log.append(pose_params[None])
        data_dict[self.relative_pose_key()] = rpose
        data_dict[self.pointcloud_key()] = pc_out
        self._iter += 1
        self._viz_update()

    def _init_pose(self, data_dict: dict) -> torch.Tensor:
        """The caller's prior (e.g. the previous frame's pose, still on the
        device), used as it is: no host round trip per frame."""
        init = data_dict.get("init_rpose", None)
        if init is None:
            return torch.eye(4, dtype=torch.float32, device=self.device)
        return torch.as_tensor(init, dtype=torch.float32, device=self.device)

    def _buffer_frame(self, data_dict: dict):
        """Batched path: keeps the frame as a host upload buffer; the whole
        batch crosses to the device as one stacked copy at flush.  A
        vertex-map input is buffered as its device (points, mask)."""
        with span("odometry.buffer", self._iter):
            data = self._input(data_dict)
            arr = self._input_cloud(data)
            if data.ndim == 3:  # a vertex map
                entry = self._read_points(data_dict)
                pc_out = arr[:, :3]
            else:
                # A prefetch worker may already have run encode_upload() off
                # this thread.
                entry = data_dict.get("encoded_upload")
                if entry is None:
                    entry = self._compact_host_buffer(arr)
                # Downstream consumers need METERS, not an encoded buffer.
                pc_out = entry if entry.dtype == np.float32 else arr[:, :3]
            # the CV chain starts from last_rpose_device (identity after
            # frame 0); the BEV estimate makes frame 1's init real
            self.last_rpose_device = self._maybe_bootstrap(data_dict,
                                                           self.last_rpose_device)
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
        """Runs the buffered frames through one batched device run: a full
        batch, or at ``finish()`` the partial one, as a shorter batch."""
        if not self._frame_buffer:
            return
        bufs = self._frame_buffer
        self._frame_buffer = []
        flush = self.pipe_stats["flushes"]
        with span("odometry.upload", flush) as upload:
            if isinstance(bufs[0], tuple):  # vertex-map inputs, on the device
                pts = torch.stack([p for p, _ in bufs])
                msks = torch.stack([m for _, m in bufs])
            else:
                pts = self._upload(self._stack(bufs))
                msks = self._ones_mask(len(bufs))
        with span("odometry.dispatch", flush) as dispatch:
            params = self._step_graphed(pts, msks)
            if params is None:
                (self._map_state, self._delta_since_update, self.last_rpose_device,
                 params, _diags) = self._map.batch_step(
                    self._map_state, self._delta_since_update,
                    self.last_rpose_device, pts, msks)
        st = self.pipe_stats
        st["upload_wait_s"] += upload.seconds
        st["dispatch_s"] += dispatch.seconds
        st["flushes"] += 1
        count("odometry.frames_stepped", len(bufs))
        self._params_log.append(params)
        if self.emit_batch_poses:
            self._pending_params.append(copy_to_host_async(params))
        self._viz_update()  # one model render per flush

    def _step_graphed(self, pts: torch.Tensor, msks: torch.Tensor) -> Optional[torch.Tensor]:
        """Steps frames pts[i] (masks msks[i]) in order by replays of the
        step's CUDA graph for their key, captured at the key's first use
        (whose first frame runs eagerly), and returns their (B, 6) params;
        None where the step runs eagerly: on the CPU, for a map whose step
        is not graph-safe, and for the first batch after ``init()``, which
        warms the libraries and the allocator."""
        if not (self._map.graph_safe and _FrameGraph.runs_on(pts.device)):
            return None
        if not self._graph_warm:
            self._graph_warm = True
            return None
        params = torch.empty((pts.shape[0], 6), dtype=torch.float32, device=pts.device)
        key = (pts.dtype,) + tuple(pts.shape[1:])
        graph = self._graphs.get(key)
        first = 0
        if graph is None:
            graph = _FrameGraph(self._map.step, self._map_state, self._delta_since_update,
                                self.last_rpose_device, pts[0], msks[0])
            graph.capture(pts[0], msks[0], params[0])
            self._graphs[key] = graph
            count("odometry.graph_captures")
            first = 1
        else:
            graph.load(self._map_state, self._delta_since_update, self.last_rpose_device)
        for i in range(first, pts.shape[0]):
            with span("odometry.replay"):
                graph.replay(pts[i], msks[i], params[i])
        count("odometry.graph_replays", pts.shape[0] - first)
        self._map_state, self._delta_since_update, self.last_rpose_device = \
            graph.state, graph.delta, graph.rpose
        return params

    def _collect_params(self, wait: bool):
        """Moves the fetched params of finished flushes, in flush order, to
        the pose stream; `wait` waits for every copy, else it stops at the
        first whose event has not completed."""
        with span("odometry.pose_collect"):
            while self._pending_params:
                (host,), event = self._pending_params[0]
                if event is not None and not event.query():
                    if not wait:
                        break
                    event.synchronize()
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
        self._flush_batch()

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
        pose_type = str(self.config.pose_type or "")
        elastic = self._elastic and pose_type in _POSE_FRACTIONS
        return self.get_ct_relative_poses(pose_type if elastic else "begin_pose")

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
