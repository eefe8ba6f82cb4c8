"""Aggregated incremental projective local map (torch port of
``pylidar_slam_tpu.slam.odometry.aggregated_map``).

The model is ONE (H, W) image in the frame of the last inserted keyframe
(the "anchor") holding xyz + normal + age per pixel:

* **insert** (motion-thresholded): the new scan becomes the anchor; the old
  model is re-expressed, re-rasterized once (one encoded scatter-min) and
  merged with the scan by a per-pixel closest-range select; pixels older
  than `local_map_size` inserts are evicted.
* **association + normal equations**: the target scan is rasterized into
  the anchor grid at the current pose, and kernel B1
  (``ops.kernels.assoc_gn``) picks each pixel's closest model candidate in a
  small (row, col) window and sums the weighted 6x6 system.

Control flow runs on the device with no host sync: the JAX early-exit
``while_loop`` is a fixed ``max_num_alignments`` trip whose carries freeze
once the stop condition holds, and each ``lax.cond`` computes both branches
and selects.  The per-frame numbers equal the JAX program's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.ops import (geometry, optimization, projection,
                                        registration, se3)
from pylidar_slam_tpu_torch.ops.kernels.assoc_gn import (
    assoc_gn, unpack, window_associate_images)
from pylidar_slam_tpu_torch.ops.optimization import solve_normal_equations
from pylidar_slam_tpu_torch.ops.projection import point_norm
from pylidar_slam_tpu_torch.slam.odometry.local_map import (
    LocalMap, LocalMapConfig, icp_args, insert_rule, make_batch_step, select_state)
from pylidar_slam_tpu_torch.utils.timer import span


@dataclass
class AggregatedLocalMapConfig(LocalMapConfig):
    type: str = "aggregated_local_map"
    local_map_size: int = 20  # eviction age, in inserted keyframes
    normals_kernel_size: int = 5
    window_rows: int = 1  # search window half-extent in rows
    window_cols: int = 2  # search window half-extent in cols (azimuth)
    max_neighbor_dist: float = 1.0  # reject correspondences farther than this (m)
    # Correspondence-gate annealing: the first ICP iteration gates at this
    # distance, shrinking geometrically to `max_neighbor_dist` over the GN
    # config's `sigma_anneal_iters` (0 disables).
    max_neighbor_dist_start: float = 0.0
    # Refit the normals on the MERGED model image after every insert
    # (degenerate fits keep the carried per-scan normal).
    model_normals: bool = False
    # Window plane fit: "plane" = the uncentered (sum v v^T) n = sum v
    # solve; "centered" = the mean-centered covariance's smallest
    # eigenvector (geometry.compute_normal_map_centered).
    normals_fit: str = "plane"


ALIGNMENT_MODES = ("point_to_plane_gauss_newton", "point_to_point_gauss_newton",
                   "point_to_point_procrustes")


class AggMapState(NamedTuple):
    """Model image in the anchor keyframe's frame."""
    xyz: torch.Tensor  # (H, W, 3) 0 = empty
    normal: torch.Tensor  # (H, W, 3)
    rng: torch.Tensor  # (H, W) range (0 = empty)
    age: torch.Tensor  # (H, W) int32 inserts since the pixel's scan
    anchor_from_cur: torch.Tensor  # (4, 4): current frame -> anchor frame


def init_agg_map(h: int, w: int, device, dtype=torch.float32) -> AggMapState:
    return AggMapState(
        xyz=torch.zeros((h, w, 3), dtype=dtype, device=device),
        normal=torch.zeros((h, w, 3), dtype=dtype, device=device),
        rng=torch.zeros((h, w), dtype=dtype, device=device),
        age=torch.zeros((h, w), dtype=torch.int32, device=device),
        anchor_from_cur=torch.eye(4, dtype=dtype, device=device))


def agg_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> AggMapState:
    """Map state from numpy arrays keyed by field name (e.g. the JAX
    package's ``AggMapState._asdict()`` fetched to the host) -- the map is the
    system's only carried state, so this is the port's state converter."""
    return AggMapState(*[
        torch.tensor(np.asarray(arrays[name]),
                     dtype=torch.int32 if name == "age" else torch.float32,
                     device=device)
        for name in AggMapState._fields])


def agg_state_to_numpy(state: AggMapState) -> Dict[str, np.ndarray]:
    return {name: t.detach().cpu().numpy()
            for name, t in zip(AggMapState._fields, state)}


def dequant_upload(points: torch.Tensor, mask: torch.Tensor,
                   proj: projection.SphericalProjection,
                   upload_quantization: float = 0.0):
    """Expands an upload to float32 meters and its validity mask (the zero
    padding decodes invalid); the third return is True when the points are
    PIXEL-ORDERED (row-major, one per pixel), so an insert can reshape
    instead of re-rasterizing.

    By dtype, as in the JAX package: uint8 is a range image (6 columns =
    rimg12, else rimg / rimg16 / rimg8), uint16 the packed points, int16
    steps of `upload_quantization` meters, float32 meters.
    """
    if points.dtype == torch.uint8:
        if points.shape[-1] == 6:  # rimg12: 4 px a row, a mask-sized output
            points, pvalid = projection.decode_rimg12(points, proj)
        else:
            points, pvalid = projection.decode_range_image(points, proj)
        return points, mask & pvalid, True
    if points.dtype == torch.uint16:
        points, pvalid = projection.decode_packed_upload(points, proj)
        return points, mask & pvalid, False
    if points.dtype == torch.int16:
        points = points.to(torch.float32) * upload_quantization
    return points, mask & (torch.amax(torch.abs(points), dim=-1) > 0), False


# ----------------------------------------------------------------------------
# Rasterization with a single encoded scatter-min
# ----------------------------------------------------------------------------

_IDX_BITS = 18  # supports up to 262144 input points
_RANGE_BITS = 13  # quantized range priority: 8192 steps
_SENTINEL = 2 ** 31 - 1


def rasterize_encoded(points: torch.Tensor,
                      proj: projection.SphericalProjection,
                      mask: torch.Tensor,
                      max_range: float = 120.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest-wins rasterization via ONE int32 scatter-min.

    The key packs (quantized range, point index), so the per-pixel min keeps
    the closest point and, on equal quantized range, the lowest index.
    Invalid points go to the sentinel bucket h*w.  Returns (winner index
    (H*W,) int64 clipped to [0, n-1], hit (H*W,) bool).
    """
    n = points.shape[0]
    assert n < (1 << _IDX_BITS), f"point capacity {n} exceeds {_IDX_BITS}-bit index"
    h, w = proj.height, proj.width
    rows, cols, r = proj.project(points)
    rows = torch.round(rows)
    cols = torch.round(cols)
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1) & \
        (r > 0.0) & mask
    flat = torch.where(valid, rows.to(torch.int64) * w + cols.to(torch.int64),
                       torch.full_like(rows, h * w, dtype=torch.int64))
    qr = torch.clamp(r * ((1 << _RANGE_BITS) / max_range),
                     max=(1 << _RANGE_BITS) - 1).to(torch.int32)
    key = (qr << _IDX_BITS) | torch.arange(n, dtype=torch.int32,
                                           device=points.device)
    sentinel = torch.full_like(key, _SENTINEL)
    kmin = torch.full((h * w + 1,), _SENTINEL, dtype=torch.int32,
                      device=points.device).scatter_reduce(
        0, flat, torch.where(valid, key, sentinel), "amin")[: h * w]
    hit = kmin != _SENTINEL
    idx = torch.clamp(kmin & ((1 << _IDX_BITS) - 1), 0, n - 1).to(torch.int64)
    return idx, hit


def _gather_image(values: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """values[idx] where hit, 0 elsewhere, as an (H, W, ...) image."""
    got = values[idx]
    mask = hit.reshape((-1,) + (1,) * (got.dim() - 1))
    return torch.where(mask, got, torch.zeros_like(got)).reshape(
        (h, w) + got.shape[1:])


def _normal_fit_fn(normals_fit: str):
    if normals_fit == "centered":
        return geometry.compute_normal_map_centered
    if normals_fit == "plane":
        return geometry.compute_normal_map
    raise ValueError(f"Unknown normals_fit '{normals_fit}'")


def build_scan_images(points: torch.Tensor,
                      mask: torch.Tensor,
                      proj: projection.SphericalProjection,
                      normals_kernel_size: int = 5,
                      normals_fit: str = "plane"):
    """Rasterizes a scan -> (vertex map, normal map, range image), (H, W, *)."""
    h, w = proj.height, proj.width
    idx, hit = rasterize_encoded(points, proj, mask)
    vmap = _gather_image(points, idx, hit, h, w)
    nmap = _normal_fit_fn(normals_fit)(vmap, normals_kernel_size)
    return vmap, nmap, point_norm(vmap)


# ----------------------------------------------------------------------------
# Map update
# ----------------------------------------------------------------------------

def insert_scan(state: AggMapState,
                scan_vmap: torch.Tensor,
                scan_nmap: torch.Tensor,
                scan_rimg: torch.Tensor,
                new_anchor_from_old_anchor: torch.Tensor,
                proj: projection.SphericalProjection,
                max_age: int,
                model_normals_kernel: int = 0,
                normals_fit: str = "plane") -> AggMapState:
    """Inserts a scan; the scan's frame becomes the new anchor.

    The old model is re-expressed in the new anchor frame, re-rasterized once
    and merged with the scan by per-pixel closest-range select.  Old pixels
    at `max_age` or older are evicted first.  With `model_normals_kernel`
    > 0 the normals are refit on the merged image; where that fit is
    degenerate the carried normal stays.
    """
    h, w, _ = scan_vmap.shape
    t = new_anchor_from_old_anchor

    old_pts = state.xyz.reshape(-1, 3)
    old_nrm = state.normal.reshape(-1, 3)
    old_age = state.age.reshape(-1)
    old_valid = (state.rng.reshape(-1) > 0) & (old_age < max_age)

    moved = se3.apply_transformation(old_pts, t)
    moved_nrm = se3.apply_rotation(old_nrm, t)

    idx, hit = rasterize_encoded(moved, proj, old_valid)
    old_img_xyz = _gather_image(moved, idx, hit, h, w)
    old_img_nrm = _gather_image(moved_nrm, idx, hit, h, w)
    old_img_age = _gather_image(old_age, idx, hit, h, w)
    old_img_rng = point_norm(old_img_xyz)

    # Per-pixel merge: closest range wins; empty pixels take whichever hits.
    new_has = scan_rimg > 0
    old_has = old_img_rng > 0
    take_old = old_has & ((~new_has) | (old_img_rng < scan_rimg))

    xyz = torch.where(take_old[..., None], old_img_xyz, scan_vmap)
    nrm = torch.where(take_old[..., None], old_img_nrm, scan_nmap)
    rng = torch.where(take_old, old_img_rng, scan_rimg)
    zero_age = torch.zeros_like(old_img_age)
    age = torch.where(take_old, old_img_age + 1, zero_age)
    age = torch.where(rng > 0, age, zero_age)
    if model_normals_kernel > 0:
        fit = _normal_fit_fn(normals_fit)(xyz, model_normals_kernel)
        good = torch.amax(torch.abs(fit), dim=-1, keepdim=True) > 0
        nrm = torch.where(good, fit, nrm)
    return AggMapState(xyz=xyz, normal=nrm, rng=rng, age=age,
                       anchor_from_cur=torch.eye(4, dtype=xyz.dtype,
                                                 device=xyz.device))


def window_associate(state: AggMapState, tgt_img: torch.Tensor,
                     window_rows: int, window_cols: int, max_dist: float):
    """For each target pixel, the best model candidate in a small window:
    (ref_xyz, ref_normal, mask, sq_dists) flattened to (H*W, ...).  The plain
    form of the association that kernel B1 fuses."""
    return window_associate_images(state.xyz, state.normal, state.rng > 0,
                                   tgt_img, window_rows, window_cols, max_dist)


# ----------------------------------------------------------------------------
# The per-frame ICP step
# ----------------------------------------------------------------------------

def make_agg_icp_frame_step(proj: projection.SphericalProjection,
                            map_cfg: AggregatedLocalMapConfig,
                            max_num_alignments: int,
                            reassoc_every: int,
                            threshold_delta_pose: float,
                            threshold_trans: float,
                            threshold_rot: float,
                            gn_scheme: str,
                            gn_sigma: float,
                            gn_eps: float = 1.0e-4,
                            gn_sigma_start: float = 0.0,
                            gn_sigma_anneal_iters: int = 0,
                            max_dist_to_plane: float = 0.0,
                            beta_location_consistency: float = 0.0,
                            beta_constant_velocity: float = 0.0,
                            beta_small_velocity: float = 0.0,
                            beta_orientation_consistency: float = 0.0,
                            reassoc_motion_m: float = 0.0,
                            upload_quantization: float = 0.0,
                            deskew: bool = False,
                            elastic: bool = False,
                            alignment_mode: str = "point_to_plane_gauss_newton"):
    """Builds (step, first_frame, batch_step) for the aggregated-map odometry.

    `max_num_alignments` GN iterations; the target is re-rasterized into the
    anchor grid every `reassoc_every` iterations and, when
    `reassoc_motion_m` > 0, whenever the pose moved more than that since the
    last rasterization.

    Alignment modes: point-to-plane GN on kernel B1 (association, plane
    gate and the weighted sums in one launch), and point-to-point GN or
    procrustes on the plain association.  The CT-ICP beta priors join the
    GN system after its sums.  `deskew` warps each cloud once by the
    constant-velocity prior; `elastic` re-warps the raw cloud from the
    current pose iterate before every rasterization and inserts it warped
    by the final estimate.
    """
    if alignment_mode not in ALIGNMENT_MODES:
        raise ValueError(f"Unknown alignment mode '{alignment_mode}'")

    h, w = proj.height, proj.width
    max_age = int(map_cfg.local_map_size)
    wr, wc = int(map_cfg.window_rows), int(map_cfg.window_cols)
    max_nd = float(map_cfg.max_neighbor_dist)
    max_nd_start = float(map_cfg.max_neighbor_dist_start or 0.0)
    nks = int(map_cfg.normals_kernel_size)
    model_nks = nks if bool(map_cfg.model_normals) else 0
    nrm_fit = str(map_cfg.normals_fit)
    normal_fit = _normal_fit_fn(nrm_fit)
    priors = max(beta_location_consistency, beta_constant_velocity,
                 beta_small_velocity, beta_orientation_consistency) > 0.0

    def anneal_at(start: float, end: float, it: int) -> float:
        """Geometric interpolation from `start` down to `end` over the first
        `gn_sigma_anneal_iters` iterations (host float: the iteration index
        is static in the fixed-trip loop)."""
        if start <= 0.0 or gn_sigma_anneal_iters <= 0 or start == end:
            return end
        frac = min(max(it / float(gn_sigma_anneal_iters), 0.0), 1.0)
        return start * (end / start) ** frac

    def pose_prior(t, t_init, anchor_from_cur, count):
        """The CT-ICP beta priors as (prior_res, prior_weight) in the
        left-delta space of dx, scaled by the match count: pulls toward the
        constant-velocity prior t_init (translation, rotation or both) and
        toward zero motion (t == anchor_from_cur)."""
        if not priors:
            return None, None
        n_ok = torch.clamp(count.to(t.dtype), min=1.0)
        tr_blk = torch.cat([torch.ones_like(t[0, :3]), torch.zeros_like(t[0, :3])])
        rot_blk = 1.0 - tr_blk
        d_cv = se3.from_pose_matrix((t @ se3.inverse_pose_matrix(t_init))[None])[0]
        d_sv = se3.from_pose_matrix(
            (t @ se3.inverse_pose_matrix(anchor_from_cur))[None])[0]
        w_cv = n_ok * (beta_constant_velocity
                       + beta_location_consistency * tr_blk
                       + beta_orientation_consistency * rot_blk)
        w_sv = n_ok * beta_small_velocity
        weight = w_cv + w_sv
        return (w_cv * d_cv + w_sv * d_sv) / torch.clamp(weight, min=1.0e-12), weight

    def register(state: AggMapState, tgt_pts: torch.Tensor,
                 tgt_mask: torch.Tensor, t_init: torch.Tensor,
                 alphas: Optional[torch.Tensor]):
        """ICP: solves T = anchor_from_new. tgt_pts (N, 3) in the new frame;
        `alphas` (elastic mode) are their sweep fractions.  Returns (T,
        iterations run, loss, matches) as device tensors."""
        dev = tgt_pts.device
        model_valid = state.rng > 0
        inv_anchor = se3.inverse_pose_matrix(state.anchor_from_cur) if elastic else None

        def rasterize_target(t):
            if elastic:
                # the raw cloud re-warped from the current iterate: per-point
                # slerp between identity and the frame-to-frame motion
                rots, trs = se3.interpolate_pose(inv_anchor @ t, alphas)
                p = se3.warp_points(rots, trs, tgt_pts, tgt_mask)
            else:
                p = tgt_pts
            q = se3.apply_transformation(p, t)
            idx, hit = rasterize_encoded(q, proj, tgt_mask)
            return _gather_image(q, idx, hit, h, w)

        def solve(timg, t, sigma_k, max_nd_k):
            """One iteration's (dx, loss, singular, match count)."""
            if alignment_mode == "point_to_plane_gauss_newton":
                sums = assoc_gn(timg, state.xyz, state.normal, model_valid, wr, wc,
                                max_nd_k, gn_scheme, sigma_k, max_dist_to_plane,
                                gn_eps)
                hmat, g, loss_k, count_k, _ = unpack(sums)
                prior_res, prior_weight = pose_prior(t, t_init, state.anchor_from_cur,
                                                     count_k)
                dx, singular = solve_normal_equations(
                    hmat, g, prior_res=prior_res, prior_weight=prior_weight)
                return dx, loss_k, singular, count_k
            ref, _, ok, sq_d = window_associate(state, timg, wr, wc, max_nd_k)
            tp = timg.reshape(-1, 3)
            zero6 = tp.new_zeros(6)
            count_k = ok.sum()
            res = optimization.point_to_point_residuals(zero6, tp, ref, ok)
            weights = optimization.robust_weights(gn_scheme, res, sigma_k,
                                                  sq_dists=sq_d, eps=gn_eps)
            if alignment_mode == "point_to_point_procrustes":
                # the closed-form weighted Kabsch fit of this association
                wts = weights * weights * ok.to(tp.dtype)
                mat = registration.weighted_procrustes(ref[None], tp[None], wts[None])[0]
                singular = count_k < 3
                dx = se3.from_pose_matrix(mat[None])[0]
                dx = torch.where(singular, torch.zeros_like(dx), dx)
                return dx, torch.sum((res * weights) ** 2), singular, count_k
            jac = optimization.point_to_point_jacobian(zero6, tp, ref, ok)
            prior_res, prior_weight = pose_prior(t, t_init, state.anchor_from_cur,
                                                 count_k)
            dx, loss_k, singular = optimization.gauss_newton_step(
                res, jac, weights, prior_res=prior_res, prior_weight=prior_weight)
            return dx, loss_k, singular, count_k

        t = t_init
        timg0 = rasterize_target(t_init)
        t_round = t_init
        delta_norm = torch.full((), math.inf, dtype=tgt_pts.dtype, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        loss = torch.zeros((), dtype=tgt_pts.dtype, device=dev)
        matches = torch.zeros((), dtype=torch.int32, device=dev)
        for k in range(max_num_alignments):
            # The JAX loop's condition; once false every carry stays frozen.
            active = delta_norm >= threshold_delta_pose
            sigma_k = anneal_at(gn_sigma_start, gn_sigma, k)
            max_nd_k = anneal_at(max_nd_start, max_nd, k)

            timg0_k, t_round_k = timg0, t_round
            periodic = k > 0 and k % reassoc_every == 0
            if periodic or (k > 0 and reassoc_motion_m > 0.0):
                fresh = rasterize_target(t)
                if periodic:
                    timg0_k, t_round_k = fresh, t
                else:
                    d_pre = t @ se3.inverse_pose_matrix(t_round)
                    moved = se3.pose_motion_magnitude(d_pre) > reassoc_motion_m
                    timg0_k = torch.where(moved, fresh, timg0)
                    t_round_k = torch.where(moved, t, t_round)
            delta_round = t @ se3.inverse_pose_matrix(t_round_k)
            tvalid = torch.amax(torch.abs(timg0_k), dim=-1, keepdim=True) > 0
            moved_img = se3.apply_transformation(
                timg0_k.reshape(-1, 3), delta_round).reshape(h, w, 3)
            timg = torch.where(tvalid, moved_img, torch.zeros_like(moved_img))

            dx, loss_k, singular, count_k = solve(timg, t, sigma_k, max_nd_k)
            dn = torch.linalg.vector_norm(dx)
            apply = (dn >= threshold_delta_pose) & (~singular)
            new_t = se3.normalize_pose_matrix(
                (se3.build_pose_matrix(dx[None])[0] @ t)[None])[0]
            t_out = torch.where(apply, new_t, t)

            t = torch.where(active, t_out, t)
            timg0 = torch.where(active, timg0_k, timg0)
            t_round = torch.where(active, t_round_k, t_round)
            delta_norm = torch.where(active, dn, delta_norm)
            it = it + active.to(torch.int32)
            loss = torch.where(active, loss_k, loss)
            matches = torch.where(active, count_k.to(torch.int32), matches)
        return t, it, loss, matches

    def scan_images(points: torch.Tensor, mask: torch.Tensor, reshape: bool):
        if reshape:
            # Range-image uploads decode in row-major pixel order: the
            # vertex map is a reshape (one point per pixel, no collisions).
            vmap = points[: h * w].reshape(h, w, 3)
            return vmap, normal_fit(vmap, nks), point_norm(vmap)
        return build_scan_images(points, mask, proj, nks, normals_fit=nrm_fit)

    def step(state: AggMapState, delta_since_update: torch.Tensor,
             points: torch.Tensor, mask: torch.Tensor, init_rpose: torch.Tensor):
        """Full frame: register + thresholded insert.  Returns
        (state', delta', rpose, pose_params, (loss, iters, matches, inserted))."""
        with span("odometry.dequant"):
            points, mask, pixel_ordered = dequant_upload(points, mask, proj,
                                                          upload_quantization)
        with span("odometry.register"):
            alphas = None
            if elastic or deskew:
                alphas = projection.estimate_timestamps(points, clockwise=True,
                                                        phi_0=math.pi, mask=mask)
            if deskew and not elastic:
                # one warp by the constant-velocity prior, before registration
                rots, trs = se3.interpolate_pose(init_rpose, alphas)
                points = se3.warp_points(rots, trs, points, mask)
            t_init = state.anchor_from_cur @ init_rpose
            t_final, it, loss, matches = register(state, points, mask, t_init, alphas)

        with span("odometry.map_update"):
            # Relative pose new -> previous frame
            rpose = se3.inverse_pose_matrix(state.anchor_from_cur) @ t_final
            pose_params = se3.from_pose_matrix(rpose[None])[0]

            insert, delta_out = insert_rule(delta_since_update, rpose,
                                            threshold_trans, threshold_rot)

            # Both branches of the JAX lax.cond, selected on the device.
            if elastic:
                # the map holds the cloud de-skewed by the final estimate
                rots, trs = se3.interpolate_pose(rpose, alphas)
                points = se3.warp_points(rots, trs, points, mask)
            vmap, nmap, rimg = scan_images(points, mask,
                                           pixel_ordered and not (elastic or deskew))
            inserted = insert_scan(state, vmap, nmap, rimg,
                                   se3.inverse_pose_matrix(t_final), proj, max_age,
                                   model_normals_kernel=model_nks, normals_fit=nrm_fit)
            state = select_state(insert, inserted,
                                 state._replace(anchor_from_cur=t_final))
        return state, delta_out, rpose, pose_params, (loss, it, matches, insert)

    def first_frame(state: AggMapState, points: torch.Tensor, mask: torch.Tensor):
        points, mask, pixel_ordered = dequant_upload(points, mask, proj,
                                                      upload_quantization)
        vmap, nmap, rimg = scan_images(points, mask, pixel_ordered)
        eye = torch.eye(4, dtype=points.dtype, device=points.device)
        return insert_scan(state, vmap, nmap, rimg, eye, proj, max_age,
                           model_normals_kernel=model_nks, normals_fit=nrm_fit)

    return step, first_frame, make_batch_step(step)


def aggregated_local_map(config, proj: projection.SphericalProjection, map_dict: dict,
                         gn, alignment: dict) -> LocalMap:
    """The aggregated map's record.  Its step has fixed shapes, reads
    nothing back to the host and allocates only through PyTorch's
    allocator: the odometry may capture it in a CUDA graph."""
    cfg = dataclass_from_dict(AggregatedLocalMapConfig, map_dict)
    step, first_frame, batch_step = make_agg_icp_frame_step(
        proj=proj,
        map_cfg=cfg,
        reassoc_every=int(config.reassoc_every or 3),
        gn_sigma_start=float(gn.sigma_start or 0.0),
        gn_sigma_anneal_iters=int(gn.sigma_anneal_iters or 0),
        max_dist_to_plane=float(gn.max_dist_to_plane or 0.0),
        beta_location_consistency=float(gn.beta_location_consistency or 0.0),
        beta_constant_velocity=float(gn.beta_constant_velocity or 0.0),
        beta_small_velocity=float(gn.beta_small_velocity or 0.0),
        beta_orientation_consistency=float(gn.beta_orientation_consistency or 0.0),
        deskew=bool(alignment.get("deskew", False)),
        elastic=bool(alignment.get("elastic", False)),
        alignment_mode=str(alignment.get("mode", "point_to_plane_gauss_newton")),
        **icp_args(config, gn))
    h, w = proj.height, proj.width
    return LocalMap(cfg, lambda device: init_agg_map(h, w, device), step, first_frame,
                    batch_step, graph_safe=True, model_image=lambda st: st.rng)
