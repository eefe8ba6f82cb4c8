"""Spherical projection and the compact upload codecs (torch port of
``pylidar_slam_tpu.ops.projection``).

Projection model (the reference's, slam/common/projection.py):

    r     = ||p||
    theta = -atan2(y, x)                       # azimuth
    phi   = asin(z / r)                        # elevation
    col   = 0.5 * (theta / pi + 1) * W
    row   = (1 - (phi + |fov_down|) / fov) * H

Images are channels-last ``(H, W, C)``, as in the JAX package.

Upload codecs (host encoder in numpy or the shared native library, device
decoder in PyTorch ops; each byte for byte the JAX package's):

* ``packed`` -- (N, 4) uint16 per point: pixel id, 2 mm range steps and
  the f16 angular offsets from the pixel's center ray (H*W <= 65536);
* ``rimg`` / ``rimg16`` -- (H*W, 3|4) uint8 z-buffered range image with
  4+4-bit / 8+8-bit per-pixel sub-pixel offsets;
* ``rimg8`` -- (H*W + (H+W+1)//2, 2) uint8 range image with per-row and
  per-column mean offset planes (exact on a regular firing pattern);
* ``rimg12`` -- four 12-bit 3 cm range steps per 6-byte row plus rimg8's
  planes, padded to a multiple of 256 rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

PACKED_RANGE_STEP = 0.002  # 2 mm -> uint16 covers 131 m


def _fovs(proj) -> Tuple[float, float, float]:
    fov_up = proj.up_fov / 180.0 * math.pi
    fov_down = proj.down_fov / 180.0 * math.pi
    return fov_up, fov_down, abs(fov_down) + abs(fov_up)


def point_norm(points: torch.Tensor) -> torch.Tensor:
    """||p|| over the last axis of (..., 3).  On the CPU this rounds as the
    JAX package's ``jnp.linalg.norm`` does (a fused multiply-add chain), which
    keeps z-buffer range keys identical in the parity tests."""
    return torch.linalg.vector_norm(points, dim=-1)


def np_estimate_timestamps(points: np.ndarray, clockwise: bool = True,
                           phi_0: float = 0.0) -> np.ndarray:
    """``estimate_timestamps`` on the host, without a mask."""
    phis = np.arctan2(points[..., 1], points[..., 0]) * (-1.0 if clockwise else 1.0)
    phis = phis - phi_0
    phis = np.where(phis < 0.0, phis + 2.0 * math.pi, phis)
    lo, hi = phis.min(), phis.max()
    return (phis - lo) / max(hi - lo, 1e-12)


def estimate_timestamps(points: torch.Tensor, clockwise: bool = True,
                        phi_0: float = 0.0, mask: torch.Tensor = None) -> torch.Tensor:
    """Per-point sweep fractions of a rotating LiDAR from the azimuth:
    (N, 3) -> (N,) in [0, 1], the min and max taken over `mask` only."""
    phis = torch.atan2(points[..., 1], points[..., 0]) * (-1.0 if clockwise else 1.0)
    phis = phis - phi_0
    phis = torch.where(phis < 0.0, phis + 2.0 * math.pi, phis)
    if mask is None:
        lo, hi = torch.amin(phis), torch.amax(phis)
    else:
        lo = torch.amin(torch.where(mask, phis, torch.full_like(phis, math.inf)))
        hi = torch.amax(torch.where(mask, phis, torch.full_like(phis, -math.inf)))
    return (phis - lo) / torch.clamp(hi - lo, min=1e-12)


class SphericalProjection(NamedTuple):
    """Static projection parameters."""
    height: int
    width: int
    up_fov: float  # degrees
    down_fov: float  # degrees

    def project(self, points: torch.Tensor):
        """Projects (..., N, 3) points to float pixel coords.

        Returns (rows, cols, r), each (..., N).  Points with r == 0 get
        row = col = -1 (invalid).
        """
        _, fov_down, fov = _fovs(self)
        r = point_norm(points)
        invalid = r == 0.0
        r_safe = torch.where(invalid, torch.full_like(r, 0.001), r)
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        theta = -torch.atan2(y, x)
        phi = torch.asin(z / r_safe)
        proj_col = 0.5 * (theta / math.pi + 1.0) * self.width
        proj_row = (1.0 - (phi + abs(fov_down)) / fov) * self.height
        minus_one = torch.full_like(r, -1.0)
        return (torch.where(invalid, minus_one, proj_row),
                torch.where(invalid, minus_one, proj_col),
                torch.where(invalid, torch.zeros_like(r), r))


def build_vertex_map(points: torch.Tensor, proj: SphericalProjection,
                     mask: Optional[torch.Tensor] = None,
                     channels: Optional[torch.Tensor] = None,
                     default_value: float = 0.0) -> torch.Tensor:
    """Rasterizes padded (..., N, 3) point clouds into (..., H, W, C) vertex
    maps, the closest point winning its pixel.

    Two scatter-min passes, as in the JAX package: the min range per pixel,
    then the min point index among the range winners (deterministic ties).
    Invalid points (masked, zero range, outside the image) go to a sentinel
    bucket ``h*w``, sliced off afterwards.  Leading batch dims get disjoint
    bucket ranges in one scatter.  `channels` (..., N, C) are gathered at
    the winners (default: the xyz); empty pixels hold `default_value`.
    """
    if channels is None:
        channels = points
    lead = points.shape[:-2]
    n = points.shape[-2]
    h, w = proj.height, proj.width
    b = int(np.prod(lead)) if lead else 1
    pts = points.reshape(b, n, 3)
    ch = channels.reshape(b, n, channels.shape[-1])
    dev = points.device

    # the winners are picked without gradient: the gathered channels carry
    # it (straight-through on the indices, as in the JAX package)
    rows, cols, r = proj.project(pts.detach())
    rows = torch.round(rows)
    cols = torch.round(cols)
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1) & (r > 0.0)
    if mask is not None:
        valid = valid & mask.reshape(b, n)
    bucket = h * w + 1
    flat = torch.where(valid, rows.to(torch.int64) * w + cols.to(torch.int64),
                       torch.full_like(rows, h * w, dtype=torch.int64))
    flat = flat + torch.arange(b, dtype=torch.int64, device=dev)[:, None] * bucket
    flat = flat.reshape(-1)

    inf = torch.full_like(r, math.inf)
    rmin = torch.full((b * bucket,), math.inf, dtype=r.dtype, device=dev).scatter_reduce(
        0, flat, torch.where(valid, r, inf).reshape(-1), "amin")
    is_winner = valid.reshape(-1) & (r.reshape(-1) <= rmin[flat])
    idx = torch.arange(n, dtype=torch.int64, device=dev).repeat(b)
    idx_min = torch.full((b * bucket,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, flat, torch.where(is_winner, idx, torch.full_like(idx, n)), "amin")
    idx_min = idx_min.reshape(b, bucket)[:, :h * w]

    hit = idx_min < n
    gathered = torch.gather(ch, 1, torch.clamp(idx_min, 0, n - 1)[..., None].expand(
        b, h * w, ch.shape[-1]))
    out = torch.where(hit[..., None], gathered,
                      torch.full_like(gathered, default_value))
    return out.reshape(lead + (h, w, ch.shape[-1]))


def vertex_map_to_points(vmap: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) vertex map -> (..., H*W, C) point list (zero-padded)."""
    shape = vmap.shape
    return vmap.reshape(*shape[:-3], shape[-3] * shape[-2], shape[-1])


def np_encode_packed_upload(pts: np.ndarray, proj: SphericalProjection) -> np.ndarray:
    """Packs an (N, 3) cloud into the 8 B/point upload: (N', 4) uint16 rows
    [pixel_id, range_steps, f16(dtheta), f16(dphi)], the angular offsets
    taken from the assigned pixel's center ray.

    Out-of-image and out-of-range points are dropped.  Needs H*W <= 65536
    (the caller falls back to f32 otherwise).
    """
    h, w = proj.height, proj.width
    assert h * w <= 65536, "packed upload needs uint16 pixel ids"
    _, fov_down, fov = _fovs(proj)
    r = np.linalg.norm(pts, axis=-1)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r_safe = np.where(r > 0, r, 1.0)
    theta = -np.arctan2(y, x)
    phi = np.arcsin(np.clip(z / r_safe, -1.0, 1.0))
    colf = 0.5 * (theta / math.pi + 1.0) * w
    rowf = (1.0 - (phi + abs(fov_down)) / fov) * h
    row = np.round(rowf)
    # colf lies in (0, w]; a column rounded to w is column 0's azimuth: wrap
    # it instead of dropping a half-pixel wedge at the seam
    col = np.round(colf) % w
    keep = (r > 0) & (r < 65535 * PACKED_RANGE_STEP) & (row >= 0) & (row <= h - 1)
    row, col = row[keep], col[keep]
    out = np.empty((int(keep.sum()), 4), np.uint16)
    out[:, 0] = (row * w + col).astype(np.uint16)
    out[:, 1] = np.maximum(np.round(r[keep] / PACKED_RANGE_STEP), 1.0).astype(np.uint16)
    theta_c = (2.0 * col / w - 1.0) * math.pi
    phi_c = (1.0 - row / h) * fov - abs(fov_down)
    # the azimuth offset wrapped into [-pi, pi): seam-wrapped points keep a
    # half-pixel-scale offset (the decode's trig is 2 pi-periodic)
    dtheta = (theta[keep] - theta_c + math.pi) % (2.0 * math.pi) - math.pi
    out[:, 2] = dtheta.astype(np.float16).view(np.uint16)
    out[:, 3] = (phi[keep] - phi_c).astype(np.float16).view(np.uint16)
    return out


def decode_packed_upload(buf: torch.Tensor, proj: SphericalProjection):
    """Device-side inverse of ``np_encode_packed_upload``.

    Args:
        buf: (N, 4) uint16 (or its int16 view) packed points, zero rows =
            padding.
    Returns:
        (points (N, 3) float32, valid (N,) bool).
    """
    h, w = proj.height, proj.width
    _, fov_down, fov = _fovs(proj)
    # int16 view: the bits as they are, with ops every device supports
    raw = buf.view(torch.int16)
    pix = raw[:, 0].to(torch.int32) & 0xFFFF
    steps = raw[:, 1].to(torch.int32) & 0xFFFF
    dtheta = raw[:, 2].view(torch.float16).to(torch.float32)
    dphi = raw[:, 3].view(torch.float16).to(torch.float32)
    valid = steps > 0
    row = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    col = (pix % w).to(torch.float32)
    theta = (2.0 * col / w - 1.0) * math.pi + dtheta
    phi = (1.0 - row / h) * fov - abs(fov_down) + dphi
    r = steps.to(torch.float32) * PACKED_RANGE_STEP
    cos_phi = torch.cos(phi)
    pts = torch.stack([r * cos_phi * torch.cos(theta),
                       -r * cos_phi * torch.sin(theta),
                       r * torch.sin(phi)], dim=-1)
    return torch.where(valid[:, None], pts, torch.zeros_like(pts)), valid


def np_encode_range_image(pts: np.ndarray, proj: SphericalProjection,
                          range_step: float = PACKED_RANGE_STEP,
                          sub16: bool = False,
                          planes: bool = True) -> np.ndarray:
    """Encodes an (N, 3) cloud into a fixed-shape range-image upload (host
    side): a z-buffered spherical range image (the closest point wins its
    pixel; uint16 little-endian range steps, 0 = empty).

    * ``planes`` (rimg8, this port's default): (H*W + (H+W+1)//2, 2) uint8,
      the range pixels followed by the per-ROW mean elevation offsets (H
      bytes) and per-COLUMN mean azimuth offsets (W bytes), 2 bytes a row;
    * else (H*W, 3) uint8 rows [r_lo, r_hi, sub] with 4+4-bit sub-pixel
      offsets (rimg), or with `sub16` (H*W, 4) with 8+8-bit offsets
      (rimg16); bin centers at ((q + 0.5) / bins - 0.53) pixels.

    Uses the shared native encoder when it builds, numpy otherwise.
    """
    h, w = proj.height, proj.width
    fov_up, fov_down, fov = _fovs(proj)

    from pylidar_slam_tpu_torch.utils import native
    out = native.encode_range_image(pts, h, w, fov_up, fov_down, range_step,
                                    sub16=sub16, planes=planes)
    if out is not None:
        return out

    # numpy fallback: descending-range sort, last write wins (= closest)
    pts = pts[:, :3].astype(np.float32)
    pts = pts[~np.isnan(pts).any(axis=1)]
    r = np.linalg.norm(pts, axis=-1)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r_safe = np.where(r > 0, r, 1.0)
    theta = -np.arctan2(y, x)
    phi = np.arcsin(np.clip(z / r_safe, -1.0, 1.0))
    colf = 0.5 * (theta / math.pi + 1.0) * w
    rowf = (1.0 - (phi + abs(fov_down)) / fov) * h
    # +0.03 px tie-break bias (the native encoder's): beams exactly on the
    # half-pixel boundary otherwise flip round direction on f32 noise.
    row = np.floor(rowf + 0.53)
    col = np.floor(colf + 0.53) % w
    steps = np.round(r / range_step)
    keep = (r > 0) & (steps < 65535) & (row >= 0) & (row <= h - 1)
    row, col, r, theta, phi = (a[keep] for a in (row, col, r, theta, phi))
    steps = np.maximum(steps[keep], 1.0).astype(np.uint16)
    pix = (row * w + col).astype(np.int64)

    order = np.argsort(-r, kind="stable")
    pw = 2.0 * math.pi / w
    ph = fov / h
    theta_c = (2.0 * col / w - 1.0) * math.pi
    phi_c = (1.0 - row / h) * fov - abs(fov_down)
    dtheta = (theta - theta_c + math.pi) % (2.0 * math.pi) - math.pi
    dphi = phi - phi_c

    if planes:
        out = np.zeros((h * w + (h + w + 1) // 2, 2), np.uint8)
        out[pix[order], 0] = (steps[order] & 0xFF).astype(np.uint8)
        out[pix[order], 1] = (steps[order] >> 8).astype(np.uint8)
        # Plane means over the pixel winners, matching what decodes.
        win = np.full(h * w, -1, np.int64)
        win[pix[order]] = order
        wi = win[win >= 0]
        wpix = np.nonzero(win >= 0)[0]
        tq = dtheta[wi] / pw + 0.53
        pq = dphi[wi] / ph + 0.47
        row_sum = np.bincount(wpix // w, weights=pq, minlength=h)
        row_cnt = np.bincount(wpix // w, minlength=h)
        col_sum = np.bincount(wpix % w, weights=tq, minlength=w)
        col_cnt = np.bincount(wpix % w, minlength=w)
        row_mean = np.where(row_cnt > 0, row_sum / np.maximum(row_cnt, 1), 0.5)
        col_mean = np.where(col_cnt > 0, col_sum / np.maximum(col_cnt, 1), 0.5)
        tail = np.zeros(((h + w + 1) // 2) * 2, np.uint8)
        tail[:h] = np.clip(np.floor(row_mean * 256.0), 0, 255).astype(np.uint8)
        tail[h:h + w] = np.clip(np.floor(col_mean * 256.0), 0, 255).astype(np.uint8)
        out[h * w:] = tail.reshape(-1, 2)
        return out

    bins = 256.0 if sub16 else 16.0
    hi = 255 if sub16 else 15
    # quantizer windows of the biased rounding above: dtheta/pw in
    # [-0.53, 0.47), dphi/ph in (-0.47, 0.53] (rowf runs opposite to phi)
    qt = np.clip(np.floor((dtheta / pw + 0.53) * bins), 0, hi).astype(np.uint8)
    qp = np.clip(np.floor((dphi / ph + 0.47) * bins), 0, hi).astype(np.uint8)
    out = np.zeros((h * w, 4 if sub16 else 3), np.uint8)
    out[pix[order], 0] = (steps[order] & 0xFF).astype(np.uint8)
    out[pix[order], 1] = (steps[order] >> 8).astype(np.uint8)
    if sub16:
        out[pix[order], 2] = qt[order]
        out[pix[order], 3] = qp[order]
    else:
        out[pix[order], 2] = (qt[order] << 4) | qp[order]
    return out


def _separable_decode(steps: torch.Tensor, valid: torch.Tensor,
                      theta_c: torch.Tensor, phi_r: torch.Tensor,
                      h: int, w: int, n: int, range_step: float):
    """Separable-angle decode: per-col theta table (W,) x per-row phi table
    (H,) -> (N, 3) points in pixel order (zeros past H*W)."""
    cos_t, sin_t = torch.cos(theta_c), torch.sin(theta_c)
    cos_p, sin_p = torch.cos(phi_r), torch.sin(phi_r)
    r_img = (steps[: h * w].to(torch.float32) * range_step).reshape(h, w)
    r_img = torch.where(valid[: h * w].reshape(h, w), r_img,
                        torch.zeros_like(r_img))
    pts_img = torch.stack([r_img * (cos_p[:, None] * cos_t[None, :]),
                           -r_img * (cos_p[:, None] * sin_t[None, :]),
                           r_img * sin_p[:, None]], dim=-1).reshape(h * w, 3)
    if n > h * w:
        pts_img = torch.cat([pts_img, pts_img.new_zeros((n - h * w, 3))], dim=0)
    return pts_img, valid


def _plane_angles(tail: torch.Tensor, proj: SphericalProjection):
    """rimg8 / rimg12's angle tables from their plane bytes (H row means,
    then W column means): per-column theta (W,) and per-row phi (H,)."""
    h, w = proj.height, proj.width
    _, fov_down, fov = _fovs(proj)
    dev = tail.device
    rowq = tail[:h].to(torch.float32)
    colq = tail[h:h + w].to(torch.float32)
    pw = 2.0 * math.pi / w
    ph = fov / h
    col_idx = torch.arange(w, dtype=torch.float32, device=dev)
    row_idx = torch.arange(h, dtype=torch.float32, device=dev)
    theta_c = (2.0 * col_idx / w - 1.0) * math.pi + \
        ((colq + 0.5) / 256.0 - 0.53) * pw
    phi_r = (1.0 - row_idx / h) * fov - abs(fov_down) + \
        ((rowq + 0.5) / 256.0 - 0.47) * ph
    return theta_c, phi_r


RIMG12_RANGE_STEP = 0.03  # 3 cm -> 12 bits cover 122.8 m


def np_encode_rimg12(pts: np.ndarray, proj: SphericalProjection) -> np.ndarray:
    """1.5 B/pixel range-image upload: FOUR pixels' 12-bit range steps (3 cm
    each) per 6-byte row, then rimg8's per-row / per-column offset planes,
    padded to a multiple of 256 rows: (256 * ceil((H*W/4 + ceil((H+W)/6))
    / 256), 6) uint8, whose decoded capacity (4 x rows) is 66,560 at
    64x1024.

    Needs H*W % 4 == 0.  Ranges beyond 4095 x 3 cm are dropped.  Built on
    the rimg8 encoder, repacked on the host.
    """
    h, w = proj.height, proj.width
    assert (h * w) % 4 == 0, "rimg12 needs H*W divisible by 4"
    base = np_encode_range_image(pts, proj, planes=True)
    hw = h * w
    steps16 = base[:hw, 0].astype(np.uint32) | (base[:hw, 1].astype(np.uint32) << 8)
    # RIMG12_RANGE_STEP / PACKED_RANGE_STEP == 15 exactly: integer
    # round-division
    steps12 = (steps16 + 7) // 15
    steps12 = np.where((steps16 > 0) & (steps12 <= 4095),
                       np.maximum(steps12, 1), 0).astype(np.uint32)
    quad = steps12.reshape(hw // 4, 4)
    a, b, c, d = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    pix_rows = np.empty((hw // 4, 6), np.uint8)
    pix_rows[:, 0] = a & 0xFF
    pix_rows[:, 1] = (a >> 8) | ((b & 0xF) << 4)
    pix_rows[:, 2] = b >> 4
    pix_rows[:, 3] = c & 0xFF
    pix_rows[:, 4] = (c >> 8) | ((d & 0xF) << 4)
    pix_rows[:, 5] = d >> 4
    planes = base[hw:].reshape(-1)[:h + w]  # row means (H) + col means (W)
    total_rows = -(-(hw // 4 + -(-(h + w) // 6)) // 256) * 256
    tail = np.zeros((total_rows - hw // 4, 6), np.uint8)
    tail.reshape(-1)[:h + w] = planes
    return np.concatenate([pix_rows, tail], axis=0)


def decode_rimg12(buf: torch.Tensor, proj: SphericalProjection):
    """Device-side inverse of ``np_encode_rimg12``.

    Args:
        buf: (N >= H*W/4 + ceil((H+W)/6), 6) uint8, zero-padded past the
            tail.
    Returns:
        ((N*4, 3) float32 points, (N*4,) bool valid): the first H*W are the
        pixels in row-major order, the rest decode the tail and padding and
        are invalid.
    """
    h, w = proj.height, proj.width
    hw = h * w
    b = buf.to(torch.int32)
    quad = torch.stack([
        b[:, 0] | ((b[:, 1] & 0xF) << 8),
        (b[:, 1] >> 4) | (b[:, 2] << 4),
        b[:, 3] | ((b[:, 4] & 0xF) << 8),
        (b[:, 4] >> 4) | (b[:, 5] << 4),
    ], dim=-1)  # (N, 4) 12-bit range steps
    steps = quad.reshape(-1)
    n = steps.shape[0]
    valid = (steps > 0) & (torch.arange(n, device=buf.device) < hw)
    tail = buf[hw // 4:hw // 4 + -(-(h + w) // 6)].reshape(-1)
    theta_c, phi_r = _plane_angles(tail, proj)
    return _separable_decode(steps, valid, theta_c, phi_r, h, w, n, RIMG12_RANGE_STEP)


def decode_range_image(buf: torch.Tensor, proj: SphericalProjection,
                       range_step: float = PACKED_RANGE_STEP):
    """Device-side inverse of ``np_encode_range_image``.

    Args:
        buf: (N, 2|3|4) uint8, N >= its encoded rows, zero-padded: 2 columns
            = rimg8 (range pixels + plane tail), 3 = rimg (4+4-bit offsets),
            4 = rimg16 (8+8-bit).
    Returns:
        (points (N, 3) float32, valid (N,) bool); the first H*W rows are the
        pixels in row-major order.
    """
    h, w = proj.height, proj.width
    _, fov_down, fov = _fovs(proj)
    n = buf.shape[0]
    dev = buf.device
    steps = buf[:, 0].to(torch.int32) | (buf[:, 1].to(torch.int32) << 8)
    valid = steps > 0
    if buf.shape[1] == 2:
        # (row, col)-separable angles: H + W trig tables broadcast as outer
        # products instead of per-pixel transcendentals
        valid = valid & (torch.arange(n, device=dev) < h * w)
        tail = buf[h * w:h * w + (h + w + 1) // 2, :2].reshape(-1)
        theta_c, phi_r = _plane_angles(tail, proj)
        return _separable_decode(steps, valid, theta_c, phi_r, h, w, n, range_step)
    if buf.shape[1] == 4:  # 8+8-bit sub-pixel
        qt = buf[:, 2].to(torch.float32)
        qp = buf[:, 3].to(torch.float32)
        bins = 256.0
    else:  # 4+4-bit packed
        sub = buf[:, 2].to(torch.int32)
        qt = (sub >> 4).to(torch.float32)
        qp = (sub & 0xF).to(torch.float32)
        bins = 16.0
    pw = 2.0 * math.pi / w
    ph = fov / h
    pix = torch.arange(n, dtype=torch.int32, device=dev) % (h * w)
    row = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    col = (pix % w).to(torch.float32)
    theta = (2.0 * col / w - 1.0) * math.pi + ((qt + 0.5) / bins - 0.53) * pw
    phi = (1.0 - row / h) * fov - abs(fov_down) + ((qp + 0.5) / bins - 0.47) * ph
    r = steps.to(torch.float32) * range_step
    cos_phi = torch.cos(phi)
    pts = torch.stack([r * cos_phi * torch.cos(theta),
                       -r * cos_phi * torch.sin(theta),
                       r * torch.sin(phi)], dim=-1)
    return torch.where(valid[:, None], pts, torch.zeros_like(pts)), valid
