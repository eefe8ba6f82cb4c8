"""Bird's-eye-view elevation images + dense (x, y, yaw) registration (torch
port of the EI-bootstrap part of ``pylidar_slam_tpu.ops.bev``).

* elevation image: scatter-max of z over a metric (x, y) grid;
* rotation: an exhaustive yaw sweep of bilinear-warped images, the sweep a
  batch dimension, each candidate scored by FFT phase correlation;
* translation: the phase-correlation peak at the best yaw, refined by
  quadratic interpolation around the peak.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


def ground_suppressed_mask(points: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           margin: float = 0.5) -> torch.Tensor:
    """Validity mask keeping only points `margin` meters above the median
    height (~ground level on ground-dominated scans).

    A single scan's ground return pattern moves with the sensor, so BEV
    phase correlation between raw consecutive scans locks onto it at zero
    shift; structures above ground are world-fixed.  The median of an even
    count averages the two middle values (numpy's convention; torch's
    ``nanmedian`` would return the lower one).
    """
    m = torch.amax(torch.abs(points), dim=-1) > 0
    if mask is not None:
        m = m & mask
    z = points[:, 2]
    zs = torch.sort(torch.where(m, z, torch.full_like(z, float("nan")))).values
    count = m.sum()
    lo = zs[torch.clamp((count - 1) // 2, min=0)]
    hi = zs[count // 2]
    zmed = torch.nan_to_num((lo + hi) * 0.5, nan=0.0)
    return m & (z > zmed + margin)


def build_elevation_image(points: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          pixel_size: float,
                          size: int,
                          z_min: float = -3.0,
                          z_max: float = 5.0) -> torch.Tensor:
    """(N, 3) points -> (size, size) max-elevation image centered at origin.

    Empty pixels are 0; occupied pixels hold the clipped height mapped to
    (0.05, 1].
    """
    half = size * pixel_size / 2.0
    zs = torch.clamp(points[:, 2], z_min, z_max)
    cols = torch.floor((points[:, 0] + half) / pixel_size).to(torch.int64)
    rows = torch.floor((points[:, 1] + half) / pixel_size).to(torch.int64)
    valid = (cols >= 0) & (cols < size) & (rows >= 0) & (rows < size)
    if mask is not None:
        valid = valid & mask
    flat = torch.where(valid, rows * size + cols,
                       torch.full_like(rows, size * size))
    neg_inf = torch.full_like(zs, -math.inf)
    zmax_img = torch.full((size * size + 1,), -math.inf, dtype=zs.dtype,
                          device=zs.device).scatter_reduce(
        0, flat, torch.where(valid, zs, neg_inf), "amax")[: size * size]
    hit = torch.isfinite(zmax_img)
    norm = (zmax_img - z_min) / (z_max - z_min)
    img = torch.where(hit, 0.05 + 0.95 * torch.clamp(norm, 0.0, 1.0),
                      torch.zeros_like(norm))
    return img.reshape(size, size)


def _rotate_image(image: torch.Tensor, yaws: torch.Tensor) -> torch.Tensor:
    """Bilinear rotations of a square (S, S) image about its center, one per
    yaw: (Y,) -> (Y, S, S).

    Order-1 sampling with taps outside the image reading 0, summed in the
    order (y0, x0), (y0, x1), (y1, x0), (y1, x1) -- the JAX package's
    ``map_coordinates(order=1, mode="constant")``, written out because
    ``grid_sample``'s conventions are not guaranteed to match.
    """
    s = image.shape[0]
    c = (s - 1) / 2.0
    ar = torch.arange(s, dtype=image.dtype, device=image.device)
    ii, jj = torch.meshgrid(ar, ar, indexing="ij")
    cos_y = torch.cos(yaws)[:, None, None]
    sin_y = torch.sin(yaws)[:, None, None]
    y = ii - c
    x = jj - c
    src_y = cos_y * y + sin_y * x + c
    src_x = -sin_y * y + cos_y * x + c

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return [(idx, 1 - upper_w), (idx + 1, upper_w)]

    flat = image.reshape(-1)
    out = None
    for iy, wy in nodes(src_y):
        for ix, wx in nodes(src_x):
            ok = (iy >= 0) & (iy < s) & (ix >= 0) & (ix < s)
            tap = flat[(iy.clamp(0, s - 1) * s + ix.clamp(0, s - 1))]
            term = (wy * wx) * torch.where(ok, tap, torch.zeros_like(tap))
            out = term if out is None else out + term
    return out


def phase_correlation(img_a: torch.Tensor, img_b: torch.Tensor):
    """Translations (dy, dx) such that shifting each img_b (B, S, S) by them
    aligns it with img_a (S, S).

    Returns (dy, dx, score), each (B,): the peak location (subpixel via a
    3-point quadratic) and the normalized peak height.
    """
    s = img_a.shape[0]
    fa = torch.fft.rfft2(img_a)
    fb = torch.fft.rfft2(img_b)
    cross = fa * torch.conj(fb)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-9)
    corr = torch.fft.irfft2(cross, s=(s, s))
    b = corr.shape[0]
    peak = torch.argmax(corr.reshape(b, -1), dim=-1)
    py, px = peak // s, peak % s
    batch = torch.arange(b, device=corr.device)

    def at(r, c):
        return corr[batch, r % s, c % s]

    def subpixel(c_m, c_0, c_p):
        denom = c_m - 2 * c_0 + c_p
        return torch.where(torch.abs(denom) > 1e-9, 0.5 * (c_m - c_p) / denom,
                           torch.zeros_like(denom))

    c0 = at(py, px)
    dy_off = subpixel(at(py - 1, px), c0, at(py + 1, px))
    dx_off = subpixel(at(py, px - 1), c0, at(py, px + 1))
    dy = torch.where(py > s // 2, py - s, py).to(img_a.dtype) + dy_off
    dx = torch.where(px > s // 2, px - s, px).to(img_a.dtype) + dx_off
    return dy, dx, c0


class BEVRegistrationResult(NamedTuple):
    yaw: torch.Tensor  # () best yaw (rad), rotation of b into a
    dy: torch.Tensor  # () row shift in pixels
    dx: torch.Tensor  # () col shift in pixels
    score: torch.Tensor  # () phase-correlation peak height


def register_bev(img_a: torch.Tensor, img_b: torch.Tensor,
                 num_yaw_steps: int = 60,
                 yaw_range: float = math.pi,
                 coarse_factor: int = 1) -> BEVRegistrationResult:
    """Finds (yaw, dy, dx) aligning img_b to img_a by an exhaustive yaw
    sweep (one batch of rotations + FFT correlations)."""
    if coarse_factor != 1:
        raise NotImplementedError(
            "register_bev(coarse_factor > 1) is the loop-closure path: "
            "ROADMAP.md A.16")
    # endpoint=False sweep, in float64 then rounded once to float32
    yaws = torch.as_tensor(
        np.linspace(-yaw_range, yaw_range, num_yaw_steps, endpoint=False),
        dtype=img_a.dtype, device=img_a.device)
    dys, dxs, scores = phase_correlation(img_a, _rotate_image(img_b, yaws))
    best = torch.argmax(scores)
    return BEVRegistrationResult(yaw=yaws[best], dy=dys[best], dx=dxs[best],
                                 score=scores[best])


def bev_transform_to_se3(result: BEVRegistrationResult,
                         pixel_size: float) -> torch.Tensor:
    """(4, 4) SE(3) transform (z = 0) mapping cloud b's coordinates into
    cloud a's frame.  `_rotate_image` samples with the inverse rotation, so
    the cloud-space angle is -yaw."""
    cos_y = torch.cos(-result.yaw)
    sin_y = torch.sin(-result.yaw)
    mat = torch.eye(4, dtype=torch.float32, device=result.yaw.device)
    mat[0, 0] = cos_y
    mat[0, 1] = -sin_y
    mat[1, 0] = sin_y
    mat[1, 1] = cos_y
    mat[0, 3] = result.dx * pixel_size
    mat[1, 3] = result.dy * pixel_size
    return mat
