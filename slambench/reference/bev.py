"""Bird's-eye-view elevation images and their dense (x, y, yaw) registration:
a frozen copy of ``pylidar_slam_tpu_torch/ops/bev.py`` (the plain reference
of the odometry's frame-1 bootstrap and of the loop closure's match).  It
imports nothing of the program; the arithmetic is the program's as of the
benchmark's first version.
"""
from __future__ import annotations

import functools
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


def _map_coordinates(image: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Order-1 sampling of `image` (*lead, H, W) at (ys, xs), taps outside
    the image reading 0, summed in the order (y0, x0), (y0, x1), (y1, x0),
    (y1, x1): the JAX package's ``map_coordinates(order=1,
    mode="constant", cval=0)``, written out because ``grid_sample``'s
    border conventions differ.  With lead dims the coordinates are shared,
    giving (*lead, *coords.shape); without, any coordinate shape."""
    h, w = image.shape[-2:]
    lead = image.shape[:-2]

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return [(idx, 1 - upper_w), (idx + 1, upper_w)]

    flat = image.reshape(*lead, h * w)
    out = None
    for iy, wy in nodes(ys):
        for ix, wx in nodes(xs):
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            tap = flat[..., idx.reshape(-1)].reshape(*lead, *idx.shape)
            term = (wy * wx) * torch.where(ok, tap, torch.zeros_like(tap))
            out = term if out is None else out + term
    return out


def _rotate_image(image: torch.Tensor, yaws: torch.Tensor) -> torch.Tensor:
    """Bilinear rotations of a square (S, S) image about its center, one
    per yaw: yaws (*Y) -> (*Y, S, S)."""
    s = image.shape[0]
    c = (s - 1) / 2.0
    ar = torch.arange(s, dtype=image.dtype, device=image.device)
    ii, jj = torch.meshgrid(ar, ar, indexing="ij")
    cos_y = torch.cos(yaws)[..., None, None]
    sin_y = torch.sin(yaws)[..., None, None]
    y = ii - c
    x = jj - c
    # inverse-rotate output coords to source coords
    src_y = cos_y * y + sin_y * x + c
    src_x = -sin_y * y + cos_y * x + c
    return _map_coordinates(image, src_y, src_x)


def phase_correlation(img_a: torch.Tensor, img_b: torch.Tensor):
    """Translations (dy, dx) such that shifting img_b by them aligns it with
    img_a; the two (..., S, S) stacks broadcast against each other.

    Returns (dy, dx, score), each of the broadcast leading shape: the peak
    location (subpixel via a 3-point quadratic) and the normalized peak
    height.
    """
    s = img_a.shape[-1]
    fa = torch.fft.rfft2(img_a)
    fb = torch.fft.rfft2(img_b)
    cross = fa * torch.conj(fb)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-9)
    corr = torch.fft.irfft2(cross, s=(s, s))
    lead = corr.shape[:-2]
    corr = corr.reshape(-1, s, s)
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
    # unwrap: shifts beyond s/2 are negative
    dy = torch.where(py > s // 2, py - s, py).to(img_a.dtype) + dy_off
    dx = torch.where(px > s // 2, px - s, px).to(img_a.dtype) + dx_off
    return dy.reshape(lead), dx.reshape(lead), c0.reshape(lead)


class BEVRegistrationResult(NamedTuple):
    yaw: torch.Tensor  # (...) best yaw (rad), rotation of b into a
    dy: torch.Tensor  # (...) row shift in pixels
    dx: torch.Tensor  # (...) col shift in pixels
    score: torch.Tensor  # (...) phase-correlation peak height


@functools.lru_cache(maxsize=None)
def _yaw_grid(num: int, yaw_range: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The endpoint=False sweep, in float64 then rounded once to float32;
    made once per device, so a sweep copies nothing from the host."""
    return torch.as_tensor(np.linspace(-yaw_range, yaw_range, num, endpoint=False),
                           dtype=dtype, device=device)


def _pool(img: torch.Tensor, f: int) -> torch.Tensor:
    """f x f average pooling of (..., S, S) images."""
    s = img.shape[-1]
    return img.reshape(*img.shape[:-2], s // f, f, s // f, f).mean(dim=(-3, -1))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per leading index: (..., K) by (...) -> (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def register_bev(img_a: torch.Tensor, img_b: torch.Tensor,
                 num_yaw_steps: int = 60,
                 yaw_range: float = math.pi,
                 coarse_factor: int = 1) -> BEVRegistrationResult:
    """Finds (yaw, dy, dx) aligning img_b (S, S) to each img_a (..., S, S)
    by an exhaustive yaw sweep (one batch of rotations + FFT correlations).

    `coarse_factor` > 1 runs the sweep on average-pooled images and
    re-scores the top 8 coarse yaws at full resolution (ties ranked by the
    lower yaw index, as ``lax.top_k`` ranks them)."""
    yaws = _yaw_grid(num_yaw_steps, float(yaw_range), img_a.dtype, img_a.device)
    s = img_a.shape[-1]
    if coarse_factor > 1 and img_a.shape[-2] == s and s % coarse_factor == 0 \
            and num_yaw_steps > 8:
        small_a, small_b = _pool(img_a, coarse_factor), _pool(img_b, coarse_factor)
        coarse = phase_correlation(small_a[..., None, :, :],
                                   _rotate_image(small_b, yaws))[2]
        top_idx = torch.sort(coarse, dim=-1, descending=True, stable=True).indices[..., :8]
        top_yaws = yaws[top_idx]
        dys, dxs, scores = phase_correlation(img_a[..., None, :, :],
                                             _rotate_image(img_b, top_yaws))
        best = torch.argmax(scores, dim=-1)
        return BEVRegistrationResult(yaw=_take(top_yaws, best), dy=_take(dys, best),
                                     dx=_take(dxs, best), score=_take(scores, best))
    dys, dxs, scores = phase_correlation(img_a[..., None, :, :], _rotate_image(img_b, yaws))
    best = torch.argmax(scores, dim=-1)
    return BEVRegistrationResult(yaw=yaws[best], dy=_take(dys, best),
                                 dx=_take(dxs, best), score=_take(scores, best))


def _polar_spectrum(img: torch.Tensor, n_theta: int, n_radius: int) -> torch.Tensor:
    """(..., T, R) polar resampling of the log FFT magnitude spectrum of
    (..., S, S) images.

    The magnitude spectrum is translation-invariant, and rotating the image
    rotates it by the same angle, so image rotation becomes a circular shift
    along theta (Fourier-Mellin).  Half a turn of angles suffices: |F| of a
    real image is point-symmetric.
    """
    s = img.shape[-1]
    f = torch.log1p(torch.abs(torch.fft.fftshift(torch.fft.fft2(img), dim=(-2, -1))))
    c = s / 2.0
    thetas = torch.arange(n_theta, dtype=img.dtype, device=img.device) * (math.pi / n_theta)
    # the lowest frequencies (translation-ish, low angular resolution) skipped
    radii = 2.0 + torch.arange(n_radius, dtype=img.dtype, device=img.device) * (
        (s / 2.0 - 3.0) / n_radius)
    tt, rr = torch.meshgrid(thetas, radii, indexing="ij")
    return _map_coordinates(f, c + rr * torch.sin(tt), c + rr * torch.cos(tt))


def _circular_shift_theta(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Best circular shift (in theta bins, subbin) aligning pb to pa along
    the theta axis, via 1D FFT correlation summed over the radius axis; pa
    (..., T, R) against pb (T, R) -> (...)."""
    n_theta = pa.shape[-2]
    fa = torch.fft.rfft(pa, dim=-2)
    fb = torch.fft.rfft(pb, dim=-2)
    corr = torch.fft.irfft(torch.sum(fa * torch.conj(fb), dim=-1), n=n_theta, dim=-1)
    k = torch.argmax(corr, dim=-1)

    def subbin(c_m, c_0, c_p):
        denom = c_m - 2 * c_0 + c_p
        return torch.where(torch.abs(denom) > 1e-9, 0.5 * (c_m - c_p) / denom,
                           torch.zeros_like(denom))

    off = subbin(_take(corr, (k - 1) % n_theta), _take(corr, k),
                 _take(corr, (k + 1) % n_theta))
    shift = k.to(pa.dtype) + off
    # unwrap: shifts beyond half a turn are negative
    return torch.where(shift > n_theta / 2, shift - n_theta, shift)


def _linspace_f32(start: float, stop: float, num: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace`` in float32: start * (1 - step) + stop * step."""
    div = num - 1
    step = torch.arange(div, dtype=like.dtype, device=like.device) / div
    start_t = torch.full((1,), start, dtype=like.dtype, device=like.device)
    stop_t = torch.full((1,), stop, dtype=like.dtype, device=like.device)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t])


def register_bev_fm(img_a: torch.Tensor, img_b: torch.Tensor,
                    n_theta: int = 180,
                    n_radius: int = 128,
                    coarse_factor: int = 4) -> BEVRegistrationResult:
    """Fourier-Mellin (x, y, yaw) registration of img_b (S, S) to each img_a
    (..., S, S), the fast match path:

    1. one polar-magnitude-spectrum correlation for the rotation (yaw mod
       pi, ~1-bin precision);
    2. a 10-candidate refinement sweep (5 sub-bin offsets x the two
       half-turn hypotheses) on `coarse_factor` x average-pooled images,
       with a parabola over the winning hypothesis' 5 scores;
    3. one full-resolution phase correlation at the winning yaw for the
       final (dy, dx) and the acceptance score.
    """
    s = img_a.shape[-1]
    shift = _circular_shift_theta(_polar_spectrum(img_a, n_theta, n_radius),
                                  _polar_spectrum(img_b, n_theta, n_radius))
    # shifting pb by +k bins aligns it to pa, so img_b is rotated by +k bins
    # against img_a; _rotate_image samples with the inverse rotation, so the
    # warp candidate is -shift
    yaw0 = -shift * (math.pi / n_theta)

    if coarse_factor > 1 and s % coarse_factor == 0:
        small_a, small_b = _pool(img_a, coarse_factor), _pool(img_b, coarse_factor)
    else:
        small_a, small_b = img_a, img_b

    bin_rad = math.pi / n_theta
    offsets = _linspace_f32(-bin_rad, bin_rad, 5, img_a)
    yaws = torch.cat([yaw0[..., None] + offsets, (yaw0 + math.pi)[..., None] + offsets],
                     dim=-1)
    # candidates in (-pi, pi]
    yaws = torch.where(yaws > math.pi, yaws - 2 * math.pi, yaws)
    yaws = torch.where(yaws <= -math.pi, yaws + 2 * math.pi, yaws)
    scores = phase_correlation(small_a[..., None, :, :], _rotate_image(small_b, yaws))[2]
    best = torch.argmax(scores, dim=-1)
    # sub-offset parabola over the winning hypothesis' 5-point score curve
    k = torch.clamp(best % 5, 1, 3) + (best // 5) * 5
    s_m, s_0, s_p = _take(scores, k - 1), _take(scores, k), _take(scores, k + 1)
    denom = s_m - 2 * s_0 + s_p
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (s_m - s_p) / denom,
                       torch.zeros_like(denom))
    yaw = _take(yaws, k) + torch.clamp(frac, -1.0, 1.0) * (offsets[1] - offsets[0])
    dy, dx, score = phase_correlation(img_a, _rotate_image(img_b, yaw))
    return BEVRegistrationResult(yaw=yaw, dy=dy, dx=dx, score=score)


def bev_transform_to_se3(result: BEVRegistrationResult,
                         pixel_size: float) -> torch.Tensor:
    """(..., 4, 4) SE(3) transforms (z = 0) mapping cloud b's coordinates
    into cloud a's frame.  `_rotate_image` samples with the inverse
    rotation, so the cloud-space angle is -yaw."""
    cos_y = torch.cos(-result.yaw)
    sin_y = torch.sin(-result.yaw)
    zero, one = torch.zeros_like(cos_y), torch.ones_like(cos_y)
    rows = [[cos_y, -sin_y, zero, result.dx * pixel_size],
            [sin_y, cos_y, zero, result.dy * pixel_size],
            [zero, zero, one, zero],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2).to(torch.float32)
