"""The plain reference of the aggregated-map ICP odometry: what
``ICPFrameToModel`` with an ``aggregated_local_map`` computes for a stream
of scans, written as straightforward PyTorch with host control flow.

It imports nothing of the program.  The arithmetic is a frozen copy of the
program's (each function names its origin under
``pylidar_slam_tpu_torch/``), with three differences that change no
result beyond rounding:

- the early-exit trip loop runs on the host (a trip is skipped once the
  last pose delta fell under the threshold, where the program computes it
  and throws it away);
- the window association stacks its candidates and takes the first
  minimum with ``argmin``, where kernel B1 walks them one by one;
- the normal equations are summed with ``torch.sum`` in float32 (or the
  control's precision), where B1 sums in its own order.

``dtype`` sets the precision of every map, point and pose tensor; the
control runs it in bfloat16 (the 6x6 Cholesky solve and the BEV bootstrap
have no bfloat16 kernels and stay in float32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from slambench.reference import bev

RANGE_STEP = 0.002  # rimg8's 2 mm range steps (ops/projection.py:28)
_IDX_BITS = 18  # rasterization key layout (slam/odometry/aggregated_map.py:133-135)
_RANGE_BITS = 13
_SENTINEL = 2 ** 31 - 1


@dataclass
class Sensor:
    height: int
    width: int
    up_fov: float  # degrees
    down_fov: float  # degrees

    def fovs(self):
        up = self.up_fov / 180.0 * math.pi
        down = self.down_fov / 180.0 * math.pi
        return up, down, abs(down) + abs(up)


# -- the rimg8 upload (ops/projection.py:231-322 numpy encoder, :429-462 and
#    :325-362 decoder) ------------------------------------------------------

def encode_rimg8(pts: np.ndarray, sensor: Sensor) -> np.ndarray:
    """(N, 3) cloud -> (H*W + (H+W+1)//2, 2) uint8 z-buffered range image
    with per-row / per-column mean angular offset planes."""
    h, w = sensor.height, sensor.width
    _, fov_down, fov = sensor.fovs()
    pts = pts[:, :3].astype(np.float32)
    pts = pts[~np.isnan(pts).any(axis=1)]
    r = np.linalg.norm(pts, axis=-1)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r_safe = np.where(r > 0, r, 1.0)
    theta = -np.arctan2(y, x)
    phi = np.arcsin(np.clip(z / r_safe, -1.0, 1.0))
    colf = 0.5 * (theta / math.pi + 1.0) * w
    rowf = (1.0 - (phi + abs(fov_down)) / fov) * h
    row = np.floor(rowf + 0.53)
    col = np.floor(colf + 0.53) % w
    steps = np.round(r / RANGE_STEP)
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
    out = np.zeros((h * w + (h + w + 1) // 2, 2), np.uint8)
    out[pix[order], 0] = (steps[order] & 0xFF).astype(np.uint8)
    out[pix[order], 1] = (steps[order] >> 8).astype(np.uint8)
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


def decode_rimg8(buf: torch.Tensor, sensor: Sensor, dtype) -> torch.Tensor:
    """The rimg8 buffer -> its (H, W, 3) vertex map, empty pixels 0."""
    h, w = sensor.height, sensor.width
    _, fov_down, fov = sensor.fovs()
    dev = buf.device
    steps = buf[:h * w, 0].to(torch.int32) | (buf[:h * w, 1].to(torch.int32) << 8)
    tail = buf[h * w:h * w + (h + w + 1) // 2, :2].reshape(-1)
    rowq = tail[:h].to(dtype)
    colq = tail[h:h + w].to(dtype)
    pw = 2.0 * math.pi / w
    ph = fov / h
    col_idx = torch.arange(w, dtype=dtype, device=dev)
    row_idx = torch.arange(h, dtype=dtype, device=dev)
    theta_c = (2.0 * col_idx / w - 1.0) * math.pi + ((colq + 0.5) / 256.0 - 0.53) * pw
    phi_r = (1.0 - row_idx / h) * fov - abs(fov_down) + ((rowq + 0.5) / 256.0 - 0.47) * ph
    cos_t, sin_t = torch.cos(theta_c), torch.sin(theta_c)
    cos_p, sin_p = torch.cos(phi_r), torch.sin(phi_r)
    r_img = (steps.to(dtype) * RANGE_STEP).reshape(h, w)
    r_img = torch.where(steps.reshape(h, w) > 0, r_img, torch.zeros_like(r_img))
    return torch.stack([r_img * (cos_p[:, None] * cos_t[None, :]),
                        -r_img * (cos_p[:, None] * sin_t[None, :]),
                        r_img * sin_p[:, None]], dim=-1)


# -- geometry (ops/se3.py, ops/rotation.py, ops/geometry.py) ----------------

def euler_to_mat(a: torch.Tensor) -> torch.Tensor:
    """(3,) euler (ex, ey, ez) -> Rz @ Ry @ Rx."""
    cx, cy, cz = torch.cos(a)
    sx, sy, sz = torch.sin(a)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    return rz @ ry @ rx


def mat_to_euler(rot: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    sy = torch.sqrt(rot[0, 0] * rot[0, 0] + rot[1, 0] * rot[1, 0])
    singular = sy < eps
    x = torch.where(singular, torch.atan2(-rot[1, 2], rot[1, 1]),
                    torch.atan2(rot[2, 1], rot[2, 2]))
    y = torch.atan2(-rot[2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(rot[1, 0], rot[0, 0]))
    return torch.stack([x, y, z])


def pose_from_params(p: torch.Tensor) -> torch.Tensor:
    mat = torch.zeros((4, 4), dtype=p.dtype, device=p.device)
    mat[:3, :3] = euler_to_mat(p[3:])
    mat[:3, 3] = p[:3]
    mat[3, 3] = 1.0
    return mat


def params_from_pose(mat: torch.Tensor) -> torch.Tensor:
    return torch.cat([mat[:3, 3], mat_to_euler(mat[:3, :3])])


def normalize_pose(mat: torch.Tensor) -> torch.Tensor:
    return pose_from_params(params_from_pose(mat))


def inverse_pose(mat: torch.Tensor) -> torch.Tensor:
    rt = mat[:3, :3].T
    inv = torch.zeros_like(mat)
    inv[:3, :3] = rt
    inv[:3, 3] = -(rt @ mat[:3, 3])
    inv[3, 3] = 1.0
    return inv


def transform(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return points @ pose[:3, :3].T + pose[:3, 3]


def motion_magnitude(delta: torch.Tensor, lever_m: float = 15.0) -> torch.Tensor:
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    return torch.linalg.vector_norm(delta[:3, 3]) + (lever_m / 1.4142135) * \
        torch.linalg.vector_norm(delta[:3, :3] - eye)


def box_sum(image: torch.Tensor, k: int) -> torch.Tensor:
    """Window sum with zero padding over (H, W) of (H, W, C), taps added in
    row-major order (ops/geometry.py:22-39)."""
    h, w = image.shape[:2]
    pad = k // 2
    padded = torch.nn.functional.pad(image, (0, 0, pad, pad, pad, pad))
    out = torch.zeros_like(image)
    for dr in range(k):
        for dc in range(k):
            out = out + padded[dr:dr + h, dc:dc + w, :]
    return out


def normal_map(vmap: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Per-pixel plane fit (sum v v^T) n = sum v over a k x k window,
    normalized; singular windows and empty pixels 0 (ops/geometry.py:67-89)."""
    h, w, _ = vmap.shape
    v_box = box_sum(vmap, k)
    outer = (vmap[..., :, None] * vmap[..., None, :]).reshape(h, w, 9)
    m = box_sum(outer, k).reshape(h, w, 3, 3)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, hh, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * hh, c * hh - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * hh - e * g, b * g - a * hh, a * e - b * d], dim=-1)], dim=-2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    ok = torch.abs(det) > 1.0e-6
    inv = adj / torch.where(ok, det, torch.ones_like(det))[..., None, None]
    inv = torch.where(ok[..., None, None], inv, torch.zeros_like(inv))
    n = (inv @ v_box[..., None])[..., 0]
    norms = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    pos = norms > 0
    n = torch.where(pos, n / torch.where(pos, norms, torch.ones_like(norms)),
                    torch.zeros_like(n))
    n = torch.where(ok[..., None], n, torch.zeros_like(n))
    empty = torch.linalg.vector_norm(vmap, dim=-1, keepdim=True) == 0.0
    return torch.where(empty, torch.zeros_like(n), n)


def rasterize(points: torch.Tensor, valid_in: torch.Tensor, sensor: Sensor):
    """Closest point per pixel by one scatter-min of (quantized range,
    index) keys (slam/odometry/aggregated_map.py:138-175): the (H, W, 3)
    image of `points` and each pixel's winner index and hit flag."""
    h, w = sensor.height, sensor.width
    _, fov_down, fov = sensor.fovs()
    n = points.shape[0]
    r = torch.linalg.vector_norm(points, dim=-1)
    empty = r == 0.0
    r_safe = torch.where(empty, torch.full_like(r, 0.001), r)
    theta = -torch.atan2(points[:, 1], points[:, 0])
    phi = torch.asin(points[:, 2] / r_safe)
    cols = torch.where(empty, -1.0, 0.5 * (theta / math.pi + 1.0) * w)
    rows = torch.where(empty, -1.0, (1.0 - (phi + abs(fov_down)) / fov) * h)
    r = torch.where(empty, torch.zeros_like(r), r)
    rows, cols = torch.round(rows), torch.round(cols)
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1) & \
        (r > 0.0) & valid_in
    flat = torch.where(valid, rows.to(torch.int64) * w + cols.to(torch.int64),
                       torch.full_like(rows, h * w, dtype=torch.int64))
    qr = torch.clamp(r * ((1 << _RANGE_BITS) / 120.0),
                     max=(1 << _RANGE_BITS) - 1).to(torch.int32)
    key = (qr << _IDX_BITS) | torch.arange(n, dtype=torch.int32, device=points.device)
    key = torch.where(valid, key, torch.full_like(key, _SENTINEL))
    kmin = torch.full((h * w + 1,), _SENTINEL, dtype=torch.int32,
                      device=points.device).scatter_reduce(0, flat, key, "amin")[:h * w]
    hit = kmin != _SENTINEL
    idx = torch.clamp(kmin & ((1 << _IDX_BITS) - 1), 0, n - 1).to(torch.int64)
    return idx, hit


def gather_image(values: torch.Tensor, idx, hit, h: int, w: int) -> torch.Tensor:
    got = values[idx]
    mask = hit.reshape((-1,) + (1,) * (got.dim() - 1))
    return torch.where(mask, got, torch.zeros_like(got)).reshape((h, w) + got.shape[1:])


# -- the map and the registration ------------------------------------------

@dataclass
class MapState:
    xyz: torch.Tensor  # (H, W, 3) in the anchor keyframe's frame
    normal: torch.Tensor
    rng: torch.Tensor  # (H, W), 0 = empty
    age: torch.Tensor  # (H, W) int32
    anchor_from_cur: torch.Tensor  # (4, 4)


def insert_scan(state: MapState, vmap, nmap, rimg, new_from_old, sensor: Sensor,
                max_age: int) -> MapState:
    """The scan becomes the anchor; the old model is moved into its frame,
    re-rasterized once (pixels at `max_age` inserts or older dropped first)
    and merged pixel by pixel, the closer range winning
    (slam/odometry/aggregated_map.py:208-261)."""
    h, w = sensor.height, sensor.width
    old_pts = state.xyz.reshape(-1, 3)
    old_age = state.age.reshape(-1)
    old_valid = (state.rng.reshape(-1) > 0) & (old_age < max_age)
    moved = transform(old_pts, new_from_old)
    moved_nrm = state.normal.reshape(-1, 3) @ new_from_old[:3, :3].T
    idx, hit = rasterize(moved, old_valid, sensor)
    o_xyz = gather_image(moved, idx, hit, h, w)
    o_nrm = gather_image(moved_nrm, idx, hit, h, w)
    o_age = gather_image(old_age, idx, hit, h, w)
    o_rng = torch.linalg.vector_norm(o_xyz, dim=-1)
    take_old = (o_rng > 0) & ((rimg <= 0) | (o_rng < rimg))
    rng = torch.where(take_old, o_rng, rimg)
    age = torch.where(take_old, o_age + 1, torch.zeros_like(o_age))
    age = torch.where(rng > 0, age, torch.zeros_like(age))
    return MapState(xyz=torch.where(take_old[..., None], o_xyz, vmap),
                    normal=torch.where(take_old[..., None], o_nrm, nmap),
                    rng=rng, age=age,
                    anchor_from_cur=torch.eye(4, dtype=vmap.dtype, device=vmap.device))


def normal_equations(timg, state: MapState, wr: int, wc: int, max_nd: float,
                     sigma: float, eps: float):
    """Window association (each target pixel's closest valid model pixel
    among rows r-wr..r+wr and columns c-wc..c+wc, columns wrapping in
    azimuth, the first minimum winning in row-major window order), then the
    Geman-McClure weighted point-to-plane system at the zero delta
    (ops/kernels/assoc_gn.py:30-116): (H (6, 6), g (6,), matches)."""
    h, w, _ = timg.shape
    tgt_valid = torch.amax(torch.abs(timg), dim=-1) > 0
    model_valid = state.rng > 0

    def pad(img):
        cols = torch.cat([img[:, w - wc:], img, img[:, :wc]], dim=1)
        zeros = cols.new_zeros((wr,) + cols.shape[1:])
        return torch.cat([zeros, cols, zeros], dim=0)

    px, pn, pv = pad(state.xyz), pad(state.normal), pad(model_valid[..., None])[..., 0]
    offsets = [(wr - dr, wc - dc) for dr in range(-wr, wr + 1) for dc in range(-wc, wc + 1)]
    cand = torch.stack([px[r0:r0 + h, c0:c0 + w] for r0, c0 in offsets])
    cvalid = torch.stack([pv[r0:r0 + h, c0:c0 + w] for r0, c0 in offsets])
    e = timg[None] - cand
    d = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    d = torch.where(cvalid & tgt_valid[None], d, math.inf)
    best = torch.argmin(d, dim=0)
    best_d = torch.gather(d, 0, best[None])[0]
    nrm_stack = torch.stack([pn[r0:r0 + h, c0:c0 + w] for r0, c0 in offsets])
    sel = best[None, ..., None].expand(1, h, w, 3)
    ref = torch.gather(cand, 0, sel)[0].reshape(-1, 3)
    nrm = torch.gather(nrm_stack, 0, sel)[0].reshape(-1, 3)
    ok = (torch.isfinite(best_d) & (best_d <= max_nd * max_nd)).reshape(-1) & \
        (torch.amax(torch.abs(nrm), dim=-1) > 0)
    tp = timg.reshape(-1, 3)
    zero = torch.zeros((), dtype=tp.dtype, device=tp.device)
    res = torch.where(ok, torch.sum((tp - ref) * nrm, dim=-1), zero)
    jac = torch.where(ok[:, None], torch.cat([nrm, torch.linalg.cross(tp, nrm)], dim=-1),
                      zero)
    r2 = res * res
    wgt = torch.sqrt(sigma * r2 / (sigma + r2)) / torch.clamp(torch.abs(res), min=eps)
    wres, wjac = res * wgt, jac * wgt[:, None]
    return wjac.T @ wjac, wjac.T @ wres, ok.sum()


def solve(hmat: torch.Tensor, g: torch.Tensor, det_threshold: float = 1.0e-7):
    """dx = -H^-1 g by Cholesky; a singular system gives None
    (ops/optimization.py:163-181).  Solved in float32 at least."""
    dt = hmat.dtype
    h32, g32 = hmat.to(torch.float32), g.to(torch.float32)
    chol, info = torch.linalg.cholesky_ex(h32)
    det = torch.prod(torch.diagonal(chol)) ** 2
    if int(info) != 0 or float(torch.abs(det)) < det_threshold:
        return None
    return (-torch.cholesky_solve(g32[:, None], chol)[:, 0]).to(dt)


class AggregatedOdometry:
    """The odometry over a stream of scans: ``step(cloud)`` registers the
    next scan and returns its relative pose (previous frame <- this frame)
    as float32 euler params, as the program logs them."""

    def __init__(self, program: dict, sensor: Sensor, device, dtype=torch.float32):
        odo = program
        lm = odo["local_map"]
        gn = odo["alignment"]["gauss_newton_config"]
        if lm.get("type") != "aggregated_local_map" or \
                odo.get("upload_format") != "rimg8" or gn.get("scheme") != "geman_mcclure":
            raise ValueError("the reference runs the aggregated map on rimg8 "
                             "uploads with Geman-McClure weights")
        self.sensor, self.device, self.dtype = sensor, device, dtype
        self.trips = int(odo["max_num_alignments"])
        self.reassoc_every = int(odo["reassoc_every"])
        self.reassoc_motion = float(odo["reassoc_motion_m"])
        self.max_age = int(lm.get("local_map_size", 20))
        self.wr, self.wc = int(lm["window_rows"]), int(lm["window_cols"])
        self.max_nd = float(lm["max_neighbor_dist"])
        self.nks = int(lm.get("normals_kernel_size", 5))
        self.sigma = float(gn["sigma"])
        self.eps = float(gn.get("eps", 1.0e-4))
        self.thr_delta = float(odo.get("threshold_delta_pose", 1.0e-4))
        self.thr_trans = float(odo.get("threshold_trans", 0.1))
        self.thr_rot = float(odo.get("threshold_rot", 0.3))
        self.boot = odo.get("ei_bootstrap", True)
        self._images = {}
        self.state: Optional[MapState] = None
        self.prev_cloud = None
        self.delta = None
        self.last_rpose = None
        self.frame = 0

    def scan_images(self, key, cloud: np.ndarray):
        """(vertex map, normal map, range image) of a scan, decoded from its
        rimg8 encoding; kept per `key` (a scan that repeats is read once)."""
        if key not in self._images:
            buf = torch.as_tensor(encode_rimg8(cloud, self.sensor), device=self.device)
            vmap = decode_rimg8(buf, self.sensor, self.dtype)
            self._images[key] = (vmap, normal_map(vmap, self.nks),
                                 torch.linalg.vector_norm(vmap, dim=-1))
        return self._images[key]

    def bootstrap(self, prev: np.ndarray, cur: np.ndarray) -> Optional[torch.Tensor]:
        """Frame 1's prior from BEV phase correlation of ground-suppressed
        128-pixel images at 0.5 m, over 64 yaws in +-60 degrees
        (slam/odometry/icp_odometry.py:419-451)."""
        size, px = 128, 0.5

        def image(cloud):
            p = torch.as_tensor(cloud[:, :3], dtype=torch.float32, device=self.device)
            return bev.build_elevation_image(p, bev.ground_suppressed_mask(p), px, size)

        res = bev.register_bev(image(prev), image(cur), num_yaw_steps=64,
                               yaw_range=1.0472)
        mat = bev.bev_transform_to_se3(res, px)
        score, tx, ty = torch.stack([res.score, mat[0, 3], mat[1, 3]]).tolist()
        if score < 0.05 or math.hypot(tx, ty) > 0.4 * size * px:
            return None
        return mat.to(self.dtype)

    def register(self, points: torch.Tensor, t_init: torch.Tensor) -> torch.Tensor:
        """The fixed number of GN trips from `t_init` (anchor <- scan), the
        target re-rasterized into the anchor grid when the pose moved more
        than `reassoc_motion` since the last rasterization, or every
        `reassoc_every` trips; stops once a delta falls under the
        threshold (slam/odometry/aggregated_map.py:385-428)."""
        h, w = self.sensor.height, self.sensor.width
        valid = torch.amax(torch.abs(points), dim=-1) > 0

        def raster(t):
            q = transform(points, t)
            idx, hit = rasterize(q, valid, self.sensor)
            return gather_image(q, idx, hit, h, w)

        t = t_init
        timg0, t_round = raster(t), t
        for k in range(self.trips):
            if k > 0 and (k % self.reassoc_every == 0 or (
                    self.reassoc_motion > 0.0 and float(motion_magnitude(
                        t @ inverse_pose(t_round))) > self.reassoc_motion)):
                timg0, t_round = raster(t), t
            delta = t @ inverse_pose(t_round)
            tvalid = torch.amax(torch.abs(timg0), dim=-1, keepdim=True) > 0
            moved = transform(timg0.reshape(-1, 3), delta).reshape(h, w, 3)
            timg = torch.where(tvalid, moved, torch.zeros_like(moved))
            hmat, g, _ = normal_equations(timg, self.state, self.wr, self.wc,
                                          self.max_nd, self.sigma, self.eps)
            dx = solve(hmat, g)
            if dx is None or float(torch.linalg.vector_norm(dx.float())) < self.thr_delta:
                break
            t = normalize_pose(pose_from_params(dx) @ t)
        return t

    def step(self, key, cloud: np.ndarray) -> np.ndarray:
        vmap, nmap, rimg = self.scan_images(key, cloud)
        dev, dt = self.device, self.dtype
        eye = torch.eye(4, dtype=dt, device=dev)
        if self.frame == 0:
            h, w = self.sensor.height, self.sensor.width
            empty = MapState(xyz=torch.zeros_like(vmap), normal=torch.zeros_like(vmap),
                             rng=torch.zeros_like(rimg),
                             age=torch.zeros((h, w), dtype=torch.int32, device=dev),
                             anchor_from_cur=eye)
            self.state = insert_scan(empty, vmap, nmap, rimg, eye, self.sensor, self.max_age)
            self.delta, self.last_rpose = eye, eye
            self.prev_cloud = cloud
            self.frame = 1
            return np.zeros(6, np.float32)
        init = self.last_rpose
        if self.frame == 1 and self.boot:
            boot = self.bootstrap(self.prev_cloud, cloud)
            init = init if boot is None else boot
            self.prev_cloud = None
        t_final = self.register(vmap.reshape(-1, 3), self.state.anchor_from_cur @ init)
        rpose = inverse_pose(self.state.anchor_from_cur) @ t_final
        params = params_from_pose(rpose)
        new_delta = self.delta @ rpose
        d = params_from_pose(new_delta)
        insert = float(torch.linalg.vector_norm(d[:3])) > self.thr_trans or \
            float(torch.linalg.vector_norm(d[3:])) * 180.0 / math.pi > self.thr_rot
        if insert:
            self.state = insert_scan(self.state, vmap, nmap, rimg, inverse_pose(t_final),
                                     self.sensor, self.max_age)
            self.delta = eye
        else:
            self.state.anchor_from_cur = t_final
            self.delta = new_delta
        self.last_rpose = rpose
        self.frame += 1
        return params.float().cpu().numpy()


def pose_matrix_f64(params: np.ndarray) -> np.ndarray:
    """Float64 pose matrix from euler params, as the program builds its
    float64 poses (slam/odometry/icp_odometry.py:944-958)."""
    tx, ty, tz, ex, ey, ez = np.asarray(params, np.float64)
    cx, sx, cy, sy, cz, sz = (np.cos(ex), np.sin(ex), np.cos(ey), np.sin(ey),
                              np.cos(ez), np.sin(ez))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    mat = np.eye(4)
    mat[:3, :3] = rz @ ry @ rx
    mat[:3, 3] = [tx, ty, tz]
    return mat


def run(program: dict, sensor: Sensor, clouds: List[np.ndarray], frames: int,
        device, dtype=torch.float32) -> np.ndarray:
    """(frames, 6) params of the reference odometry over frames 0..frames-1
    of the endless drive, frame i being scan i mod len(clouds)."""
    odo = AggregatedOdometry(program, sensor, device, dtype)
    n = len(clouds)
    return np.stack([odo.step(i % n, clouds[i % n]) for i in range(frames)])
