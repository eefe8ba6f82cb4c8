"""The benchmark's one traffic generator: a procedural urban world (a ground
plane, vertical walls, round pillars), a route through it, and the
occlusion-aware scans of a rotating multi-beam LiDAR driven along the route,
all made from the run's seed.

Frozen from ``pylidar_slam_tpu_torch/dataset/synthetic.py``: the world's
primitives and their size ranges (``SyntheticWorld.__init__``, :51-70), the
raycaster (``SyntheticWorld.raycast``, :72-118), the beam pattern at the
pixel centres (``SyntheticSequence.__init__``, :161-176) and the per-point
range noise (``__getitem__``, :209-212).  What differs:

- the rays are cast on the card, in float64, against all primitives of a
  kind in one broadcast, and the noise comes from a ``torch.Generator`` on
  the card: the same seed gives the same scans;
- the route is a parameter of the traffic mix and closes on itself after
  ``cycle_frames`` frames: a ``circle`` returns to its start, and a ``sine``
  road runs through a world that repeats every cycle along x.  Scan i+N is
  scan i, so a run draws on N precomputed scans however many it takes;
- no primitive lies within ``corridor_m`` of the route, so the sensor never
  drives through a wall.

A traffic file (``slambench/traffic/<name>.json``) holds ``route`` and
``world``; the sensor comes from the configuration.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

GROUND_Z = -1.73  # the sensor's height above the ground, KITTI's


class Scans(NamedTuple):
    clouds: List[np.ndarray]  # N (n_i, 3) float32 point clouds, sensor frame
    poses: np.ndarray  # (N, 4, 4) float64 ground-truth poses of the cycle
    period: np.ndarray  # (4, 4) pose of scan i+N relative to scan i's world


def _seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def route_poses(route: dict, n: int) -> np.ndarray:
    """(n, 4, 4) poses of one cycle of the route, and the drive is at
    ``speed_m`` a frame (the circle's exact arc, the sine road's x step)."""
    speed = float(route["speed_m"])
    shape = route["shape"]
    poses = np.tile(np.eye(4), (n, 1, 1))
    i = np.arange(n, dtype=np.float64)
    if shape == "circle":
        radius = n * speed / (2.0 * math.pi)
        ang = 2.0 * math.pi * i / n
        # starts at the origin heading +x, turning left
        poses[:, 0, 3] = radius * np.sin(ang)
        poses[:, 1, 3] = radius * (1.0 - np.cos(ang))
        yaw = ang
    elif shape == "sine":
        length = n * speed
        amp = float(route["amplitude_m"])
        x = i * speed
        k = 2.0 * math.pi / length
        poses[:, 0, 3] = x
        poses[:, 1, 3] = amp * np.sin(k * x)
        yaw = np.arctan(amp * k * np.cos(k * x))
    else:
        raise ValueError(f"unknown route shape {shape!r}: circle or sine")
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    return poses


def _route_distance(route: dict, n: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Distance of (x, y) points from the route's centre line (the sine
    road's by its vertical offset, which is within 2% for its slopes)."""
    if route["shape"] == "circle":
        radius = n * float(route["speed_m"]) / (2.0 * math.pi)
        return np.abs(np.hypot(x, y - radius) - radius)
    length = n * float(route["speed_m"])
    return np.abs(y - float(route["amplitude_m"]) * np.sin(2.0 * math.pi * x / length))


def make_world(route: dict, world: dict, n: int, seed: int):
    """(walls (K, 5): cx, cy, angle, half length, height; pillars (P, 4):
    cx, cy, radius, height) as float64 numpy, drawn from the seed, with no
    primitive within ``corridor_m`` of the route.  A ``sine`` road's world is
    one cycle long and repeats along x, so it is returned with its copies
    one cycle before and after."""
    rng = _seed_rng(seed)
    corridor = float(world["corridor_m"])
    half_w = float(world["half_width_m"])
    if route["shape"] == "circle":
        radius = n * float(route["speed_m"]) / (2.0 * math.pi)
        x_lo, x_hi = -radius - half_w, radius + half_w
        y_lo, y_hi = radius - (radius + half_w), radius + (radius + half_w)
    else:
        x_lo, x_hi = 0.0, n * float(route["speed_m"])
        y_lo, y_hi = -half_w, half_w

    def clear(xs, ys, margin):
        return bool(np.all(_route_distance(route, n, xs, ys) > corridor + margin))

    walls = []
    lo_len, hi_len = world["wall_half_len_m"]
    lo_h, hi_h = world["wall_height_m"]
    while len(walls) < int(world["num_walls"]):
        cx, cy = rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)
        angle = rng.uniform(0.0, math.pi)
        half = rng.uniform(lo_len, hi_len)
        height = rng.uniform(lo_h, hi_h)
        u = np.linspace(-half, half, 33)
        if clear(cx + u * math.cos(angle), cy + u * math.sin(angle), 0.0):
            walls.append((cx, cy, angle, half, height))
    pillars = []
    lo_r, hi_r = world["pillar_radius_m"]
    lo_ph, hi_ph = world["pillar_height_m"]
    while len(pillars) < int(world["num_pillars"]):
        cx, cy = rng.uniform(x_lo, x_hi), rng.uniform(y_lo, y_hi)
        radius = rng.uniform(lo_r, hi_r)
        height = rng.uniform(lo_ph, hi_ph)
        if clear(np.array([cx]), np.array([cy]), radius):
            pillars.append((cx, cy, radius, height))
    walls, pillars = np.array(walls, np.float64), np.array(pillars, np.float64)
    if route["shape"] == "sine":
        length = n * float(route["speed_m"])
        walls = np.concatenate([walls + [dx, 0, 0, 0, 0] for dx in (-length, 0.0, length)])
        pillars = np.concatenate([pillars + [dx, 0, 0, 0] for dx in (-length, 0.0, length)])
    return walls, pillars


def beam_directions(sensor: dict, device) -> torch.Tensor:
    """(H*W, 3) float64 unit rays at the pixel centres, row-major, the
    first row the highest beam and columns turning clockwise from -x."""
    h, w = int(sensor["lidar_height"]), int(sensor["lidar_width"])
    fov_up = math.radians(float(sensor["up_fov"]))
    fov_down = math.radians(float(sensor["down_fov"]))
    rows = (torch.arange(h, dtype=torch.float64, device=device) + 0.5) / h
    cols = (torch.arange(w, dtype=torch.float64, device=device) + 0.5) / w
    phi = (1.0 - rows) * (abs(fov_down) + abs(fov_up)) - abs(fov_down)
    theta = -(2.0 * cols - 1.0) * math.pi
    phi_g, theta_g = torch.meshgrid(phi, theta, indexing="ij")
    return torch.stack([torch.cos(phi_g) * torch.cos(theta_g),
                        torch.cos(phi_g) * torch.sin(theta_g),
                        torch.sin(phi_g)], dim=-1).reshape(-1, 3)


def raycast(walls: torch.Tensor, pillars: torch.Tensor, origin: torch.Tensor,
            dirs: torch.Tensor, max_range: float) -> torch.Tensor:
    """Ranges (n,) of world rays from `origin` (3,) along unit `dirs` (n, 3)
    to the nearest ground, wall or pillar hit; inf for no hit within
    `max_range`.  The conditions are ``SyntheticWorld.raycast``'s."""
    inf = torch.full_like(dirs[:, 0], math.inf)
    ox, oy, oz = origin[0], origin[1], origin[2]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    t = (GROUND_Z - oz) / dirs[:, 2]
    best = torch.where((dirs[:, 2] < -1e-8) & (t > 0.1), t, inf)

    cx, cy, ang, half, height = walls.T
    nx, ny, ux, uy = -torch.sin(ang), torch.cos(ang), torch.cos(ang), torch.sin(ang)
    denom = dx * nx + dy * ny
    t = ((cx - ox) * nx + (cy - oy) * ny) / denom
    along = (ox + t * dx - cx) * ux + (oy + t * dy - cy) * uy
    pz = oz + t * dz
    hit = (denom.abs() > 1e-8) & (t > 0.1) & (along.abs() < half) & \
        (pz > GROUND_Z) & (pz < GROUND_Z + height)
    best = torch.minimum(best, torch.where(hit, t, math.inf).amin(dim=1))

    cx, cy, rad, height = pillars.T
    px, py = ox - cx, oy - cy
    a = dx * dx + dy * dy
    b = 2.0 * (px * dx + py * dy)
    c = px * px + py * py - rad * rad
    disc = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(disc.clamp(min=0.0))) / (2.0 * a)
    pz = oz + t * dz
    hit = (disc > 0) & (a > 1e-10) & (t > 0.1) & (pz > GROUND_Z) & \
        (pz < GROUND_Z + height)
    best = torch.minimum(best, torch.where(hit, t, math.inf).amin(dim=1))
    return torch.where(best < max_range, best, inf)


def make_scans(traffic: dict, sensor: dict, seed: int, device) -> Scans:
    """The route's cycle of scans, raycast on `device` from `seed`, handed
    back as host float32 clouds in the sensor frame."""
    route, world = traffic["route"], traffic["world"]
    n = int(route["cycle_frames"])
    poses = route_poses(route, n)
    walls, pillars = make_world(route, world, n, seed)
    walls_t = torch.as_tensor(walls, device=device)
    pillars_t = torch.as_tensor(pillars, device=device)
    dirs = beam_directions(sensor, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    noise_std = float(sensor["noise_std_m"])
    max_range = float(sensor["max_range_m"])
    poses_t = torch.as_tensor(poses, device=device)
    clouds, counts = [], []
    for k in range(n):
        rot, origin = poses_t[k, :3, :3], poses_t[k, :3, 3]
        ranges = raycast(walls_t, pillars_t, origin, dirs @ rot.T, max_range)
        noise = torch.randn(ranges.shape, generator=gen, dtype=torch.float64,
                            device=device)
        hit = torch.isfinite(ranges)
        pts = (dirs * (ranges + noise_std * noise)[:, None])[hit]
        clouds.append(pts.to(torch.float32))
        counts.append(pts.shape[0])
    flat = torch.cat(clouds).cpu().numpy()
    out = np.split(flat, np.cumsum(counts)[:-1])
    period = np.eye(4)
    if route["shape"] == "sine":
        period[0, 3] = n * float(route["speed_m"])
    return Scans([np.ascontiguousarray(c) for c in out], poses, period)


def pose_of_frame(scans: Scans, i: int) -> np.ndarray:
    """Ground-truth world pose of frame i of the endless drive."""
    n = len(scans.clouds)
    lap = np.linalg.matrix_power(scans.period, i // n)
    return lap @ scans.poses[i % n]
