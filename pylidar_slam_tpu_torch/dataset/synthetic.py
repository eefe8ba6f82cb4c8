"""Synthetic LiDAR dataset: occlusion-aware raycasts of a procedural world
(numpy port of ``pylidar_slam_tpu.dataset.synthetic``; same seeds, same
frames).

Deterministic KITTI-like scans (64-beam rotating LiDAR) with exact
ground-truth trajectories.  The world is a ground plane plus random vertical
walls and cylindrical pillars; each frame raycasts the full beam pattern
against every primitive so occlusions and viewpoint changes behave like real
data.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from pylidar_slam_tpu_torch.config import dataclass_from_dict
from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig, DatasetLoader
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops import se3
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection


@dataclass
class SyntheticConfig(DatasetConfig):
    dataset: str = "synthetic"
    lidar_height: int = 64
    lidar_width: int = 1024
    up_fov: float = 3.0
    down_fov: float = -24.0
    num_frames: int = 100
    seed: int = 0
    num_walls: int = 30
    num_pillars: int = 20
    world_size: float = 120.0
    max_range: float = 70.0
    noise_std: float = 0.008  # per-point range noise (m)
    speed: float = 1.1  # meters / frame (KITTI ~ 10 Hz * 11 m/s)
    # Rolling shutter: each azimuth column is raycast from the pose
    # interpolated between this frame's pose and the next (alpha = col /
    # width).  GT poses stay the scan-START poses.
    skew: bool = False
    turn_rate: float = 0.03  # max |yaw rate| rad/frame of the trajectory
    # Per-beam angular de-calibration (degrees, 1-sigma, fixed per sequence).
    beam_jitter_deg: float = 0.0
    train_sequences: list = field(default_factory=lambda: ["synth_00"])
    eval_sequences: list = field(default_factory=lambda: ["synth_00"])
    test_sequences: list = field(default_factory=lambda: ["synth_00"])


class SyntheticWorld:
    """A procedural world of a ground plane, walls and pillars."""

    def __init__(self, cfg: SyntheticConfig, seed: int):
        rng = np.random.default_rng(seed)
        s = cfg.world_size
        self.walls = []
        for _ in range(cfg.num_walls):
            cx, cy = rng.uniform(-s, s, 2)
            if math.hypot(cx, cy) < 8.0:
                cx += 12.0  # keep spawn area clear
            angle = rng.uniform(0, math.pi)
            half_len = rng.uniform(4.0, 18.0)
            height = rng.uniform(2.5, 9.0)
            self.walls.append((cx, cy, angle, half_len, height))
        self.pillars = []
        for _ in range(cfg.num_pillars):
            cx, cy = rng.uniform(-s, s, 2)
            if math.hypot(cx, cy) < 6.0:
                cy += 10.0
            radius = rng.uniform(0.25, 1.2)
            height = rng.uniform(3.0, 10.0)
            self.pillars.append((cx, cy, radius, height))
        self.ground_z = -1.73  # sensor height above ground, KITTI-like

    def raycast(self, origins: np.ndarray, dirs: np.ndarray,
                max_range: float) -> np.ndarray:
        """Casts rays (N, 3 origin; N, 3 unit dirs) -> (N,) ranges (inf = miss)."""
        n = dirs.shape[0]
        t_best = np.full(n, max_range, dtype=np.float64)

        # Ground plane z = ground_z
        dz = dirs[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.ground_z - origins[:, 2]) / dz
        hit = (dz < -1e-8) & (t > 0.1) & (t < t_best)
        t_best = np.where(hit, t, t_best)

        # Walls: plane with normal (nx, ny, 0); bounded rectangle.
        for cx, cy, angle, half_len, height in self.walls:
            nx, ny = -math.sin(angle), math.cos(angle)
            ux, uy = math.cos(angle), math.sin(angle)
            denom = dirs[:, 0] * nx + dirs[:, 1] * ny
            num = (cx - origins[:, 0]) * nx + (cy - origins[:, 1]) * ny
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            px = origins[:, 0] + t * dirs[:, 0] - cx
            py = origins[:, 1] + t * dirs[:, 1] - cy
            pz = origins[:, 2] + t * dirs[:, 2]
            along = px * ux + py * uy
            hit = (np.abs(denom) > 1e-8) & (t > 0.1) & (t < t_best) & \
                  (np.abs(along) < half_len) & (pz > self.ground_z) & \
                  (pz < self.ground_z + height)
            t_best = np.where(hit, t, t_best)

        # Pillars: |o_xy + t d_xy - c|^2 = r^2
        for cx, cy, radius, height in self.pillars:
            ox = origins[:, 0] - cx
            oy = origins[:, 1] - cy
            a = dirs[:, 0] ** 2 + dirs[:, 1] ** 2
            b = 2 * (ox * dirs[:, 0] + oy * dirs[:, 1])
            c = ox * ox + oy * oy - radius * radius
            disc = b * b - 4 * a * c
            with np.errstate(divide="ignore", invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                t = (-b - sq) / (2 * a)
            pz = origins[:, 2] + t * dirs[:, 2]
            hit = (disc > 0) & (a > 1e-10) & (t > 0.1) & (t < t_best) & \
                  (pz > self.ground_z) & (pz < self.ground_z + height)
            t_best = np.where(hit, t, t_best)

        t_best[t_best >= max_range] = np.inf
        return t_best


def make_trajectory(num_frames: int, speed: float, seed: int,
                    turn_rate: float = 0.03) -> np.ndarray:
    """A smooth (N, 4, 4) trajectory with gentle turns (float64 absolutes)."""
    rng = np.random.default_rng(seed + 1)
    yaw_rate = 0.0
    yaw = 0.0
    pos = np.zeros(3)
    poses = [np.eye(4)]  # first pose is the identity (KITTI GT convention)
    for _ in range(num_frames - 1):
        yaw_rate = 0.95 * yaw_rate + 0.2 * turn_rate * rng.standard_normal()
        yaw_rate = np.clip(yaw_rate, -turn_rate, turn_rate)
        yaw += yaw_rate
        direction = np.array([math.cos(yaw), math.sin(yaw), 0.0])
        pos = pos + speed * direction
        mat = np.eye(4)
        mat[:3, :3] = np.array([
            [math.cos(yaw), -math.sin(yaw), 0.0],
            [math.sin(yaw), math.cos(yaw), 0.0],
            [0.0, 0.0, 1.0]])
        mat[:3, 3] = pos
        poses.append(mat)
    return np.stack(poses)


class SyntheticSequence:
    """Map-style dataset of raycast scans with GT poses."""

    def __init__(self, cfg: SyntheticConfig, sequence_id: str, seed: int):
        self.cfg = cfg
        self.id = sequence_id
        self.world = SyntheticWorld(cfg, seed)
        self.poses_gt = make_trajectory(cfg.num_frames, cfg.speed, seed,
                                        turn_rate=float(cfg.turn_rate))
        self._noise_rng_seed = seed + 2

        h, w = cfg.lidar_height, cfg.lidar_width
        fov_up = math.radians(cfg.up_fov)
        fov_down = math.radians(cfg.down_fov)
        # Beam directions in the sensor frame at the pixel centers.
        rows = (np.arange(h) + 0.5) / h
        cols = (np.arange(w) + 0.5) / w
        phi = (1.0 - rows) * (abs(fov_down) + abs(fov_up)) - abs(fov_down)
        theta = -(2.0 * cols - 1.0) * math.pi
        phi_g, theta_g = np.meshgrid(phi, theta, indexing="ij")
        if cfg.beam_jitter_deg:
            jit_rng = np.random.default_rng(seed + 7)
            j = math.radians(float(cfg.beam_jitter_deg))
            phi_g = phi_g + j * jit_rng.standard_normal(phi_g.shape)
            theta_g = theta_g + j * jit_rng.standard_normal(theta_g.shape)
        self.dirs = np.stack([
            np.cos(phi_g) * np.cos(theta_g),
            np.cos(phi_g) * np.sin(theta_g),
            np.sin(phi_g),
        ], axis=-1).reshape(-1, 3)

    def __len__(self):
        return self.cfg.num_frames

    def __getitem__(self, idx) -> dict:
        pose = self.poses_gt[idx]
        n = self.dirs.shape[0]
        if self.cfg.skew:
            # Column c is captured at alpha = c / W along the motion to the
            # next pose; points are in the PER-COLUMN sensor frame.
            nxt = self.poses_gt[min(idx + 1, len(self.poses_gt) - 1)]
            rel = np.linalg.solve(pose, nxt)
            w = self.cfg.lidar_width
            interp = se3.PosesInterpolator(
                np.stack([np.eye(4), rel]), np.array([0.0, 1.0]))
            col_poses = interp(np.arange(w) / w)
            col_of_ray = np.tile(np.arange(w), self.cfg.lidar_height)
            per_ray = (pose @ col_poses)[col_of_ray]
            world_dirs = np.einsum("nij,nj->ni", per_ray[:, :3, :3], self.dirs)
            origins = per_ray[:, :3, 3]
        else:
            world_dirs = self.dirs @ pose[:3, :3].T
            origins = np.broadcast_to(pose[:3, 3], (n, 3))
        ranges = self.world.raycast(origins, world_dirs, self.cfg.max_range)
        hit = np.isfinite(ranges)
        rng = np.random.default_rng(self._noise_rng_seed + idx)
        noisy = ranges[hit] + self.cfg.noise_std * rng.standard_normal(hit.sum())
        points = (self.dirs[hit] * noisy[:, None]).astype(np.float32)
        return {
            self.cfg.numpy_pc_key: points,
            self.cfg.absolute_gt_key: pose.copy(),
        }


class SyntheticDatasetLoader(DatasetLoader):
    def __init__(self, config: SyntheticConfig):
        if not isinstance(config, SyntheticConfig):
            config = dataclass_from_dict(SyntheticConfig, config)
        super().__init__(config)

    def projector(self) -> SphericalProjection:
        cfg = self.config
        return SphericalProjection(height=cfg.lidar_height, width=cfg.lidar_width,
                                   up_fov=cfg.up_fov, down_fov=cfg.down_fov)

    @property
    def grid_regular(self) -> bool:
        # The raycaster fires on the exact projector grid unless beam
        # jitter is simulated.
        return float(self.config.beam_jitter_deg) == 0.0

    def _make(self, names: List[str]):
        if not names:
            return None
        return [SyntheticSequence(self.config, name,
                                  seed=self.config.seed + i * 1000)
                for i, name in enumerate(names)]

    def sequences(self):
        train = self.config.train_sequences
        return ((self._make(train), train),
                (self._make(self.config.eval_sequences), self.config.eval_sequences),
                (self._make(self.config.test_sequences), self.config.test_sequences),
                lambda x: x)

    def get_ground_truth(self, sequence_name):
        names = self.config.train_sequences
        idx = names.index(sequence_name) if sequence_name in names else 0
        seq = SyntheticSequence(self.config, sequence_name,
                                seed=self.config.seed + idx * 1000)
        return compute_relative_poses(seq.poses_gt)
