"""The plain reference of the surfel-ring ("kdtree_local_map") frame-to-model
ICP odometry: what ``ICPFrameToModel`` with a ``kdtree_local_map``, exact
nearest neighbours and k-NN map normals computes for a stream of scans,
written as straightforward PyTorch with host control flow.

It imports nothing of the program.  What it computes is what the map's
docstrings state (``pylidar_slam_tpu_torch/slam/odometry/surfel_map.py``):

- a fixed-capacity grid sample of each scan (its ICP targets, at
  ``target_voxel_size``) and of its z-buffered raster (its map points, at
  ``sample_voxel_size``): the first point of each voxel wins; with more
  winners than slots, the kept subset follows the XOR hash of their floor
  voxel coordinates under a stable sort;
- a ring of ``local_map_size`` slots of ``points_per_frame`` points held in
  the frame of a past insert (the anchor), re-expressed in the current
  frame when the anchor falls ``reanchor_dist`` behind;
- on every GN trip the exact nearest valid map point of each target (the
  first minimum of the squared distance, summed as the program's kernel
  sums it), a pair counting where it lies within ``max_neighbor_dist``;
  neighborhood weights, the 6x6 solve, and the early exit on the host;
- the insert thresholds, and the BEV bootstrap of frame 1 (the aggregated
  map's reference's, ``reference/odometry.py``);
- map normals from a plane fit over the ``num_neighbors_normals`` nearest
  valid map points, the new points included, with no bound on their
  distance: upstream's KD-tree query (Kitware/pyLiDAR-SLAM
  ``slam/odometry/local_map.py``, ``KdTreeLocalMap``).

Its one departure from the program: the program finds those neighbours in
a voxel-hash grid (``ops/hash_nn.py``, buckets of ``hash_capacity``
slots), which equals brute force within ``max_neighbor_dist`` unless a
bucket overflows, and past that distance takes the nearest points of its
probed 2x2x2 block.  The points a full bucket leaves out are counted
(``surfel.knn_dropped`` in the program's registry, PERF.md section 3);
where they are many, the two fit their normals over other neighbours.

The arithmetic of the voxel keys, the raster, the plane fit and the pose
helpers is a frozen copy of the program's (each function names its origin
under ``pylidar_slam_tpu_torch/``).  The searches are computed by tiles of
the targets: a tile's candidates are the map points within its box grown
by the search's radius, and a query whose answer that radius cannot vouch
for is searched again against the whole map.

``dtype`` sets the precision of every map, point and pose tensor; the
control runs it in bfloat16 (the 6x6 Cholesky solve and the BEV bootstrap
stay in float32).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from slambench.reference import odometry as ref
from slambench.reference.odometry import Sensor

HASH_PRIMES = (73856093, 19349669, 83492791)  # ops/voxel.py:16
TILE_M = 16.0  # edge of a tile of targets in x and y
PAIRS_PER_BLOCK = 1 << 25  # (query, candidate) pairs held at once
KNN_RADIUS_M = 2.0  # the k-NN's candidates: a tile's box grown by this
_ROUNDING = 1.0 - 1.0e-5  # a distance this close to a radius is not vouched for


# -- voxel keys and the fixed-capacity grid sample (ops/voxel.py:28-66,
#    slam/odometry/surfel_map.py _grid_sample_fixed) --------------------------

def voxel_keys(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """The int32 wrap-around hash of each point's voxel, rounded half to
    even from a float32 product with 1 / voxel, held in int64."""
    scaled = torch.stack([points[:, i] * (1.0 / voxel) for i in range(3)], dim=-1)
    c = torch.round(scaled).to(torch.int32).to(torch.int64)
    low = (HASH_PRIMES[0] * c[:, 0] + HASH_PRIMES[1] * c[:, 1]
           + HASH_PRIMES[2] * c[:, 2]) & 0xFFFFFFFF
    return torch.where(low > 2 ** 31 - 1, low - (1 << 32), low)


def grid_sample(points: torch.Tensor, valid: torch.Tensor, voxel: float,
                capacity: int) -> torch.Tensor:
    """Indices of the kept points, in slot order: the first valid point of
    each voxel key, at most `capacity` of them, ordered by the XOR hash of
    their floor voxel coordinates shifted right by one (ties by index)."""
    idx = torch.nonzero(valid)[:, 0]
    keys, inverse = torch.unique(voxel_keys(points[idx], voxel), return_inverse=True)
    first = torch.full((keys.shape[0],), points.shape[0], dtype=torch.int64,
                       device=points.device).scatter_reduce(0, inverse, idx, "amin")
    first = torch.sort(first).values
    c = torch.floor(points[first] / voxel).to(torch.int32).to(torch.int64)
    prio = (((c[:, 0] * HASH_PRIMES[0]) ^ (c[:, 1] * HASH_PRIMES[1])
             ^ (c[:, 2] * HASH_PRIMES[2])) & 0xFFFFFFFF) >> 1
    return first[torch.argsort(prio, stable=True)][:capacity]


# -- the plane fit of the map normals (ops/geometry.py:130-188) ---------------

def smallest_eigenvector(m: torch.Tensor, eps: float = 1.0e-9) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (n, 3, 3)
    matrices by the closed form (the characteristic cubic's trigonometric
    roots, then the column space of (A - l1 I)(A - l2 I)); near-isotropic
    matrices give zeros."""
    a00, a11, a22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    a01, a02, a12 = m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    safe_p = torch.where(p > eps, p, torch.ones_like(p))
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    b = (m - q[..., None, None] * eye) / safe_p[..., None, None]
    det_b = (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
             - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
             + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0]))
    phi = torch.arccos(torch.clamp(det_b / 2.0, -1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    prod = (m - l1[..., None, None] * eye) @ (m - l2[..., None, None] * eye)
    best = torch.argmax(torch.linalg.vector_norm(prod, dim=-2), dim=-1)
    v = torch.gather(prod, -1, best[..., None, None].expand(*m.shape[:-2], 3, 1))[..., 0]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = (p > eps)[..., None] & (norm > eps)
    return torch.where(ok, v / torch.where(norm > eps, norm, torch.ones_like(norm)),
                       torch.zeros_like(v))


def plane_normals(neighbors: torch.Tensor) -> torch.Tensor:
    """(n, k, 3) neighbours, all valid -> (n, 3) normals: the smallest
    eigenvector of their covariance, summed in neighbour order."""
    k = neighbors.shape[1]
    total = neighbors[:, 0]
    for j in range(1, k):
        total = total + neighbors[:, j]
    centered = neighbors - (total / k)[:, None, :]
    cov = torch.zeros(neighbors.shape[:1] + (3, 3), dtype=neighbors.dtype,
                      device=neighbors.device)
    for j in range(k):
        cov = torch.addcmul(cov, centered[:, j, :, None], centered[:, j, None, :])
    return smallest_eigenvector(cov / k)


# -- exact searches, by tiles ---------------------------------------------------

def sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances, the three squared differences added left
    to right (as kernel B2 and the hash grid add them)."""
    e = queries[:, None, :] - points[None, :, :]
    return e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]


def tiles_of(points: torch.Tensor) -> List[torch.Tensor]:
    """The indices of `points` grouped by a TILE_M grid in x and y."""
    cell = torch.floor(points[:, :2].float() / TILE_M).to(torch.int64)
    key = (cell[:, 0] + (1 << 20)) * (1 << 21) + cell[:, 1] + (1 << 20)
    order = torch.argsort(key, stable=True)
    _, counts = torch.unique_consecutive(key[order], return_counts=True)
    return list(torch.split(order, counts.tolist()))


def candidates(queries: torch.Tensor, tiles: List[torch.Tensor], points: torch.Tensor,
               radius: float) -> List[torch.Tensor]:
    """For each tile, the indices (ascending) of `points` inside the box of
    its queries grown by `radius`: every point within `radius` of a query
    of the tile is among them."""
    lo = torch.stack([queries[t].amin(dim=0) for t in tiles]) - radius
    hi = torch.stack([queries[t].amax(dim=0) for t in tiles]) + radius
    inside = ((points[None] >= lo[:, None]) & (points[None] <= hi[:, None])).all(dim=-1)
    pairs = torch.nonzero(inside)
    return list(torch.split(pairs[:, 1], inside.sum(dim=1).tolist()))


def rows_per_block(columns: int) -> int:
    return max(1, PAIRS_PER_BLOCK // max(columns, 1))


def nearest(queries: torch.Tensor, points: torch.Tensor, radius: float):
    """Exact nearest of `points` for each query where it lies within
    `radius`: (index into `points` (n,), squared distance (n,)), the first
    minimum winning; +inf where no point lies within `radius` (a query
    near the radius by rounding may read +inf)."""
    n = queries.shape[0]
    best_i = torch.zeros((n,), dtype=torch.int64, device=queries.device)
    best_d = torch.full((n,), math.inf, dtype=queries.dtype, device=queries.device)
    if n == 0 or points.shape[0] == 0:
        return best_i, best_d
    tiles = tiles_of(queries)
    for rows, cand in zip(tiles, candidates(queries, tiles, points, radius)):
        if cand.numel() == 0:
            continue
        step = rows_per_block(cand.numel())
        for s in range(0, rows.numel(), step):
            r = rows[s:s + step]
            d = sq_dists(queries[r], points[cand])
            j = torch.argmin(d, dim=1)
            best_i[r] = cand[j]
            best_d[r] = torch.gather(d, 1, j[:, None])[:, 0]
    vouched = best_d < radius * radius * _ROUNDING
    return best_i, torch.where(vouched, best_d, torch.full_like(best_d, math.inf))


def smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) column indices of each row's k smallest entries, ascending,
    the lower column first on ties: the first k of a stable sort, found by
    a top-k, with the rows whose k-th value ties one beyond it sorted."""
    v, j = torch.topk(d, k, dim=1, largest=False, sorted=True)
    j = torch.sort(j, dim=1).values
    j = torch.gather(j, 1, torch.sort(torch.gather(d, 1, j), dim=1, stable=True).indices)
    tied = torch.nonzero((d <= v[:, k - 1:]).sum(dim=1) > k)[:, 0]
    if tied.numel():
        j[tied] = torch.sort(d[tied], dim=1, stable=True).indices[:, :k]
    return j


def k_nearest(queries: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) indices into `points` of each query's k nearest, ascending,
    the lower index first on ties; no bound on the distance."""
    n = queries.shape[0]
    out = torch.zeros((n, k), dtype=torch.int64, device=queries.device)
    kth = torch.full((n,), math.inf, dtype=queries.dtype, device=queries.device)

    def search(rows, cand):
        step = rows_per_block(cand.numel())
        for s in range(0, rows.numel(), step):
            r = rows[s:s + step]
            d = sq_dists(queries[r], points[cand])
            j = smallest(d, k)
            out[r] = cand[j]
            kth[r] = torch.gather(d, 1, j[:, k - 1:])[:, 0]

    tiles = tiles_of(queries)
    for rows, cand in zip(tiles, candidates(queries, tiles, points, KNN_RADIUS_M)):
        if cand.numel() >= k:
            search(rows, cand)
    # a k-th neighbour beyond the radius may have a nearer one outside the box
    far = torch.nonzero(~(kth < KNN_RADIUS_M ** 2 * _ROUNDING))[:, 0]
    if far.numel():
        search(far, torch.arange(points.shape[0], device=points.device))
    return out


# -- the map and the registration ------------------------------------------------

class KdTreeOdometry:
    """The odometry over a stream of scans: ``step(key, cloud)`` registers
    the next scan and returns its relative pose (previous frame <- this
    frame) as float32 euler params, as the program logs them."""

    # frame 1's prior, the same BEV phase correlation as the aggregated map's
    bootstrap = ref.AggregatedOdometry.bootstrap

    def __init__(self, program: dict, sensor: Sensor, device, dtype=torch.float32):
        odo = program
        lm = odo["local_map"]
        gn = odo["alignment"]["gauss_newton_config"]
        if lm.get("type") != "kdtree_local_map" or lm.get("nn_backend", "exact") != "exact" \
                or lm.get("normals_mode", "knn") != "knn" \
                or float(lm.get("levenberg_damping", 0.0)) != 0.0 \
                or odo.get("upload_format", "f32") != "f32" \
                or float(odo.get("upload_quantization", 0.0)) != 0.0 \
                or gn.get("scheme") != "neighborhood" or int(gn.get("max_iters", 1)) != 1 \
                or int(odo.get("reassoc_every", 1)) != 1 \
                or float(odo.get("reassoc_motion_m", 0.0)) != 0.0 \
                or int(odo.get("shard_points", 0)) > 1:
            raise ValueError("the reference runs the kdtree map with exact NN on every "
                             "trip, k-NN normals, f32 uploads and neighborhood weights")
        self.sensor, self.device, self.dtype = sensor, device, dtype
        self.trips = int(odo["max_num_alignments"])
        self.capacity = int(odo.get("num_points_padded", 131072))
        self.k_slots = int(lm.get("local_map_size", 20))
        self.s = int(lm.get("points_per_frame", 4096))
        self.m = int(lm.get("target_samples", 16384))
        self.sample_voxel = float(lm.get("sample_voxel_size", 0.3))
        self.target_voxel = float(lm.get("target_voxel_size", 0.4))
        self.k_normals = int(lm.get("num_neighbors_normals", 10))
        self.max_nd = float(lm.get("max_neighbor_dist", 1.0))
        self.reanchor_dist = float(lm.get("reanchor_dist", 20.0))
        self.sigma = float(gn["sigma"])
        self.eps = float(gn.get("eps", 1.0e-4))
        self.thr_delta = float(odo.get("threshold_delta_pose", 1.0e-4))
        self.thr_trans = float(odo.get("threshold_trans", 0.1))
        self.thr_rot = float(odo.get("threshold_rot", 0.3))
        self.boot = odo.get("ei_bootstrap", True)
        n = self.k_slots * self.s
        self.points = torch.zeros((n, 3), dtype=dtype, device=device)
        self.normals = torch.zeros((n, 3), dtype=dtype, device=device)
        self.valid = torch.zeros((n,), dtype=torch.bool, device=device)
        self.slot = 0
        self.anchor = torch.eye(4, dtype=dtype, device=device)
        self._scans = {}
        self.prev_cloud = None
        self.delta = self.last_rpose = None
        self.frame = 0

    def scan(self, key, cloud: np.ndarray):
        """(ICP targets, map sample (S, 3), its validity (S,)) of a scan, as
        the program's f32 upload carries it (NaN rows dropped, thinned by a
        stride past the capacity); kept per `key`."""
        if key not in self._scans:
            pts = cloud[:, :3].astype(np.float32)
            pts = pts[~np.isnan(pts).any(axis=1)]
            if pts.shape[0] > self.capacity:
                pts = pts[::-(-pts.shape[0] // self.capacity)][:self.capacity]
            p = torch.as_tensor(pts, device=self.device).to(self.dtype)
            valid = torch.amax(torch.abs(p), dim=-1) > 0
            targets = p[grid_sample(p, valid, self.target_voxel, self.m)]
            # the map sample: the scan's z-buffered raster, grid-sampled
            h, w = self.sensor.height, self.sensor.width
            idx, hit = ref.rasterize(p, valid, self.sensor)
            vpix = ref.gather_image(p, idx, hit, h, w).reshape(-1, 3)
            keep = grid_sample(vpix, torch.amax(torch.abs(vpix), dim=-1) > 0,
                               self.sample_voxel, self.s)
            sample = torch.zeros((self.s, 3), dtype=self.dtype, device=self.device)
            sample[:keep.numel()] = vpix[keep]
            sample_valid = torch.arange(self.s, device=self.device) < keep.numel()
            self._scans[key] = (targets, sample, sample_valid)
        return self._scans[key]

    def insert(self, sample: torch.Tensor, sample_valid: torch.Tensor,
               ta: torch.Tensor) -> None:
        """The scan's map sample moved into the anchor frame by `ta` into the
        next ring slot, each point with the normal of its k nearest valid
        map points (itself and the map's other points)."""
        rows = slice(self.slot * self.s, (self.slot + 1) * self.s)
        moved = torch.where(sample_valid[:, None], ref.transform(sample, ta),
                            torch.zeros_like(sample))
        self.points[rows] = moved
        self.valid[rows] = sample_valid
        normals = torch.zeros_like(moved)
        live = torch.nonzero(self.valid)[:, 0]
        new = torch.nonzero(sample_valid)[:, 0]
        if live.numel() >= self.k_normals and new.numel():
            nb = k_nearest(moved[new], self.points[live], self.k_normals)
            normals[new] = plane_normals(self.points[live][nb])
        self.normals[rows] = normals
        self.valid[rows] = sample_valid & (torch.amax(torch.abs(normals), dim=-1) > 0)
        self.slot = (self.slot + 1) % self.k_slots

    def reanchor(self) -> None:
        """The map re-expressed in the current frame."""
        inv = ref.inverse_pose(self.anchor)
        self.points = torch.where(self.valid[:, None], ref.transform(self.points, inv),
                                  torch.zeros_like(self.points))
        self.normals = self.normals @ inv[:3, :3].T
        self.anchor = torch.eye(4, dtype=self.dtype, device=self.device)

    def normal_equations(self, moved: torch.Tensor, live: torch.Tensor):
        """The neighborhood-weighted point-to-plane system at the zero delta
        of each target paired with its exact nearest valid map point within
        the gate."""
        j, sq = nearest(moved, self.points[live], self.max_nd)
        ok = sq < self.max_nd * self.max_nd
        p, sq = moved[ok], sq[ok]
        q, nrm = self.points[live[j[ok]]], self.normals[live[j[ok]]]
        res = torch.sum((p - q) * nrm, dim=-1)
        jac = torch.cat([nrm, torch.linalg.cross(p, nrm)], dim=-1)
        wgt = torch.sqrt(res * res * torch.exp(-sq / self.sigma ** 2)) / \
            torch.clamp(torch.abs(res), min=self.eps)
        wres, wjac = res * wgt, jac * wgt[:, None]
        return wjac.T @ wjac, wjac.T @ wres

    def register(self, targets: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Up to `trips` GN trips from `t` (anchor <- scan), a fresh exact
        search on each; stops once a delta falls under the threshold or the
        system is singular."""
        live = torch.nonzero(self.valid)[:, 0]
        for _ in range(self.trips):
            hmat, g = self.normal_equations(ref.transform(targets, t), live)
            dx = ref.solve(hmat, g)
            if dx is None or float(torch.linalg.vector_norm(dx.float())) < self.thr_delta:
                break
            t = ref.normalize_pose(ref.pose_from_params(dx) @ t)
        return t

    def step(self, key, cloud: np.ndarray) -> np.ndarray:
        targets, sample, sample_valid = self.scan(key, cloud)
        eye = torch.eye(4, dtype=self.dtype, device=self.device)
        if self.frame == 0:
            self.insert(sample, sample_valid, eye)
            self.delta, self.last_rpose = eye, eye
            self.prev_cloud = cloud
            self.frame = 1
            return np.zeros(6, np.float32)
        init = self.last_rpose
        if self.frame == 1 and self.boot:
            boot = self.bootstrap(self.prev_cloud, cloud)
            init = init if boot is None else boot
            self.prev_cloud = None
        ta = self.register(targets, self.anchor @ init)
        rpose = ref.normalize_pose(ref.inverse_pose(self.anchor) @ ta)
        new_delta = self.delta @ rpose
        d = ref.params_from_pose(new_delta)
        if float(torch.linalg.vector_norm(d[:3])) > self.thr_trans or \
                float(torch.linalg.vector_norm(d[3:])) * 180.0 / math.pi > self.thr_rot:
            self.insert(sample, sample_valid, ta)
            self.delta = eye
        else:
            self.delta = new_delta
        self.anchor = ta
        if float(torch.linalg.vector_norm(self.anchor[:3, 3])) > self.reanchor_dist:
            self.reanchor()
        self.last_rpose = rpose
        self.frame += 1
        return ref.params_from_pose(rpose).float().cpu().numpy()


def run(program: dict, sensor: Sensor, clouds: List[np.ndarray], frames: int,
        device, dtype=torch.float32) -> np.ndarray:
    """(frames, 6) params of the reference odometry over frames 0..frames-1
    of the endless drive, frame i being scan i mod len(clouds)."""
    odo = KdTreeOdometry(program, sensor, device, dtype)
    n = len(clouds)
    return np.stack([odo.step(i % n, clouds[i % n]) for i in range(frames)])
