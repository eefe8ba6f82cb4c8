"""The plain reference of the elevation-image loop closure and the pose-graph
backend, and the numbers ``correct`` compares for a configuration that has
them.

It imports nothing of the program.  The arithmetic is a frozen copy of the
program's (origins under ``pylidar_slam_tpu_torch/`` named per function),
with plain parts where the program is built for the card: the nearest
neighbours by explicit distances (kernel B2's plain form) and the Kabsch
rotation by ``torch.linalg.svd``.

It follows the program step by step from the program's own state, where a
free run cannot: a candidate's phase-correlation score near ``min_score``
flips with a change of 1e-7 in the input clouds, so a loop closure fed by a
free-running odometry would accept other loops than the program's and part
from it for good.  So the reference takes the poses at which the program's
loop closure placed each frame's cloud; it works out each submap event's
candidates from those poses by the configured rule (with the stored
submaps moved by the replayed backend, as the program moves them) and
holds the program's events, candidates, matches and registered
constraints to them; from the scans it rebuilds every submap (grid
samples, aggregation, BEV image, the refine's cloud), matches and refines,
and compares each candidate's decision and refined transform with the
constraint the program registered.
The odometry that produced those poses is checked by itself, from frame 0
(``slambench/correct.py``).  The backend is replayed on the program's
odometry poses and loop constraints, optimization by optimization, and
its trajectory compared.
"""
from __future__ import annotations

import math
import sys
from typing import List

import numpy as np
import torch

from slambench.reference import bev
from slambench.reference import odometry as ref_odometry

# A candidate whose reference score lies within this of `min_score` is a
# decision on the threshold: the program's and the reference's may differ
# (scores agree to ~4e-6 on identical inputs; such a decision flips with
# 1e-7 of input).  Every other decision must agree.
SCORE_MARGIN = 1.0e-3
# Submap events matched and compared per run, drawn from the seed.
EVENTS_CHECKED = 8


# -- what the program's run leaves, read after the window ------------------

def program_record(slam) -> dict:
    """The loop closure's and the backend's outputs and state after a run:
    each frame's pose as the loop closure placed its cloud, the submaps'
    mid frames, the matches' candidates, the registered loop constraints
    and the backend's trajectory."""
    lc, be = slam.loop_closure, slam.backend
    poses = list(lc.all_frames_absolute_poses) + list(lc.current_map_poses)
    return {"lc_poses": np.stack(poses) if poses else np.zeros((0, 4, 4)),
            "maps_frame_ids": list(lc.maps_frame_ids),
            "match_stats": [dict(s) for s in lc.match_stats],
            "loop_constraints": [(int(i), int(j), np.asarray(m, np.float64))
                                 for i, j, m, _ in be.registered_loop_constraints()],
            "backend_poses": np.asarray(be.absolute_poses(), np.float64)}


def events_between(driver, k0: int, k1: int) -> List[dict]:
    """Work counts of the matches of submaps k0..k1-1 (those that had
    candidates): refine trips that ran, and the refine's query and model
    rows and the fewest valid model points among its candidates."""
    lc = driver.lc
    mids = set(lc.maps_frame_ids[k0:k1])
    out = []
    for s in lc.match_stats:
        if s["frame_id"] not in mids:
            continue
        cands = s["ids"] + [s["ids"][0]] * (int(lc.config.max_num_candidates) - len(s["ids"]))
        valid = [int(lc.saved_clouds[c][1].sum()) for c in set(cands)]
        out.append({"refine_trips": int(s["refine_trips"]),
                    "queries": int(lc.config.icp_num_points),
                    "model_rows": int(lc.config.icp_num_points),
                    "model_valid_min": min(valid)})
    return out


# -- submaps (slam/loop_closure.py, utils/native.py lc_subsample) ----------

def transform_pointcloud(pointcloud: np.ndarray, tr: np.ndarray) -> np.ndarray:
    return np.einsum("ij,nj->ni", tr[:3, :3], pointcloud) + tr[:3, 3].reshape(1, 3)


def subsample(points: np.ndarray, voxel: float, cap: int) -> np.ndarray:
    """Zero rows dropped, the first point of each voxel kept (the voxel by
    rounding x / voxel half away from zero in float32), then at most `cap`
    of them evenly spaced: float32 (n, 3)."""
    p = np.ascontiguousarray(points[:, :3], np.float32)
    p = p[~np.all(p == 0.0, axis=1)]
    a = (p * np.float32(1.0 / np.float32(voxel))).astype(np.float64)
    v = (np.sign(a) * np.floor(np.abs(a) + 0.5)).astype(np.int64)
    h = 73856093 * v[:, 0] + 19349669 * v[:, 1] + 83492791 * v[:, 2]
    _, first = np.unique(h, return_index=True)
    kept = p[np.sort(first)]
    n = len(kept)
    if n > cap:
        kept = kept[(np.arange(cap, dtype=np.int64) * (n - 1)) // (cap - 1)]
    return kept


class Submaps:
    """The submaps of the program's run rebuilt from the scans and the loop
    closure's per-frame poses."""

    def __init__(self, lc_cfg: dict, clouds, record: dict, device, dtype):
        self.cfg, self.clouds, self.rec = lc_cfg, clouds, record
        self.device, self.dtype = device, dtype
        self._sampled, self._maps = {}, {}

    def sampled(self, frame: int) -> np.ndarray:
        key = frame % len(self.clouds)
        if key not in self._sampled:
            self._sampled[key] = subsample(self.clouds[key][:, :3].astype(np.float32),
                                           2.0 * self.cfg["pixel_size"],
                                           int(self.cfg["icp_num_points"]))
        return self._sampled[key]

    def get(self, k: int):
        """(BEV image, refine cloud, its mask) of submap k."""
        if k in self._maps:
            return self._maps[k]
        cfg = self.cfg
        size, overlap = int(cfg["local_map_size"]), int(cfg["overlap"])
        first = k * (size - overlap)
        poses = self.rec["lc_poses"]
        mid = first + size // 2
        if self.rec["maps_frame_ids"][k] != mid or first + size > len(poses):
            raise ValueError(f"submap {k}: the program's record does not match its frames")
        agg = np.concatenate([transform_pointcloud(self.sampled(j), poses[j])
                              for j in range(first, first + size)], axis=0)
        agg = transform_pointcloud(agg, np.linalg.inv(poses[mid]))
        n_pts = int(cfg["icp_num_points"])
        sm = subsample(agg, 2.0 * cfg["pixel_size"], n_pts)
        cloud = np.zeros((n_pts, 3), np.float32)
        cloud[:len(sm)] = sm[:n_pts]
        mask = np.zeros(n_pts, bool)
        mask[:len(sm)] = True
        img_pts = subsample(agg, cfg["pixel_size"], 65536)
        padded = np.zeros((65536, 3), np.float32)
        padded[:len(img_pts)] = img_pts
        img_mask = np.zeros(65536, bool)
        img_mask[:len(img_pts)] = True
        dev, dt = self.device, self.dtype
        image = bev.build_elevation_image(
            torch.as_tensor(padded, device=dev).to(dt), torch.as_tensor(img_mask, device=dev),
            pixel_size=cfg["pixel_size"], size=int(cfg["im_size"]),
            z_min=cfg["z_min"], z_max=cfg["z_max"])
        out = (image, torch.as_tensor(cloud, device=dev).to(dt), torch.as_tensor(mask, device=dev))
        self._maps[k] = out
        return out


# -- the match (slam/loop_closure.py _match_batch, ops/icp3d.py) -----------

def nearest(queries: torch.Tensor, model: torch.Tensor, valid: torch.Tensor, chunk=1024):
    """Exact 1-NN by explicit squared distances, the lowest index on ties."""
    m = queries.shape[0]
    best_d = torch.full((m,), math.inf, dtype=queries.dtype, device=queries.device)
    best_i = torch.zeros((m,), dtype=torch.int64, device=queries.device)
    for base in range(0, model.shape[0], chunk):
        e = queries[:, None, :] - model[None, base:base + chunk]
        d = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
        d = torch.where(valid[None, base:base + chunk], d, math.inf)
        cd, ci = torch.min(d, dim=1)
        better = cd < best_d
        best_d = torch.where(better, cd, best_d)
        best_i = torch.where(better, ci + base, best_i)
    return best_i, best_d


def procrustes(ref: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The rigid T minimizing sum w ||T(tgt) - ref||^2 (Kabsch by SVD),
    (N, 3) points -> (4, 4)."""
    wn = (w / torch.clamp(w.sum(), min=1e-12))[:, None]
    mu_r, mu_t = (ref * wn).sum(dim=0), (tgt * wn).sum(dim=0)
    h = (w[:, None] * (tgt - mu_t)).T @ (ref - mu_r)
    u, _, vt = torch.linalg.svd(h.float())
    d = torch.sign(torch.det(vt.T @ u.T))
    rot = (vt.T @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ u.T)
    rot = rot.to(ref.dtype)
    mat = torch.eye(4, dtype=ref.dtype, device=ref.device)
    mat[:3, :3] = rot
    mat[:3, 3] = mu_r - rot @ mu_t
    return mat


def icp_refine(source, src_mask, target, tgt_mask, init, max_iters=20, max_corr=1.0,
               sigma=0.5, threshold=1.0e-5):
    """Point-to-point ICP of `source` onto `target` from `init`: per trip
    the exact nearest neighbours, the correspondence gate, Geman-McClure
    weights squared and the weighted Procrustes fit; stops once a delta's
    norm falls under `threshold`."""
    t = init
    for _ in range(max_iters):
        moved = ref_odometry.transform(source, t)
        idx, sq = nearest(moved, target, tgt_mask)
        ok = src_mask & (sq < max_corr ** 2)
        res = torch.sqrt(torch.clamp(sq, min=1e-12))
        r2 = res * res
        w = (torch.sqrt(sigma * r2 / (sigma + r2)) / torch.clamp(res.abs(), min=1e-4)) ** 2
        w = torch.where(ok, w, torch.zeros_like(w))
        delta = procrustes(target[idx], moved, w)
        t = ref_odometry.normalize_pose(delta @ t)
        if float(torch.linalg.vector_norm(ref_odometry.params_from_pose(delta).float())) \
                < threshold:
            break
    return t


def match(cfg: dict, submaps: Submaps, k: int, cand_ids: List[int]):
    """Scores (C,) and refined transforms (C, 4, 4) of submap k against its
    candidates, padded as the program pads them."""
    image, cloud, mask = submaps.get(k)
    c_pad = int(cfg["max_num_candidates"])
    padded = list(cand_ids) + [cand_ids[0]] * (c_pad - len(cand_ids))
    cands = [submaps.get(c) for c in padded]
    imgs = torch.stack([c[0] for c in cands]).float()
    pf = int(cfg["match_pool_factor"])
    res = bev.register_bev_fm(bev._pool(imgs, pf), bev._pool(image.float(), pf))
    transforms = bev.bev_transform_to_se3(res, cfg["pixel_size"] * pf)
    scores = res.score.cpu().numpy()
    out = []
    for c in range(len(cand_ids)):
        t = transforms[c].to(cloud.dtype)
        if scores[c] >= cfg["min_score"]:
            t = icp_refine(cloud, mask, cands[c][1], cands[c][2], t,
                           max_corr=float(cfg["icp_distance_threshold"]))
        out.append(t.double().cpu().numpy())
    return scores[:len(cand_ids)], out


# -- the backend (slam/backend.py GraphSLAM, ops/pose_graph.py host solver) -

def _exp_rotation(w):
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-10
    axis = w / np.where(small[..., None], 1.0, theta)
    s, c = np.sin(theta)[..., None], np.cos(theta)[..., None]
    z = np.zeros_like(axis[..., 0])
    k = np.stack([np.stack([z, -axis[..., 2], axis[..., 1]], axis=-1),
                  np.stack([axis[..., 2], z, -axis[..., 0]], axis=-1),
                  np.stack([-axis[..., 1], axis[..., 0], z], axis=-1)], axis=-2)
    eye = np.broadcast_to(np.eye(3, dtype=w.dtype), k.shape)
    return np.where(small[..., None, None], eye + k, eye + s * k + (1.0 - c) * (k @ k))


def _exp_se3(dx):
    mat = np.zeros((*dx.shape[:-1], 4, 4), dx.dtype)
    mat[..., :3, :3] = _exp_rotation(dx[..., 3:])
    mat[..., :3, 3] = dx[..., :3]
    mat[..., 3, 3] = 1.0
    return mat


def _log_rotation(rot):
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_t = np.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = np.arccos(cos_t)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    scale = np.where(cos_t > 1.0 - 1e-8, 0.5 + (1.0 - cos_t) / 6.0,
                     theta / np.maximum(2.0 * sin_t, np.finfo(rot.dtype).tiny))
    w = np.stack([rot[..., 2, 1] - rot[..., 1, 2], rot[..., 0, 2] - rot[..., 2, 0],
                  rot[..., 1, 0] - rot[..., 0, 1]], axis=-1)
    return w * scale[..., None]


def _inv_pose(mats):
    rt = np.swapaxes(mats[..., :3, :3], -1, -2)
    out = np.zeros_like(mats)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", rt, mats[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def optimize_pose_graph(poses, edges, num_iters=30, damping=1.0e-6, tol=1.0e-10,
                        dtype=np.float64):
    """Gauss-Newton over absolute poses with the first fixed: residual
    [t, log R] of Z^-1 Xi^-1 Xj per edge, Jacobians by central differences,
    the normal equations solved by sparse LU (ops/pose_graph.py:271-404)."""
    from scipy.sparse import csc_matrix
    from scipy.sparse.linalg import splu
    poses = np.asarray(poses, dtype).copy()
    ei = np.array([e[0] for e in edges], np.int64)
    ej = np.array([e[1] for e in edges], np.int64)
    z_inv = _inv_pose(np.stack([e[2] for e in edges]).astype(dtype))
    info = np.stack([e[3] for e in edges]).astype(dtype)
    m, ne = poses.shape[0], len(edges)

    def edge_res(xi, xj):
        err = np.einsum("eij,ejk,ekl->eil", z_inv, _inv_pose(xi), xj)
        return np.concatenate([err[:, :3, 3], _log_rotation(err[:, :3, :3])], axis=-1)

    eps, eye6, off = 1.0e-6, np.eye(6, dtype=dtype), np.arange(6)
    for _ in range(num_iters):
        xi, xj = poses[ei], poses[ej]
        res = edge_res(xi, xj)
        ji, jj = np.empty((ne, 6, 6), dtype), np.empty((ne, 6, 6), dtype)
        for k in range(6):
            d, dm = _exp_se3(eps * eye6[k]), _exp_se3(-eps * eye6[k])
            ji[:, :, k] = (edge_res(xi @ d, xj) - edge_res(xi @ dm, xj)) / (2 * eps)
            jj[:, :, k] = (edge_res(xi, xj @ d) - edge_res(xi, xj @ dm)) / (2 * eps)
        i_r = np.einsum("epq,eq->ep", info, res)
        g = np.zeros((m, 6), dtype)
        np.add.at(g, ei, np.einsum("epa,ep->ea", ji, i_r))
        np.add.at(g, ej, np.einsum("epa,ep->ea", jj, i_r))
        i_ji, i_jj = np.einsum("epq,eqa->epa", info, ji), np.einsum("epq,eqa->epa", info, jj)
        hij = np.einsum("epa,epb->eab", ji, i_jj)
        blocks = [np.einsum("epa,epb->eab", ji, i_ji), hij, np.swapaxes(hij, -1, -2),
                  np.einsum("epa,epb->eab", jj, i_jj)]
        data, rr, cc = [], [], []
        for blk, bi, bj in zip(blocks, [ei, ei, ej, ej], [ei, ej, ei, ej]):
            data.append(blk.reshape(len(bi), -1).ravel())
            rr.append(np.broadcast_to(bi[:, None, None] * 6 + off[None, :, None],
                                      (len(bi), 6, 6)).ravel())
            cc.append(np.broadcast_to(bj[:, None, None] * 6 + off[None, None, :],
                                      (len(bi), 6, 6)).ravel())
        data, rr, cc = np.concatenate(data), np.concatenate(rr), np.concatenate(cc)
        b = -g.reshape(-1)
        keep = (rr >= 6) & (cc >= 6)
        data = np.concatenate([data[keep], np.ones(6), np.full(6 * m, damping)])
        rr = np.concatenate([rr[keep], off, np.arange(6 * m)])
        cc = np.concatenate([cc[keep], off, np.arange(6 * m)])
        b[:6] = 0.0
        try:
            dx = splu(csc_matrix((data, (rr, cc)), shape=(6 * m, 6 * m))).solve(b)
        except RuntimeError:
            break
        dx = dx.reshape(m, 6).astype(dtype)
        dx[0] = 0.0
        poses = poses @ _exp_se3(dx)
        if float(np.linalg.norm(dx)) < tol:
            break
    u, _, vt = np.linalg.svd(poses[:, :3, :3].astype(np.float64))
    det = np.linalg.det(u @ vt)
    dd = np.stack([np.ones_like(det), np.ones_like(det), det], axis=-1)
    out = poses.astype(np.float64)
    out[:, :3, :3] = u @ (dd[:, :, None] * vt)
    return out


def reproject_rotation(pose: np.ndarray) -> np.ndarray:
    pose = pose.astype(np.float64)
    u, _, vt = np.linalg.svd(pose[:3, :3])
    pose[:3, :3] = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    return pose


def backend_trajectory(lc_cfg: dict, params: np.ndarray, loops, dtype=np.float64,
                       optimized=None):
    """The backend replayed on the program's odometry poses and loop
    constraints, as ``GraphSLAM.next_frame`` builds its graph: each frame
    adds its odometry edge and the pose chained from the previous one; a
    loop found at a submap event is registered at the next event's frame
    (or after the last frame), and every frame that registers a loop
    optimizes the whole graph (30 iterations) from the poses as they are.
    With `optimized` (a dict), the trajectory after each optimization is
    kept under the frame that ran it.

    The replay is exact, not a check of optimality: the program's 30
    iterations stop short of the optimum by millimetres on a lap-sized
    graph, so its trajectory is the result of this sequence and no other."""
    odo_info = np.diag([2.0, 2.0, 2.0, 5.0, 5.0, 5.0])
    lc_info = np.diag([0.1, 0.1, 0.1, 0.5, 0.5, 0.5])
    n = params.shape[0]
    size, overlap = int(lc_cfg["local_map_size"]), int(lc_cfg["overlap"])
    step = size - overlap
    at = {}
    for i, j, t in loops:
        k = (j - size // 2) // step  # the event whose submap's mid frame is j
        at.setdefault(min(size - 1 + (k + 1) * step, n), []).append((i, j, t, lc_info))
    poses, edges = [np.eye(4)], []
    for f in range(n + 1):
        if 0 < f < n:
            rel = reproject_rotation(ref_odometry.pose_matrix_f64(params[f]))
            poses.append(poses[-1] @ rel)
            edges.append((f - 1, f, rel, odo_info))
        if f in at:
            edges += at[f]
            poses = list(optimize_pose_graph(np.stack(poses), edges, dtype=dtype))
            if optimized is not None:
                optimized[f] = np.stack(poses)
    return np.stack(poses)


# The distance (m) within which two candidates' order, or a candidate's
# distance and `max_distance`, is a tie that rounding may break either way.
TIE_M = 1.0e-6


def rule_candidates(lc_cfg: dict, rec: dict, optimized: dict):
    """Each submap event's candidates by the configured rule, followed from
    the program's state as ``ElevationImageLoopClosure.process_next_frame``
    keeps it: the stored submaps' positions are their mid frames' poses,
    rewritten with the backend's trajectory after each optimization (taken
    from the replay, `optimized`); among those at least `min_id_distance`
    frames back, the `max_num_candidates` nearest within `max_distance` of
    the event's mid pose.  Returns per event (its mid frame, the ids, the
    ids that a tie could add or drop)."""
    size, overlap = int(lc_cfg["local_map_size"]), int(lc_cfg["overlap"])
    step = size - overlap
    if int(lc_cfg.get("stride", 1)) != 1:
        raise ValueError("the reference follows a loop closure of stride 1")
    lm_id = max(int(lc_cfg["min_id_distance"]) // max(step, 1), 1)
    max_d, cap = float(lc_cfg["max_distance"]), int(lc_cfg["max_num_candidates"])
    lc_poses = rec["lc_poses"]
    n = len(lc_poses)
    mids, positions, out = [], [], []
    pending = sorted(optimized)
    for k in range(max(0, (n - size) // step + 1)):
        frame = size - 1 + k * step
        while pending and pending[0] < frame:
            traj = optimized[pending.pop(0)]
            positions = [traj[m][:3, 3] if m < len(traj) else p
                         for m, p in zip(mids, positions)]
        mid = k * step + size // 2
        here = lc_poses[mid][:3, 3]
        ids, loose = [], set()
        if len(positions) > lm_id:
            d = np.linalg.norm(np.stack(positions[:-lm_id]) - here, axis=1)
            inside = np.flatnonzero(d < max_d)
            order = inside[np.argsort(d[inside], kind="stable")]
            ids = [int(c) for c in order[:cap]]
            loose = {int(c) for c in np.flatnonzero(np.abs(d - max_d) < TIE_M)}
            if len(order) > cap:
                cut = d[order[cap - 1]]
                loose |= {int(c) for c in order if abs(d[c] - cut) < TIE_M}
        out.append((mid, ids, loose))
        mids.append(mid)
        positions.append(lc_poses[mid][:3, 3])
    return out


def event_mismatches(lc_cfg: dict, rec: dict, optimized: dict) -> int:
    """What the program's loop closure left against the rule, counted: an
    event missing or at another frame, an event whose candidates differ
    from the rule's (beyond ties), an event with candidates and no match
    or a match with none, an event whose registered constraints are not
    as many as its accepted candidates, and a registered constraint that
    no matched candidate explains."""
    events = rule_candidates(lc_cfg, rec, optimized)
    got = rec["maps_frame_ids"]
    bad = abs(len(events) - len(got))
    bad += sum(1 for (mid, _, _), g in zip(events, got) if mid != g)
    stats = {}
    for s in rec["match_stats"]:
        bad += s["frame_id"] in stats
        stats[s["frame_id"]] = s
    per_event = {}
    for i, j, _ in rec["loop_constraints"]:
        s = stats.get(j)
        if s is None or i not in {got[c] for c in s["ids"] if c < len(got)}:
            bad += 1
        per_event[j] = per_event.get(j, 0) + 1
    for mid, ids, loose in events:
        s = stats.pop(mid, None)
        ours = set(s["ids"]) if s is not None else set()
        if (ours ^ set(ids)) - loose:
            bad += 1
        if s is not None and per_event.get(mid, 0) != int(s["refined"]):
            bad += 1
    return bad + len(stats)  # matches of events that are not the rule's


def numbers(config: dict, clouds, outputs: dict, device, seed: int,
            control: bool = False) -> dict:
    """``lc_event_mismatches``: what the program's submap events, their
    candidates, matches and registered constraints leave against the
    configured rule, counted over every event of the run
    (``event_mismatches``); an exact comparison.
    ``lc_constraint_gap_m``: over the candidates of up to
    EVENTS_CHECKED submap events drawn from the seed, the worst gap between
    the program's registered loop constraint and the reference's refined
    transform (translation), inf where one accepts a candidate and the
    other does not, the reference's score farther than SCORE_MARGIN from
    `min_score`.  ``backend_gap_m``: the worst translation gap between the
    program's trajectory and the reference backend's replay on the
    program's constraints (``backend_trajectory``)."""
    cfg = config["program"]["loop_closure"]
    rec = outputs
    submaps = Submaps(cfg, clouds, rec, device, torch.bfloat16 if control else torch.float32)
    constraints = {(i, j): t for i, j, t in rec["loop_constraints"]}
    stats = rec["match_stats"]
    rng = np.random.default_rng(int(seed) % (1 << 64))
    picked = sorted(rng.choice(len(stats), size=min(EVENTS_CHECKED, len(stats)),
                               replace=False)) if stats else []
    worst = 0.0
    for e in picked:
        s = stats[e]
        try:
            k = rec["maps_frame_ids"].index(s["frame_id"])
            scores, transforms = match(cfg, submaps, k, s["ids"])
        except (ValueError, IndexError):  # an event the program misplaced
            worst = math.inf
            continue
        for c, score, t_ref in zip(s["ids"], scores, transforms):
            key = (rec["maps_frame_ids"][c], s["frame_id"])
            ours = key in constraints
            theirs = score >= cfg["min_score"]
            margin = float(score - cfg["min_score"])
            print(f"lc candidate {key}: reference score {float(score):.6f} "
                  f"margin {margin:+.6f} program {'accepted' if ours else 'rejected'}",
                  file=sys.stderr)
            if ours and theirs:
                worst = max(worst, float(np.linalg.norm(constraints[key][:3, 3] - t_ref[:3, 3])))
            elif ours != theirs and abs(margin) > SCORE_MARGIN:
                worst = math.inf
    prog = rec["backend_poses"]
    optimized = {}
    with np.errstate(all="ignore"):  # the float32 control overflows
        ref = backend_trajectory(cfg, rec["params"], rec["loop_constraints"],
                                 np.float32 if control else np.float64, optimized)
    gap = math.inf if prog.shape != ref.shape or not np.isfinite(prog).all() else \
        float(np.max(np.linalg.norm(prog[:, :3, 3] - ref[:, :3, 3], axis=1)))
    return {"lc_event_mismatches": event_mismatches(cfg, rec, optimized),
            "lc_constraint_gap_m": worst, "backend_gap_m": gap}
