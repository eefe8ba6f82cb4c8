"""Elevation-image loop closure (port of
``pylidar_slam_tpu.slam.loop_closure``).

Per frame: the odometry's cloud is grid-sampled and accumulated into
submaps of `local_map_size` frames (overlap `overlap`).  When a submap
completes, a BEV elevation image around its mid pose is built on the
device; candidates are stored submaps within `max_distance` meters and at
least `min_id_distance` frames apart; all candidates of the event are
matched in one batched dispatch (Fourier-Mellin or yaw-sweep BEV
registration over the candidate axis, then the exact-NN ICP refine on kernel
B2, gated on the device by the registration score) and the results are
copied to pinned host memory behind a CUDA event.  The next submap event
(or the sequence's end) fetches them -- the path's one wait by design -- and
emits ``se3_loop_closure_constraint_<i>_<j>`` keys into the data_dict.

``update_positions`` rewrites the stored submap poses after a backend
optimization.  The submap event runs inline on the pipeline thread.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pylidar_slam_tpu_torch.config import MISSING, Registry, dataclass_from_dict
from pylidar_slam_tpu_torch.ops import bev, icp3d
from pylidar_slam_tpu_torch.slam.backend import Backend
from pylidar_slam_tpu_torch.slam.preprocessing import np_grid_sample
from pylidar_slam_tpu_torch.utils import assert_debug, check_tensor, native
from pylidar_slam_tpu_torch.utils.transfer import copy_to_host_async

logger = logging.getLogger(__name__)


def transform_pointcloud(pointcloud: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """Applies a (4, 4) transform to an (N, 3) numpy point cloud."""
    return np.einsum("ij,nj->ni", tr[:3, :3], pointcloud) + tr[:3, 3].reshape(1, 3)


@dataclass
class LoopClosureConfig:
    type: str = MISSING


class LoopClosure:
    def __init__(self, config: LoopClosureConfig, **kwargs):
        self.config = config

    def init(self):
        self.clean()

    def clean(self):
        raise NotImplementedError("")

    def process_next_frame(self, data_dict: dict):
        raise NotImplementedError("")

    def update_positions(self, trajectory: np.ndarray):
        pass

    @staticmethod
    def pointcloud_key() -> str:
        return "lc_pointcloud"

    @staticmethod
    def relative_pose_key() -> str:
        return "lc_relative_pose"


@dataclass
class EILoopClosureConfig(LoopClosureConfig):
    type: str = "elevation_image"
    local_map_size: int = 50
    overlap: int = 20
    debug: bool = False
    max_num_candidates: int = 10
    max_distance: float = 100.0
    min_id_distance: int = 200
    stride: int = 1

    icp_distance_threshold: float = 1.0
    with_icp_refinement: bool = True
    icp_num_points: int = 4096  # grid-sampled submap size for the refinement

    # Dense BEV registration parameters
    pixel_size: float = 0.2
    im_size: int = 512
    z_min: float = -3.0
    z_max: float = 5.0
    num_yaw_steps: int = 72
    min_score: float = 0.10  # phase-correlation acceptance threshold
    # Rotation estimator: "fm" = Fourier-Mellin polar-spectrum correlation
    # with a 10-candidate refinement sweep; "sweep" = the exhaustive
    # `num_yaw_steps` rotate + phase-correlate search (on 2x pooled images,
    # top-8 rescored at full resolution).
    match_method: str = "fm"
    # fm path: average-pooling factor of the BEV images before matching
    # (the estimate only seeds the score-gated ICP refine); 1 disables.
    match_pool_factor: int = 2


class ElevationImageLoopClosure(LoopClosure):
    # Fixed capacity of the aggregated submap cloud fed to the BEV
    # rasterizer, grid-sampled at `pixel_size` first (each column's top
    # point moves by at most one voxel, so the image is near-identical).
    _AGG_CAPACITY = 65536

    def __init__(self, config: EILoopClosureConfig, device="cuda", **kwargs):
        if not isinstance(config, EILoopClosureConfig):
            config = dataclass_from_dict(EILoopClosureConfig, config)
        super().__init__(config)
        self.device = torch.device(device)
        self.clean()

    def clean(self):
        self.current_frame_id = 0
        self.last_inserted_pose = np.eye(4)
        self.current_map_pcs: List[np.ndarray] = []
        self.current_map_poses: List[np.ndarray] = []
        self.current_map_frameids: List[int] = []
        self.all_frames_absolute_poses: List[np.ndarray] = []
        self.maps_absolute_poses = np.zeros((0, 4, 4))
        self.maps_frame_ids: List[int] = []
        self.saved_images: List[torch.Tensor] = []  # (S, S) on the device
        self.saved_clouds: List[tuple] = []  # (padded cloud, mask) on the device
        # In-flight candidate matches: (host results, event, ids, frame_id);
        # fetched at the next submap event or at the sequence's end.
        self._pending_matches: List[tuple] = []
        # per dispatched match: candidates, candidates refined, refine trips
        # that ran (read back with the results)
        self.match_stats: List[dict] = []

    # -- on-disk persistence -------------------------------------------------

    def save_state(self, path: str):
        """Serializes the loop-closure state (submap images, clouds, poses,
        accumulation buffers) to one ``.npz``.  In-flight candidate matches
        are transient and not serialized: call after ``drain_pending``."""
        cfg = self.config
        n_maps = len(self.saved_images)
        images = (torch.stack(self.saved_images).cpu().numpy() if n_maps
                  else np.zeros((0, cfg.im_size, cfg.im_size), np.float32))
        clouds = (torch.stack([c[0] for c in self.saved_clouds]).cpu().numpy() if n_maps
                  else np.zeros((0, cfg.icp_num_points, 3), np.float32))
        cloud_masks = (torch.stack([c[1] for c in self.saved_clouds]).cpu().numpy()
                       if n_maps else np.zeros((0, cfg.icp_num_points), bool))
        # the in-progress submap accumulators are ragged: concatenated, with
        # per-frame lengths
        cur_lens = np.array([len(p) for p in self.current_map_pcs], np.int64)
        cur_pcs = (np.concatenate(self.current_map_pcs, axis=0)
                   if self.current_map_pcs else np.zeros((0, 3), np.float32))
        np.savez_compressed(
            path,
            current_frame_id=np.int64(self.current_frame_id),
            last_inserted_pose=self.last_inserted_pose,
            maps_absolute_poses=self.maps_absolute_poses,
            maps_frame_ids=np.asarray(self.maps_frame_ids, np.int64),
            all_frames_absolute_poses=np.stack(self.all_frames_absolute_poses)
            if self.all_frames_absolute_poses else np.zeros((0, 4, 4)),
            saved_images=images,
            saved_clouds=clouds,
            saved_cloud_masks=cloud_masks,
            cur_lens=cur_lens,
            cur_pcs=cur_pcs,
            cur_poses=np.stack(self.current_map_poses)
            if self.current_map_poses else np.zeros((0, 4, 4)),
            cur_frameids=np.asarray(self.current_map_frameids, np.int64))

    def load_state(self, path: str):
        """Restores the state written by :meth:`save_state`; submap images
        and clouds go back to the device."""
        data = np.load(path)
        self.clean()
        self.current_frame_id = int(data["current_frame_id"])
        self.last_inserted_pose = np.asarray(data["last_inserted_pose"])
        self.maps_absolute_poses = np.asarray(data["maps_absolute_poses"])
        self.maps_frame_ids = [int(i) for i in data["maps_frame_ids"]]
        self.all_frames_absolute_poses = list(data["all_frames_absolute_poses"])
        self.saved_images = [torch.as_tensor(im, device=self.device)
                             for im in data["saved_images"]]
        self.saved_clouds = [(torch.as_tensor(c, device=self.device),
                              torch.as_tensor(m, device=self.device))
                             for c, m in zip(data["saved_clouds"], data["saved_cloud_masks"])]
        offsets = np.concatenate([[0], np.cumsum(data["cur_lens"])])
        self.current_map_pcs = [np.asarray(data["cur_pcs"][offsets[i]:offsets[i + 1]])
                                for i in range(len(data["cur_lens"]))]
        self.current_map_poses = list(data["cur_poses"])
        self.current_map_frameids = [int(i) for i in data["cur_frameids"]]

    # -- persistence of submap positions after optimization ------------------

    def update_positions(self, trajectory: np.ndarray):
        """Rewrites stored submap/mid poses from optimized absolute poses."""
        n = trajectory.shape[0]
        new_maps = []
        for k, fid in enumerate(self.maps_frame_ids):
            new_maps.append(trajectory[fid] if fid < n else self.maps_absolute_poses[k])
        if new_maps:
            self.maps_absolute_poses = np.stack(new_maps)
        if self.current_frame_id - 1 < n:
            self.last_inserted_pose = trajectory[
                min(self.current_frame_id - 1, n - 1)].copy()

    # -- submap machinery ----------------------------------------------------

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _subsample(self, cloud: np.ndarray, cap: int) -> np.ndarray:
        """Zero padding rows dropped, one point per voxel of twice the
        pixel size, at most `cap` evenly spaced survivors: the native
        library in one O(n) pass, else the numpy chain (same winners)."""
        res = native.lc_subsample(cloud, self.config.pixel_size * 2, cap)
        if res is not None:
            out, n = res
            return out[:n]
        cloud = cloud[np.abs(cloud).max(axis=1) > 0]
        sampled, _ = np_grid_sample(cloud, self.config.pixel_size * 2)
        if len(sampled) > cap:
            idx = np.linspace(0, len(sampled) - 1, cap).astype(int)
            sampled = sampled[idx]
        return sampled

    @staticmethod
    def _pad_fixed(cloud: np.ndarray, cap: int):
        """Zero-pads/trims to exactly `cap` rows, with a validity mask."""
        out = np.zeros((cap, 3), np.float32)
        n = min(len(cloud), cap)
        out[:n] = cloud[:n]
        mask = np.zeros((cap,), bool)
        mask[:n] = True
        return out, mask

    def _build_image(self, aggregated: np.ndarray) -> torch.Tensor:
        """The submap's (S, S) elevation image, on the device."""
        cfg = self.config
        res = native.lc_subsample(aggregated, cfg.pixel_size, self._AGG_CAPACITY)
        if res is not None:
            padded, n = res
            mask = np.zeros((self._AGG_CAPACITY,), bool)
            mask[:n] = True
        else:
            if len(aggregated) > self._AGG_CAPACITY:
                aggregated, _ = np_grid_sample(aggregated, cfg.pixel_size)
            padded, mask = self._pad_fixed(aggregated, self._AGG_CAPACITY)
        return bev.build_elevation_image(self._upload(padded), self._upload(mask),
                                         pixel_size=cfg.pixel_size, size=cfg.im_size,
                                         z_min=cfg.z_min, z_max=cfg.z_max)

    def _match_batch(self, cand_imgs, cand_clouds, cand_masks, image, sm_cloud, sm_mask):
        """All candidates of a submap event in one dispatch: BEV registration
        batched over the candidate axis, then the ICP refine of every
        candidate whose score passes `min_score` (a device flag: a failing
        candidate's trips do no NN work).  Returns (scores (C,), transforms
        (C, 4, 4), refine trips (C,))."""
        cfg = self.config
        c = cand_imgs.shape[0]
        if str(cfg.match_method) == "fm":
            pf = max(1, int(cfg.match_pool_factor or 1))
            px_size = cfg.pixel_size * pf
            img_m, cands_m = image, cand_imgs
            if pf > 1 and image.shape[0] % pf == 0:
                img_m, cands_m = bev._pool(image, pf), bev._pool(cand_imgs, pf)
            res = bev.register_bev_fm(cands_m, img_m)
        else:
            px_size = cfg.pixel_size
            res = bev.register_bev(cand_imgs, image, num_yaw_steps=cfg.num_yaw_steps,
                                   coarse_factor=2)
        transforms = bev.bev_transform_to_se3(res, px_size)
        trips = torch.zeros((c,), dtype=torch.int32, device=image.device)
        if cfg.with_icp_refinement:
            out = icp3d.icp_align(sm_cloud, cand_clouds, init_transform=transforms,
                                  source_mask=sm_mask, target_mask=cand_masks,
                                  max_corr_dist=float(cfg.icp_distance_threshold),
                                  active=res.score >= float(cfg.min_score))
            transforms, trips = out.transform, out.num_iters
        return res.score, transforms, trips

    def _match_candidates(self, candidate_ids, image, submap_cloud, frame_id: int):
        """Dispatches the match of all candidates (the candidate axis padded
        to `max_num_candidates`, so every event has the same shapes) and
        queues its results, copied to pinned host memory behind a CUDA
        event; nothing here waits for the device."""
        cfg = self.config
        c = int(cfg.max_num_candidates)
        ids = list(candidate_ids)[:c]
        if not ids:
            return
        padded_ids = ids + [ids[0]] * (c - len(ids))
        cand_imgs = torch.stack([self.saved_images[k] for k in padded_ids])
        cand_clouds = torch.stack([self.saved_clouds[k][0] for k in padded_ids])
        cand_masks = torch.stack([self.saved_clouds[k][1] for k in padded_ids])
        results, event = copy_to_host_async(*self._match_batch(
            cand_imgs, cand_clouds, cand_masks, image, *submap_cloud))
        self._pending_matches.append((results, event, ids, frame_id))

    def _event(self, aggregated: np.ndarray, cand_ids, mid_frame_id: int):
        """The submap event: subsample, BEV image, store, match."""
        cfg = self.config
        sm_np, sm_mask_np = self._pad_fixed(self._subsample(aggregated, cfg.icp_num_points),
                                            cfg.icp_num_points)
        submap_cloud = (self._upload(sm_np), self._upload(sm_mask_np))
        image = self._build_image(aggregated)
        # stored before matching: the candidates are earlier submaps
        self.saved_images.append(image)
        self.saved_clouds.append(submap_cloud)
        if len(cand_ids) > 0:
            self._match_candidates(cand_ids, image, submap_cloud, mid_frame_id)

    def drain_pending(self, data_dict: dict, wait: bool = True):
        """Turns finished candidate matches into loop-closure constraint keys
        on `data_dict`.  wait=False takes only matches whose copy event has
        completed (``event.query()``); wait=True waits for all of them."""
        cfg = self.config
        pending, self._pending_matches = self._pending_matches, []
        for item in pending:
            (scores, transforms, trips), event, ids, frame_id = item
            if event is not None:
                if not wait and not event.query():
                    self._pending_matches.append(item)
                    continue
                event.synchronize()
            scores = scores.numpy()
            transforms = transforms.numpy().astype(np.float64)
            trips = trips.numpy()
            n = len(ids)
            self.match_stats.append({
                "frame_id": frame_id, "ids": list(ids), "candidates": n,
                "refined": int(np.sum(scores[:n] >= cfg.min_score)),
                "refine_trips": int(trips.sum()), "refine_trips_real": int(trips[:n].sum())})
            for k in range(n):
                cd_frame_id = self.maps_frame_ids[ids[k]]
                score = float(scores[k])
                if score < cfg.min_score:
                    if cfg.debug:
                        logger.info("Loop candidate %d rejected (score %.3f)",
                                    cd_frame_id, score)
                    continue
                # T maps current-submap coords into candidate-submap coords
                key = Backend.se3_loop_closure_constraint(cd_frame_id, frame_id)
                logger.info("[LOOP CLOSURE] constraint between frames %d and %d "
                            "(score %.3f)", cd_frame_id, frame_id, score)
                data_dict[key] = (transforms[k], None)

    def process_next_frame(self, data_dict: dict):
        cfg = self.config
        if self.current_frame_id > 0:
            assert_debug(self.relative_pose_key() in data_dict,
                         f"Key `{self.relative_pose_key()}` required per frame")
            relative_pose = np.asarray(data_dict[self.relative_pose_key()])
        else:
            relative_pose = np.eye(4)
        self.last_inserted_pose = self.last_inserted_pose @ relative_pose

        if self.pointcloud_key() not in data_dict:
            self.current_frame_id += 1
            return data_dict

        pointcloud = data_dict.get("lc_pointcloud_sampled")
        if pointcloud is None:
            # not grid-sampled by a prefetch worker (SLAM.host_prepare)
            pointcloud = np.asarray(data_dict[self.pointcloud_key()])
            check_tensor(pointcloud, [-1, 3], np.ndarray)
            pointcloud = self._subsample(pointcloud, cfg.icp_num_points)

        if self.current_frame_id % cfg.stride == 0:
            self.current_map_pcs.append(
                transform_pointcloud(pointcloud, self.last_inserted_pose))
            self.current_map_poses.append(self.last_inserted_pose.copy())
            self.current_map_frameids.append(self.current_frame_id)

        if len(self.current_map_pcs) >= cfg.local_map_size:
            # Every match dispatched at an earlier submap event registers
            # here, waiting if it must: constraint registration -- and so
            # the frame at which the backend optimizes -- is a function of
            # the frame stream alone, the same at any batch size.  The
            # previous event had a submap interval of odometry to finish.
            self.drain_pending(data_dict, wait=True)
            mid = len(self.current_map_pcs) // 2
            aggregated = np.concatenate(self.current_map_pcs, axis=0)
            mid_pose = self.current_map_poses[mid]
            mid_frame_id = self.current_map_frameids[mid]
            aggregated = transform_pointcloud(aggregated, np.linalg.inv(mid_pose))

            # candidate search among stored submaps
            cand_ids: list = []
            lm_id_distance = max(cfg.min_id_distance //
                                 max(cfg.local_map_size - cfg.overlap, 1), 1)
            if self.maps_absolute_poses.shape[0] > lm_id_distance:
                cand_idx = np.arange(self.maps_absolute_poses.shape[0])[:-lm_id_distance]
                cand_pos = self.maps_absolute_poses[:-lm_id_distance, :3, 3]
                dists = np.linalg.norm(cand_pos - mid_pose[:3, 3], axis=1)
                keep = dists < cfg.max_distance
                cand_idx = cand_idx[keep]
                dists = dists[keep]
                if len(dists) > 0:
                    order = np.argsort(dists)[:cfg.max_num_candidates]
                    cand_ids = list(cand_idx[order])

            self._event(aggregated, cand_ids, mid_frame_id)
            self.maps_absolute_poses = np.concatenate(
                [self.maps_absolute_poses, mid_pose[None]], axis=0)
            self.maps_frame_ids.append(mid_frame_id)
            self.all_frames_absolute_poses += self.current_map_poses[:-cfg.overlap]

            self.current_map_pcs = self.current_map_pcs[-cfg.overlap:]
            self.current_map_poses = self.current_map_poses[-cfg.overlap:]
            self.current_map_frameids = self.current_map_frameids[-cfg.overlap:]

        self.current_frame_id += 1
        return data_dict


LOOP_CLOSURE = Registry("loop_closure", type_key="type")
LOOP_CLOSURE.register("elevation_image", ElevationImageLoopClosure, EILoopClosureConfig)
