"""The acceptance sequences, the champion configurations, the odometry
profiles and the code stamp of the card-recorded fixture (port of
``pylidar_slam_tpu.eval.acceptance``).

The root ``bench.build_icp_config("aggregated", "rimg8")`` is pinned equal
to the aggregated champion, ``build_icp_config("voxel", "rimg8")`` to
``profile_configs()["voxel"]``, and the JAX package's
``config/slam/odometry`` profiles to ``profile_configs()`` (the port reads
no YAML).

``tests/fixtures/torch_e2e.npz`` holds both champions' trajectories over
the acceptance sequence, recorded on the card by
``python -m pylidar_slam_tpu_torch.eval.record_e2e``.  ``code_stamp()``
says which code recorded it, so a stale fixture fails the tests.
"""
from __future__ import annotations

import ast
import hashlib
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
# The port's sources that one champion step loads, relative to the package
# (a test holds this list to the modules such a step imports), and the
# shared host encoder's source, relative to the repository.
STAMP_MODULES = (
    "__init__.py", "config.py", "eval/__init__.py", "eval/acceptance.py",
    "models/__init__.py", "models/from_jax.py", "models/posenet.py", "models/resnet.py",
    "ops/*.py", "ops/kernels/*.py", "slam/__init__.py",
    "slam/initialization.py", "slam/odometry/*.py", "training/__init__.py",
    "training/prediction_modules.py", "utils/__init__.py", "utils/build.py",
    "utils/checks.py", "utils/native.py", "utils/timer.py", "utils/transfer.py")
STAMP_NATIVE = "native/pointcloud_native.cpp"

SEQ_KW = dict(lidar_height=64, lidar_width=1024, num_frames=140,
              num_walls=40, num_pillars=25)
UP_FOV, DOWN_FOV = 3.0, -24.0
# The rolling-shutter sequence the CT-ICP profiles are held on: each azimuth
# column raycast along the motion to the next pose, a 0.08 rad/frame turn
# rate (the synthetic dataset's other settings at their defaults).
ROLLING_SHUTTER_KW = dict(lidar_height=64, lidar_width=1024, num_frames=100,
                          skew=True, turn_rate=0.08, speed=1.2)
# The high-speed sequence (2 m/frame, KITTI seq-01 class) of the
# aggregated_highway profile.
HIGHWAY_KW = dict(lidar_height=64, lidar_width=1024, num_frames=60,
                  num_walls=40, num_pillars=25, speed=2.0)

_AGG_MAP = {"type": "aggregated_local_map", "local_map_size": 20,
            "window_rows": 1, "window_cols": 2, "max_neighbor_dist": 1.0}
_ELASTIC_GN = {"scheme": "neighborhood", "sigma": 0.2, "max_iters": 1}


def _ct_profile(max_num_alignments, reassoc_every, gn, local_map=None,
                reassoc_motion_m=None):
    """A CT-ICP profile: the aggregated map, elastic point-to-plane GN, the
    mid-sweep pose, f32 uploads of up to 65,536 points, one frame per step."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import \
        ICPFrameToModelConfig
    extra = {} if reassoc_motion_m is None else {"reassoc_motion_m": reassoc_motion_m}
    return ICPFrameToModelConfig(
        max_num_alignments=max_num_alignments, reassoc_every=reassoc_every,
        pose_type="mid_pose", data_key="numpy_pc",
        alignment={"mode": "point_to_plane_gauss_newton", "elastic": True,
                   "gauss_newton_config": dict(_ELASTIC_GN, **gn)},
        local_map=dict(_AGG_MAP, **(local_map or {})),
        num_points_padded=65536, **extra)


def profile_configs():
    """The repo's CT-ICP profiles and its high-speed profile
    (``config/slam/odometry/<name>.yaml``), with the runner settings they
    are run with: f32 uploads padded to 65,536 points for the CT-ICP
    profiles; batched rimg8 uploads (12 frames) for the highway profile.
    Also the voxel-table map's bench configuration."""
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import \
        ICPFrameToModelConfig
    return {
        "ct_icp": _ct_profile(12, 2, {
            "max_dist_to_plane": 0.5, "beta_location_consistency": 0.001,
            "beta_constant_velocity": 0.001}),
        "ct_icp_drive": _ct_profile(8, 8, {
            "max_dist_to_plane": 0.3, "beta_location_consistency": 0.001,
            "beta_constant_velocity": 0.001}, reassoc_motion_m=0.2),
        "ct_icp_robust_drive": _ct_profile(12, 12, {
            "sigma_start": 1.0, "sigma_anneal_iters": 4, "max_dist_to_plane": 0.5,
            "beta_location_consistency": 0.001,
            "beta_orientation_consistency": 0.01},
            local_map={"max_neighbor_dist_start": 3.0}, reassoc_motion_m=0.2),
        "ct_icp_robust_shaky": _ct_profile(16, 16, {
            "sigma_start": 1.0, "sigma_anneal_iters": 6, "max_dist_to_plane": 0.8,
            "beta_small_velocity": 0.01},
            local_map={"window_rows": 2, "window_cols": 3,
                       "max_neighbor_dist_start": 3.0}, reassoc_motion_m=0.15),
        "ct_icp_slow_outdoor": _ct_profile(6, 6, {
            "max_dist_to_plane": 0.3, "beta_small_velocity": 0.02},
            local_map={"max_neighbor_dist": 0.6}, reassoc_motion_m=0.1),
        # Merged-model normal refits with the centered window fit and a
        # 10-insert model age.
        "aggregated_highway": ICPFrameToModelConfig(
            max_num_alignments=12, reassoc_every=8, reassoc_motion_m=0.2,
            data_key="numpy_pc",
            local_map=dict(_AGG_MAP, local_map_size=10, max_neighbor_dist=0.6,
                           model_normals=True, normals_fit="centered"),
            alignment={"mode": "point_to_plane_gauss_newton",
                       "gauss_newton_config": {"scheme": "geman_mcclure",
                                               "sigma": 0.4, "max_iters": 1}},
            num_points_padded=66560, upload_format="rimg8", batch_size=12),
        # The voxel-table map as bench.build_icp_config("voxel", "rimg8")
        # builds it with the bench's defaults: the aggregated champion's
        # schedule and alignment, batched rimg8 uploads.
        "voxel": ICPFrameToModelConfig(
            max_num_alignments=8, reassoc_every=8, reassoc_motion_m=0.2,
            data_key="numpy_pc",
            local_map={"type": "voxel_local_map", "local_map_size": 30,
                       "map_voxel": 0.4, "max_neighbor_dist": 0.4,
                       "table_slots": 262144, "target_samples": 8192},
            alignment={"gauss_newton_config": {"scheme": "geman_mcclure",
                                               "sigma": 0.4, "max_iters": 1}},
            num_points_padded=66560, upload_format="rimg8", batch_size=12),
    }


def champion_configs():
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import \
        ICPFrameToModelConfig
    return {
        # Surfel champion: the surfel ("kdtree") map, exact NN (kernel B2)
        # re-searched every iteration, cross-frame k-NN map normals,
        # neighborhood weights with sigma 0.2, per-frame float32 uploads.
        "surfel": ICPFrameToModelConfig(
            max_num_alignments=20, reassoc_every=1,
            local_map={"type": "kdtree_local_map", "local_map_size": 30,
                       "points_per_frame": 4096, "sample_voxel_size": 0.3,
                       "levenberg_damping": 0.0, "normals_mode": "knn"},
            alignment={"gauss_newton_config": {"scheme": "neighborhood",
                                               "sigma": 0.2,
                                               "max_iters": 1}},
            num_points_padded=65536, data_key="numpy_pc"),
        # Motion-gated schedule (8 GN iterations, re-rasterize on > 0.2 m of
        # motion), window 1x2 gated at 0.6 m, geman_mcclure sigma 0.4,
        # batched rimg8 uploads (2 B/pixel z-buffered ranges).
        "aggregated": ICPFrameToModelConfig(
            max_num_alignments=8, reassoc_every=8, reassoc_motion_m=0.2,
            local_map={"type": "aggregated_local_map", "local_map_size": 20,
                       "window_rows": 1, "window_cols": 2,
                       "max_neighbor_dist": 0.6},
            alignment={"gauss_newton_config": {"scheme": "geman_mcclure",
                                               "sigma": 0.4,
                                               "max_iters": 1}},
            num_points_padded=66560, batch_size=12, upload_format="rimg8",
            data_key="numpy_pc"),
    }


def build_odometry(name: str, device=None):
    """The champion `name`'s odometry on the acceptance sequence's
    projector, on the card unless `device` says otherwise."""
    from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    proj = SphericalProjection(SEQ_KW["lidar_height"], SEQ_KW["lidar_width"],
                               UP_FOV, DOWN_FOV)
    return ICPFrameToModel(champion_configs()[name], projector=proj, device=device)


def stamp_files(package_dir: Path = PACKAGE_DIR) -> list:
    """The Python modules the stamp hashes, in a fixed order."""
    files = set()
    for pattern in STAMP_MODULES:
        files.update(package_dir.glob(pattern))
    return sorted(files, key=lambda f: f.relative_to(package_dir).as_posix())


def code_stamp(package_dir: Path = PACKAGE_DIR) -> str:
    """Hash of what decides the champions' trajectories: each champion's
    ``repr(config)``, the ``ast.dump`` of every module in ``STAMP_MODULES``
    (comment and layout edits keep the stamp, any code or docstring edit
    changes it), the bytes of the CUDA sources and of the host encoder's
    source, and the nvcc flags.

    The port has no traced program to hash, as the JAX package hashes its
    jaxprs, so it hashes its sources.  It hashes no torch version, device
    or absolute path: the CPU host and the card compute the same stamp.
    """
    from pylidar_slam_tpu_torch.ops.kernels.cuda_build import NVCC_FLAGS
    h = hashlib.sha256()
    for name, cfg in sorted(champion_configs().items()):
        h.update(name.encode())
        h.update(repr(cfg).encode())
    for f in stamp_files(package_dir):
        h.update(f.relative_to(package_dir).as_posix().encode())
        h.update(ast.dump(ast.parse(f.read_text())).encode())
    for f in sorted((package_dir / "csrc").glob("*.cu")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update((package_dir.parent / STAMP_NATIVE).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def stamp_array(stamp: str) -> np.ndarray:
    return np.frombuffer(stamp.encode(), dtype=np.uint8).copy()
