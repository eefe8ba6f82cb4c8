"""The acceptance sequence and the champion configurations (port of the part
of ``pylidar_slam_tpu.eval.acceptance`` the ported slices need).

The JAX package's ``bench.build_icp_config("aggregated", "rimg8")`` is
pinned equal to the same configuration.
"""
from __future__ import annotations

SEQ_KW = dict(lidar_height=64, lidar_width=1024, num_frames=140,
              num_walls=40, num_pillars=25)
UP_FOV, DOWN_FOV = 3.0, -24.0


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
