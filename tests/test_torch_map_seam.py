"""The odometry's one path to its maps (``local_map.LocalMap``), on the
CPU at 32 x 256: the batched loop and the flush of a partial batch, and
the pipeline's question whether the odometry buffers uploads.

This file imports no jax.
"""
import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.slam.odometry import icp_odometry as icp
from pylidar_slam_tpu_torch.slam.slam import SLAM, SLAMConfig

H, W = 32, 256
B, N = 6, 1 + 2 * 6 + 5  # frame 0, two batches of 6, a remainder of 5
RIMG8 = dict(upload_format="rimg8", num_points_padded=H * W + (H + W + 1) // 2)
MAPS = {
    "aggregated": dict(RIMG8, local_map={"type": "aggregated_local_map",
                                         "max_neighbor_dist": 0.6}),
    # the kdtree-offline cell's map and f32 uploads, cut to a ring of 4 x 512
    "surfel": dict(num_points_padded=H * W, reassoc_every=1,
                   local_map={"type": "kdtree_local_map", "local_map_size": 4,
                              "points_per_frame": 512, "target_samples": 2048}),
    "voxel": dict(RIMG8, local_map={"type": "voxel_local_map", "table_slots": 16384,
                                    "target_samples": 2048}),
    "projective": dict(num_points_padded=H * W,
                       local_map={"type": "projective_local_map", "local_map_size": 4}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N)))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _config(name: str, batch: int) -> dict:
    return dict(algorithm="icp_F2M", device="cpu", data_key="numpy_pc", batch_size=batch,
                max_num_alignments=6,
                alignment={"gauss_newton_config": {"scheme": "geman_mcclure", "sigma": 0.4}},
                **MAPS[name])


@pytest.mark.parametrize("name", ["aggregated", "surfel", "voxel"])
def test_batches_and_remainder_equal_frames_stepped_one_at_a_time(loader, frames, name):
    """Two batches of 6 and a remainder of 5, flushed at ``finish()`` as a
    shorter batch: the params of the same frames stepped one at a time,
    each fed the previous frame's pose as its prior, bit for bit and in
    order; the pose stream handed downstream is theirs too."""
    batched = icp.ICPFrameToModel(_config(name, B), projector=loader.projector())
    batched.emit_batch_poses = True
    stream = []
    for f in frames:
        batched.process_next_frame(dict(f))
        stream += batched.drain_batch_results()
    stream += batched.drain_batch_results(final=True)
    params = batched.fetch_params_log()

    single = icp.ICPFrameToModel(_config(name, 1), projector=loader.projector())
    last = None
    for f in frames:
        d = dict(f) if last is None else dict(f, init_rpose=last)
        single.process_next_frame(d)
        last = d["odometry_pose"]
    ref = single.fetch_params_log()

    assert batched.pipe_stats["flushes"] == 3  # the remainder is a flush
    assert single.pipe_stats["flushes"] == 0
    assert params.shape == ref.shape == (N, 6)
    assert np.array_equal(params, ref)
    assert len(stream) == N - 1
    for got, p in zip(stream, ref[1:]):
        assert np.array_equal(got, icp._pose_matrix_f64(p))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", list(MAPS))
def test_host_prepare_encodes_only_buffered_uploads(loader, frames, name, batch):
    """``SLAM.host_prepare`` encodes a frame's upload ahead exactly where
    the odometry buffers uploads: a map that steps them, at batch > 1;
    never at batch 1 or on the projective map, which steps vertex maps."""
    slam = SLAM(SLAMConfig(odometry=_config(name, batch)), projector=loader.projector(),
                device="cpu")
    slam.init()
    frame = dict(frames[1])
    slam.host_prepare(frame)
    buffered = name != "projective" and batch > 1
    assert slam.odometry.buffers_uploads is buffered
    assert ("encoded_upload" in frame) is buffered
    if buffered:
        assert np.array_equal(frame["encoded_upload"],
                              slam.odometry.encode_upload(frames[1]["numpy_pc"]))
