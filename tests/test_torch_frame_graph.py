"""The batched aggregated odometry's CUDA graph (``icp_odometry._FrameGraph``),
on the CPU.

On CPU tensors the batched path never captures.  The graph's bookkeeping
(static slots, the state written back after each frame, one graph per
upload key, dropped by ``init()``) is run here by a stand-in that steps
the slots eagerly where the real class captures and replays: its poses and
map state equal the eager batched path's bit for bit.  The card's cases
(real capture and replay against eager) are in ``tests/test_torch_gpu.py``.

This file imports no jax.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops import projection
from pylidar_slam_tpu_torch.slam.odometry import icp_odometry as icp
from pylidar_slam_tpu_torch.utils import timer

H, W, N = 32, 256, 14  # frame 0, three batches of 4, a remainder of 1
SEQ = dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N + 4)
CAP = H * W + (H + W + 1) // 2 + 112  # rimg8 rows + zero padding
COUNTS = ("count.odometry.graph_captures", "count.odometry.graph_replays",
          "count.odometry.frames_stepped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**SEQ))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N + 4)]


class _EagerGraph(icp._FrameGraph):
    """The real class's slots and write-back, stepped eagerly where it
    captures and replays."""

    @staticmethod
    def runs_on(device):
        return True

    def capture(self, points, mask, out):
        self.replay(points, mask, out)

    def replay(self, points, mask, out):
        self.points.copy_(points)
        self.mask.copy_(mask)
        out.copy_(self._frame())


def _odometry(loader, **over):
    over = dict(dict(num_points_padded=CAP, batch_size=4), **over)
    cfg = dataclasses.replace(tacc.champion_configs()["aggregated"], device="cpu", **over)
    return icp.ICPFrameToModel(cfg, projector=loader.projector())


def _feed(odom, frames):
    """Runs `frames` and returns (relative poses, map state on the host,
    the counts' change)."""
    before = timer.snapshot()
    for f in frames:
        odom.process_next_frame(dict(f))
    poses = odom.get_relative_poses()
    after = timer.snapshot()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTS}
    return poses, [t.clone() for t in odom._map_state], counts


def _assert_same(a, b):
    assert np.array_equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_cpu_tensors_never_capture(loader, frames):
    odom = _odometry(loader)
    assert odom._graph_safe
    poses, _, counts = _feed(odom, frames[:N])
    assert poses.shape == (N, 4, 4)
    assert counts["count.odometry.frames_stepped"] == N
    assert counts["count.odometry.graph_captures"] == 0
    assert counts["count.odometry.graph_replays"] == 0
    assert odom._graphs == {}


def test_graph_slots_match_eager_and_init_drops_graphs(loader, frames, monkeypatch):
    eager = _feed(_odometry(loader), frames[:N])
    monkeypatch.setattr(icp, "_FrameGraph", _EagerGraph)
    odom = _odometry(loader)
    graphed = _feed(odom, frames[:N])
    _assert_same(graphed, eager)
    # flush 1 eager; flush 2 captures on its first frame and replays 3;
    # flush 3 replays 4; the remainder's frame replays
    assert graphed[2]["count.odometry.graph_captures"] == 1
    assert graphed[2]["count.odometry.graph_replays"] == 3 + 4 + 1
    assert list(odom._graphs) == [(torch.uint8, CAP, 2)]

    odom.init()
    assert odom._graphs == {}
    again = _feed(odom, frames[:N])
    _assert_same(again, eager)
    assert again[2]["count.odometry.graph_captures"] == 1


def test_new_upload_key_captures_anew(loader, frames, monkeypatch):
    """A batch of vertex-map inputs ((H*W, 3) float32 on the device) after
    rimg8 uploads ((CAP, 2) uint8) is a new key: the graph is captured for
    it, from the state the other graph left."""
    proj = loader.projector()

    def vertex_map(f):
        pts = torch.from_numpy(f["numpy_pc"])
        vmap = projection.build_vertex_map(pts, proj, mask=torch.ones(len(pts), dtype=torch.bool))
        return dict(f, numpy_pc=vmap.numpy())
    mixed = frames[:9] + [vertex_map(f) for f in frames[9:17]] + frames[17:18]
    eager = _feed(_odometry(loader), mixed)
    monkeypatch.setattr(icp, "_FrameGraph", _EagerGraph)
    odom = _odometry(loader)
    graphed = _feed(odom, mixed)
    _assert_same(graphed, eager)
    assert list(odom._graphs) == [(torch.uint8, CAP, 2), (torch.float32, H * W, 3)]
    assert graphed[2]["count.odometry.graph_captures"] == 2
    # 3 + 3 + 4 + the remainder's rimg8 frame, replayed by its graph again
    assert graphed[2]["count.odometry.graph_replays"] == 11


def test_f32_bucket_change_keeps_the_graph(loader, frames, monkeypatch):
    """float32 uploads are bucketed to 16,384 rows on the host, but padded
    to ``num_points_padded`` on the device: a bucket change is the same key
    and replays the same graph.  Zero rows decode invalid, so the padding
    changes no pose."""
    def padded(f, rows):
        pc = np.concatenate([f["numpy_pc"], np.zeros((rows, 3), np.float32)])
        return dict(f, numpy_pc=pc)
    mixed = [padded(f, 20000 if i % 3 == 0 else 0) for i, f in enumerate(frames[:N])]
    over = dict(upload_format="f32", num_points_padded=49152)
    eager = _feed(_odometry(loader, **over), mixed)
    monkeypatch.setattr(icp, "_FrameGraph", _EagerGraph)
    odom = _odometry(loader, **over)
    graphed = _feed(odom, mixed)
    _assert_same(graphed, eager)
    assert list(odom._graphs) == [(torch.float32, 49152, 3)]
    assert graphed[2]["count.odometry.graph_captures"] == 1
