"""The batched odometry's CUDA graph (``icp_odometry._FrameGraph``) over the
aggregated and the surfel map, on the CPU.

On CPU tensors the batched path never captures.  The graph's bookkeeping
(static slots, the state written back after each frame, one graph per
upload key, dropped by ``init()``, the host counts recorded at the capture
and added by each replay) is run here by a stand-in that steps the slots
eagerly where the real class captures and replays: its poses and map
state equal the eager batched path's bit for bit.  The card's cases (real
capture and replay against eager) are in ``tests/test_torch_gpu.py``.

This file imports no jax.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops import projection
from pylidar_slam_tpu_torch.slam.odometry import icp_odometry as icp
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
from pylidar_slam_tpu_torch.utils import timer

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from slambench import harness  # noqa: E402
from slambench.traffic import generator  # noqa: E402

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


class _Undone:
    """Stands in for a CUDA graph at its capture: the frame enqueued
    between ``capture_begin`` and ``capture_end`` runs here, and what it
    wrote to the slots and added to the device counts is undone at the
    end."""

    def __init__(self, graph):
        self.graph = graph
        self.held = self.sums = None

    def capture_begin(self, **_):
        g = self.graph
        self.held = [t.clone() for t in g.state + (g.delta, g.rpose)]
        self.sums = {k: t.clone() for k, t in timer._device_counts.items()}

    def capture_end(self):
        *state, delta, rpose = self.held
        self.graph.load(type(self.graph.state)(*state), delta, rpose)
        for k, t in self.sums.items():
            timer._device_counts[k].copy_(t)


class _EagerGraph(icp._FrameGraph):
    """The real class's slots, write-back and count bookkeeping, stepped
    eagerly where it captures and replays: the capture's recorded frame
    leaves the slots as they were, and a replayed frame's own counts are
    dropped for those the capture recorded."""

    @staticmethod
    def runs_on(device):
        return True

    def capture(self, points, mask, out):
        self.points.copy_(points)
        self.mask.copy_(mask)
        out.copy_(self._frame())
        self._record(_Undone(self))

    def replay(self, points, mask, out):
        self.points.copy_(points)
        self.mask.copy_(mask)
        with timer.recorded_counts():
            out.copy_(self._frame())
        self._add_counts()


def _odometry(loader, **over):
    over = dict(dict(num_points_padded=CAP, batch_size=4), **over)
    cfg = dataclasses.replace(tacc.champion_configs()["aggregated"], device="cpu", **over)
    return icp.ICPFrameToModel(cfg, projector=loader.projector())


def _feed(odom, frames, names=COUNTS):
    """Runs `frames` and returns (relative poses, map state on the host,
    the change of the counts `names`)."""
    before = timer.snapshot()
    for f in frames:
        odom.process_next_frame(dict(f))
    poses = odom.get_relative_poses()
    after = timer.snapshot()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    return poses, [t.clone() for t in odom._map_state], counts


def _assert_same(a, b):
    assert np.array_equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_cpu_tensors_never_capture(loader, frames):
    odom = _odometry(loader)
    assert odom._map.graph_safe
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
    # the aggregated step counts nothing on the host: a replay adds nothing
    assert odom._graphs[(torch.uint8, CAP, 2)].counts == {}

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


# -- the surfel map, at the surfel counts' small widths --------------------

SH, SW, SK, SS = 16, 256, 4, 256
SB, SN = 2, 8  # frame 0, three batches of 2, a remainder of 1
SURFEL_COUNTS = COUNTS + ("count.surfel.nn_calls", "count.surfel.nn_active_calls",
                          "count.surfel.nn_pairs", "count.surfel.knn_dropped")


def _surfel_setup():
    """The kdtree-offline configuration's program and sensor cut to 16 x 256
    and a ring of 4 x 256, as ``tests/test_torch_surfel_counts.py`` runs it
    (buckets of 4 slots, so the k-NN grid drops points)."""
    cfg = json.loads((REPO / "slambench/configs/hdl64-kdtree-f2m.json").read_text())
    cfg["sensor"].update(lidar_height=SH, lidar_width=SW)
    program = cfg["program"]
    program["local_map"].update(local_map_size=SK, points_per_frame=SS,
                                target_samples=SH * SW, hash_capacity=4)
    program.update(num_points_padded=SH * SW, batch_size=SB, device="cpu")
    return program, cfg["sensor"]


@pytest.fixture(scope="module")
def surfel_scans():
    program, sensor = _surfel_setup()
    traffic = harness.load_traffic(REPO, "road-fullmap")
    traffic["route"]["cycle_frames"] = 64
    clouds = generator.make_scans(traffic, sensor, 6, torch.device("cpu")).clouds
    return [{"numpy_pc": clouds[i]} for i in range(SN)]


def _surfel_odometry():
    program, sensor = _surfel_setup()
    return icp.ICPFrameToModel(program, projector=harness.projector_of(sensor))


def test_surfel_graph_slots_and_counts_match_eager(surfel_scans, monkeypatch):
    """The surfel step's state (seven tensors, the exact backend's empty
    hash tables among them) round-trips the slots: poses, every state
    tensor and the device counts equal the eager batched path's.  The
    capture records the 20 searches its frame enqueues on the host and
    counts none of them; each replay adds them, so ``surfel.nn_calls``
    reads 20 a frame stepped either way."""
    monkeypatch.setattr(timer, "_device_counts", {})
    eager = _feed(_surfel_odometry(), surfel_scans, SURFEL_COUNTS)
    monkeypatch.setattr(icp, "_FrameGraph", _EagerGraph)
    odom = _surfel_odometry()
    assert odom._map.graph_safe
    graphed = _feed(odom, surfel_scans, SURFEL_COUNTS)
    assert isinstance(odom._map_state, sm.SurfelMapState)
    assert odom._map_state.table_pts.numel() == 0
    _assert_same(graphed, eager)
    # batch 1 eager; 2 captures on its first frame and replays 1; 3 and
    # the remainder replay
    assert graphed[2]["count.odometry.graph_captures"] == 1
    assert graphed[2]["count.odometry.graph_replays"] == 1 + SB + 1
    (graph,) = odom._graphs.values()
    assert graph.counts == {"surfel.nn_calls": 20}
    # frame 0 only inserts
    assert graphed[2]["count.surfel.nn_calls"] == eager[2]["count.surfel.nn_calls"] \
        == 20 * (graphed[2]["count.odometry.frames_stepped"] - 1) == 20 * (SN - 1)
    for name in SURFEL_COUNTS[-3:]:
        assert graphed[2][name] == eager[2][name] > 0, name


def test_sharded_surfel_step_is_not_graph_safe(monkeypatch):
    """A step built with a process group all-reduces through the host on
    every GN trip: it stays eager.  Without one it may be captured."""
    program, sensor = _surfel_setup()
    config = icp.ICPFrameToModelConfig(**dict(program, shard_points=2))
    gn = icp.GaussNewtonConfig(**program["alignment"]["gauss_newton_config"])
    args = (harness.projector_of(sensor), program["local_map"], gn, {})
    assert sm.kdtree_local_map(dataclasses.replace(config, shard_points=0),
                               *args).graph_safe is True
    groups = []
    monkeypatch.setattr(sm, "_shard_group", lambda n: groups.append(n) or object())
    monkeypatch.setattr(sm.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(sm.dist, "get_rank", lambda group: 0)
    assert sm.kdtree_local_map(config, *args).graph_safe is False
    assert groups == [2]
