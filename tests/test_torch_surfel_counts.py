"""The surfel map's spans and counts in ``utils.timer``, and the registry's
counts that are added up on the device.

A tiny CPU run of the surfel odometry at batch 1 (16 x 256 scans, K = 4
frames x S = 256 map points, a target slot a pixel, buckets of 4 slots so
that the hash grid drops points): each count equals what the per-frame
diagnostics and the map states give.  The registry: a snapshot with no
device count reads nothing from a device, and ``delta`` takes the device
counts as it takes the host's.

This file imports no jax.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from slambench import harness  # noqa: E402
from slambench.traffic import generator  # noqa: E402

from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm  # noqa: E402
from pylidar_slam_tpu_torch.utils import timer  # noqa: E402

H, W, K, S = 16, 256, 4, 256
FRAMES, TRIPS = 9, 20
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_surfel_counts_equal_the_diagnostics(monkeypatch):
    cfg = json.loads((REPO / "slambench/configs/hdl64-kdtree-f2m.json").read_text())
    cfg["sensor"].update(lidar_height=H, lidar_width=W)
    program = cfg["program"]
    # a slot a pixel, so that some target rows are padding
    program["local_map"].update(local_map_size=K, points_per_frame=S, target_samples=H * W,
                                hash_capacity=4)
    program["num_points_padded"] = H * W
    traffic = harness.load_traffic(REPO, "road-fullmap")
    traffic["route"]["cycle_frames"] = 64
    clouds = generator.make_scans(traffic, cfg["sensor"], 6, CPU).clouds

    monkeypatch.setattr(timer, "_device_counts", {})
    dropped = []  # what each hash grid built left out of a full bucket
    build = sm.build_hash_grid

    def recording(points, valid, *a):
        slots = build(points, valid, *a)
        dropped.append(int(valid.sum()) - int((slots >= 0).sum()))
        return slots
    monkeypatch.setattr(sm, "build_hash_grid", recording)
    queries = []  # the valid targets of each frame
    sample = sm._grid_sample_fixed

    def sampling(points, mask, voxel, capacity):
        out = sample(points, mask, voxel, capacity)
        if capacity == H * W:
            queries.append(int(out[2].sum()))
        return out
    monkeypatch.setattr(sm, "_grid_sample_fixed", sampling)
    drv = harness.OdometryDriver(program, cfg["sensor"], 1, CPU)
    steps = []  # (valid map points before the frame, iterations, inserted)
    step = drv.odom._map.step

    def logged(state, *a):
        out = step(state, *a)
        steps.append((int(state.valid.sum()), int(out[4][1]), bool(out[4][3])))
        return out
    monkeypatch.setattr(drv.odom, "_map", drv.odom._map._replace(step=logged))

    before = timer.snapshot()
    for i in range(FRAMES):
        drv.process(drv.prepare(clouds[i]))
    d = timer.delta(before, timer.snapshot())

    assert len(steps) == FRAMES - 1 and len(dropped) == FRAMES  # frame 0's insert
    assert len(queries) == len(steps) and max(queries) < H * W  # padding rows are not counted
    iters = np.array([it for _, it, _ in steps])
    assert 1 <= iters.min() and iters.max() <= TRIPS and iters.sum() < TRIPS * len(steps)
    assert d["count.surfel.nn_calls"] == TRIPS * len(steps)
    assert d["count.surfel.nn_active_calls"] == iters.sum()
    assert d["count.surfel.nn_pairs"] == sum(it * q * v for (v, it, _), q in zip(steps, queries))
    inserted = [True] + [ins for _, _, ins in steps]
    assert 0 < sum(dropped)
    assert d["count.surfel.knn_dropped"] == sum(n for n, ins in zip(dropped, inserted) if ins)
    for name in ("odometry.dequant", "odometry.register", "odometry.map_update"):
        assert d[f"span.{name}.n"] == len(steps)
    assert d["span.odometry.dispatch.s"] >= d["span.odometry.register.s"] > 0


def test_snapshot_without_device_counts_reads_no_device(monkeypatch):
    monkeypatch.setattr(timer, "_device_counts", {})

    def no_read(self):
        raise AssertionError("the snapshot read a tensor")
    monkeypatch.setattr(torch.Tensor, "item", no_read)
    timer.count("t.host_only")
    assert "count.t.host_only" in timer.snapshot()


def test_delta_over_device_counts(monkeypatch):
    monkeypatch.setattr(timer, "_device_counts", {})
    timer.device_counts(("t.dev",), torch.tensor(3))
    timer.device_counts(("t.a", "t.b"), torch.tensor([1, 2]))
    s0 = timer.snapshot()
    timer.device_counts(("t.dev",), torch.tensor([4], dtype=torch.int32))
    timer.device_counts(("t.dev",), torch.tensor([True]))
    timer.device_counts(("t.a", "t.b"), torch.tensor([10.0, 20.5]))
    timer.device_counts(("t.dev.new", "t.dev"), torch.tensor([2.5, 1.0]))
    s1 = timer.snapshot()
    assert (s0["count.t.dev"], s0["count.t.a"], s0["count.t.b"]) == (3, 1, 2)
    d = timer.delta(s0, s1)
    assert d["count.t.dev"] == 6 and d["count.t.dev.new"] == 2.5
    assert (d["count.t.a"], d["count.t.b"]) == (10, 20.5)


def test_device_counts_keep_a_sum_per_device(monkeypatch):
    """A count added on two devices keeps a sum on each (no add across
    devices) and the snapshot adds them."""
    monkeypatch.setattr(timer, "_device_counts", {})
    devices = [CPU, torch.device("meta")]
    for dev in devices:
        timer.device_counts(("t.both",), torch.tensor([2], device=dev))
    assert {k[1] for k in timer._device_counts} == set(devices)
    assert timer._device_counts[(("t.both",), CPU)].item() == 2
    monkeypatch.delitem(timer._device_counts, (("t.both",), torch.device("meta")))
    timer.device_counts(("t.both",), torch.tensor([3]))
    assert timer.snapshot()["count.t.both"] == 5


@pytest.mark.gpu
def test_device_counts_on_the_cpu_then_the_card(monkeypatch):
    """A count added on the CPU and then on the card (a CPU run, then a run
    on the card, in one process) sums the two at the snapshot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(timer, "_device_counts", {})
    timer.device_counts(("t.both", "t.other"), torch.tensor([2, 1]))
    card = torch.device("cuda", 0)
    for _ in range(3):
        timer.device_counts(("t.both", "t.other"), torch.tensor([5, 0], device=card))
    assert timer.snapshot()["count.t.both"] == 17
    assert timer.snapshot()["count.t.other"] == 1
