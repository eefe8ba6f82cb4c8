"""The traffic generator: routes that close on themselves, a road that
never revisits, and scans drawn from the seed."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from conftest import REPO
from slambench.traffic import generator

SENSOR = {"lidar_height": 16, "lidar_width": 128, "up_fov": 3.0, "down_fov": -24.0,
          "max_range_m": 70.0, "noise_std_m": 0.008}


def traffic(name):
    from slambench.harness import load_traffic
    return load_traffic(REPO, name)


def test_a_mix_over_a_base_mix(tmp_path):
    """A mix that names a base is the base with the mix's keys put over it;
    a mix that is its own base is refused."""
    from slambench.harness import load_traffic
    d = tmp_path / "slambench" / "traffic"
    d.mkdir(parents=True)
    (d / "a.json").write_text(json.dumps({"route": {"shape": "sine"}, "batch": 12}))
    (d / "b.json").write_text(json.dumps({"base": "a", "batch": 1, "loop": "open"}))
    (d / "c.json").write_text(json.dumps({"base": "c"}))
    assert load_traffic(tmp_path, "b") == {"route": {"shape": "sine"}, "batch": 1,
                                           "loop": "open"}
    with pytest.raises(ValueError):
        load_traffic(tmp_path, "c")


@pytest.mark.parametrize("name", ["road", "circuit"])
def test_routes_are_periodic(name):
    """Frame i + N sees the world frame i sees: noiseless ranges from the
    pose one cycle on equal those of the first pose, so scan i + N is scan i."""
    t = traffic(name)
    n = int(t["route"]["cycle_frames"])
    poses = generator.route_poses(t["route"], n + 1)
    scans = generator.Scans([None] * n, poses[:n], np.eye(4))
    if t["route"]["shape"] == "sine":
        scans = scans._replace(period=np.diag([1.0, 1.0, 1.0, 1.0]))
        scans.period[0, 3] = n * t["route"]["speed_m"]
    np.testing.assert_allclose(generator.pose_of_frame(scans, n), scans.period @ poses[0],
                               atol=1e-9)
    walls, pillars = generator.make_world(t["route"], t["world"], n, seed=5)
    dirs = generator.beam_directions(SENSOR, "cpu")
    w, p = torch.as_tensor(walls), torch.as_tensor(pillars)

    def ranges(pose):
        pose = torch.as_tensor(pose)
        return generator.raycast(w, p, pose[:3, 3], dirs @ pose[:3, :3].T, 70.0)

    a, b = ranges(poses[0]), ranges(generator.pose_of_frame(scans, n))
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    fin = torch.isfinite(a)
    assert float((a[fin] - b[fin]).abs().max()) < 1e-6
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert abs(float(np.median(steps)) - t["route"]["speed_m"]) < 0.05


def candidates(route, n, frames, lc):
    """The loop closure's candidate search (slam/loop_closure.py:416-431) on
    the ground-truth poses: per submap event, the stored submaps at least
    min_id_distance frames back and within max_distance."""
    scans = generator.Scans([None] * n, generator.route_poses(route, n), np.eye(4))
    if route["shape"] == "sine":
        scans.period[0, 3] = n * route["speed_m"]
    size, overlap = lc["local_map_size"], lc["overlap"]
    back = max(lc["min_id_distance"] // max(size - overlap, 1), 1)
    mids, found = [], []
    for k in range((frames - size) // (size - overlap) + 1):
        mid = k * (size - overlap) + size // 2
        pos = generator.pose_of_frame(scans, mid)[:3, 3]
        old = [generator.pose_of_frame(scans, m)[:3, 3] for m in mids[:-back]] \
            if len(mids) > back else []
        found.append(sum(np.linalg.norm(o - pos) < lc["max_distance"] for o in old))
        mids.append(mid)
    return found


def test_the_road_never_revisits_and_the_circuit_does():
    lc = json.loads((REPO / "slambench/configs/hdl64-slam-lc.json").read_text())
    lc = lc["program"]["loop_closure"]
    road = candidates(traffic("road")["route"], 128, 2000, lc)
    assert sum(road) == 0
    circ = traffic("circuit")
    found = candidates(circ["route"], 300, 301 + 600, lc)
    size, overlap = lc["local_map_size"], lc["overlap"]
    first_window_event = math.ceil((circ["setup_frames"] - size) / (size - overlap))
    assert all(c > 0 for c in found[first_window_event:])


def test_seeds_make_the_scans():
    t = traffic("road")
    t["route"]["cycle_frames"] = 4
    a = generator.make_scans(t, SENSOR, 2 ** 31 + 7, "cpu")
    b = generator.make_scans(t, SENSOR, 2 ** 31 + 7, "cpu")
    c = generator.make_scans(t, SENSOR, 2 ** 31 + 8, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.clouds, b.clouds))
    assert not any(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a.clouds, c.clouds))
