"""Fixtures of the benchmark's own tests: a copy of the benchmark shrunk to
a size the CPU runs in seconds, and the card check of the ``gpu`` tests.

Run from the repository root: ``python -m pytest slambench/tests -q``.
The tests marked ``gpu`` run on the card and skip without one.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_H, TINY_W = 32, 512


def shrink(root: Path) -> None:
    """32 x 512 scans, 64-frame routes and a loop closure of 10-frame
    submaps: the same code paths at a size the CPU runs in seconds."""
    for f in (root / "slambench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["sensor"].update(lidar_height=TINY_H, lidar_width=TINY_W)
        prog = c["program"].get("odometry", c["program"])
        prog["num_points_padded"] = TINY_H * TINY_W + (TINY_H + TINY_W + 1) // 2
        if "loop_closure" in c["program"]:
            c["program"]["loop_closure"].update(local_map_size=10, overlap=4,
                                                min_id_distance=20, im_size=128,
                                                icp_num_points=1024)
        f.write_text(json.dumps(c))
    for f in (root / "slambench" / "traffic").glob("*.json"):
        c = json.loads(f.read_text())
        if "route" not in c:  # a mix over a base mix: shrunk with its base
            continue
        if c["route"]["shape"] == "circle":
            c["route"]["cycle_frames"] = 48
            c["world"].update(num_walls=20, num_pillars=12)
            c["setup_frames"] = 49
        else:
            c["route"]["cycle_frames"] = 64
        f.write_text(json.dumps(c))


def add_open_loop_cell(root: Path) -> None:
    """An open-loop cell added as files and entries alone, as a later cell
    would be: the road's scans at the sensor's 10 Hz, batch 1, each pose
    fetched, with the pose-latency metrics.  No cell of ``BENCHMARK.json``
    runs the open loop yet (PERF.md, Open questions)."""
    (root / "slambench/traffic/road-10hz.json").write_text(json.dumps(
        {"why": "the road at 10 Hz", "base": "road", "loop": "open", "rate_hz": 10.0,
         "batch": 1}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "agg-online10hz", "config": "hdl64-aggregated",
                              "traffic": "road-10hz", "chips": 1, "why": "a test cell"})
    for name in ("pose_latency_p95_ms", "pose_latency_p50_ms"):
        spec["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["agg-online10hz"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def make_root(dst: Path, tiny: bool = True) -> Path:
    """A copy of the benchmark; `tiny` shrinks it and adds the open-loop
    cell ``agg-online10hz``."""
    shutil.copytree(REPO / "slambench", dst / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    if tiny:
        shrink(dst)
        add_open_loop_cell(dst)
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


def run_cell(root: Path, workload: str, seed: int = 5, seconds: float = 3.0,
             trace: int = 0, control: bool = False, capsys=None):
    """One run of `workload` on the CPU from `root`: (exit code, the last
    line of standard output as JSON or None)."""
    from slambench import harness
    torch.set_num_threads(4)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    rc = harness.run(args, time.perf_counter(), root, allow_cpu=True, control=control)
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture
def card():
    """The CUDA device of a ``gpu`` test; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
