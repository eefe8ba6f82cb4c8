"""The harness end to end on the CPU at a tiny size: a cell added with new
files and a ``workloads`` entry alone, the result line's keys, the refusal
without a card, and the modules a run loads."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_a_cell_added_as_files_runs(tiny_root, capsys):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and the entries that name them: no code of the harness changes."""
    cfg = json.loads((tiny_root / "slambench/configs/hdl64-aggregated.json").read_text())
    cfg["program"]["max_num_alignments"] = 6
    (tiny_root / "slambench/configs/hdl64-six-trips.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "slambench/traffic/road.json").read_text())
    mix.update(batch=4, prep_workers=2, setup_frames=5)
    (tiny_root / "slambench/traffic/road-batch4.json").write_text(json.dumps(mix))
    (tiny_root / "slambench/metrics/frames_traced.py").write_text(
        '"""Frames in the traced part of the window."""\n\n\n'
        'def read(run):\n    return None if run["trace"] is None else run["trace"]["frames"]\n')
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "hdl64-six-trips", "source": "https://example.org",
                            "file": "slambench/configs/hdl64-six-trips.json",
                            "reduced": [], "why": "six GN trips"})
    spec["workloads"].append({"name": "six-trips.road4", "config": "hdl64-six-trips",
                              "traffic": "road-batch4", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "scans_per_s", "workloads": ["six-trips.road4"]})
    spec["end_to_end"][0]["workloads"].append("six-trips.road4")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_cell(tiny_root, "six-trips.road4", trace=1, capsys=capsys)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["frames_traced"]["value"] > 0
    rc, line = run_cell(tiny_root, "six-trips.road4", trace=0, capsys=capsys)
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"scans_per_s", "setup_s"}


@pytest.mark.parametrize("workload,trace", [("agg-offline", 0), ("agg-offline", 1),
                                            ("agg-online10hz", 0), ("agg-online10hz", 1)])
def test_last_line_keys(tiny_root, capsys, workload, trace):
    """The result line holds the contract's keys in order, then ``breakdown``
    when traced and ``checks`` last; each check has its value and limit."""
    rc, line = run_cell(tiny_root, workload, seed=11 + trace, trace=trace, capsys=capsys)
    assert rc == 0
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"]


def test_refuses_without_a_card(tiny_root, capsys, monkeypatch):
    """No CUDA device: a non-zero exit code and no result line."""
    import argparse
    import time

    import torch

    from slambench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(workload="agg-offline", seed=1, seconds=1.0, trace=0)
    assert harness.run(args, time.perf_counter(), tiny_root) != 0
    assert capsys.readouterr().out == ""


def test_needs_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and slambench/: no result."""
    from conftest import make_root
    root = make_root(tmp_path, tiny=False)
    proc = subprocess.run([sys.executable, "slambench/run.py", "--workload", "agg-offline",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    """``pylidar_slam_tpu_torch`` begins with the JAX package's name and is
    not it; ``pylidar_slam_tpu.ops`` is."""
    from slambench import harness
    before = set(harness.forbidden_modules())
    for name in ("pylidar_slam_tpu_torch", "pylidar_slam_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "pylidar_slam_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(harness.forbidden_modules()) == before | {"pylidar_slam_tpu", "jax"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process, the card check skipped, loads no
    module whose top-level name is jax, jaxlib, flax or pylidar_slam_tpu
    (the run exits 3 naming them if it does)."""
    script = (
        "import sys, time, argparse\n"
        f"sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(REPO / 'slambench/tests')!r})\n"
        "from conftest import make_root\n"
        "from pathlib import Path\n"
        "import torch; torch.set_num_threads(2)\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "from slambench import harness\n"
        "a = argparse.Namespace(workload='agg-online10hz', seed=3, seconds=2.0, trace=0)\n"
        "rc = harness.run(a, time.perf_counter(), root, allow_cpu=True)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'pylidar_slam_tpu'}))\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
