"""The record the per-layer readers read: the program's own spans and
counts (``span.<name>.s``, ``.self_s``, ``.n``, ``count.<name>``) over the
part of the window the readers take, and readers of them added as files."""
from __future__ import annotations

import json
import uuid

from conftest import run_cell

# Readers of a program span and a program count, each added as a file.
READERS = {
    "upload_calls": ('"""Calls of the odometry\'s upload span."""\n\n\n'
                     'def read(run):\n'
                     '    return run["counters"].get("span.odometry.upload.n") or None\n'),
    "frames_stepped": ('"""Frames the odometry stepped."""\n\n\n'
                       'def read(run):\n'
                       '    return run["counters"].get("count.odometry.frames_stepped") or None\n'),
}


BATCH = 4


def add_readers(root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, source in READERS.items():
        (root / "slambench/metrics" / f"{name}.py").write_text(source)
        spec["per_layer"].append({"name": name, "unit": "calls", "better": "lower",
                                  "source": "program_span", "layer": "odometry",
                                  "moves": "scans_per_s", "workloads": ["agg-offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def probed_run(root, capsys, monkeypatch, trace: int):
    """A run of agg-offline, at batch 4 so that its window holds several
    batches on the CPU, whose every hand-over to the program opens the
    span and count `every`, and whose window's hand-overs also open the
    span `inside`, never used before the window; returns the result line,
    the harness's window and the readers' record."""
    from pylidar_slam_tpu_torch.utils import timer
    from slambench import harness
    mix = json.loads((root / "slambench/traffic/road.json").read_text())
    mix.update(batch=BATCH, prep_workers=1, setup_frames=5)
    (root / "slambench/traffic/road.json").write_text(json.dumps(mix))
    tag = uuid.uuid4().hex[:8]
    every, inside = f"probe.{tag}.every", f"probe.{tag}.inside"
    process, loop, layer_record = (harness.OdometryDriver.process, harness.LOOPS["closed"],
                                   harness.layer_record)
    seen = {}

    def probed_process(self, frame):
        with timer.span(every):
            if getattr(self, "in_window", False):
                with timer.span(inside):
                    process(self, frame)
            else:
                process(self, frame)
        timer.count(every)

    def probed_loop(driver, *a, **k):
        driver.in_window = True
        return loop(driver, *a, **k)

    def kept_record(cell, window, driver):
        seen["window"] = window
        seen["record"] = layer_record(cell, window, driver)
        return seen["record"]

    monkeypatch.setattr(harness.OdometryDriver, "process", probed_process)
    monkeypatch.setitem(harness.LOOPS, "closed", probed_loop)
    monkeypatch.setattr(harness, "layer_record", kept_record)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.5)  # the window reaches past the trace
    rc, line = run_cell(root, "agg-offline", seed=31 + trace, seconds=3.0, trace=trace,
                        capsys=capsys)
    assert rc == 0 and line["correct"], line
    counters = seen["record"]["counters"]
    return line, seen["window"], seen["record"], counters[f"span.{every}.n"], \
        counters[f"count.{every}"], counters.get(f"span.{inside}.n")


def test_set_up_is_not_counted_and_a_span_new_in_the_window_is(tiny_root, capsys,
                                                                monkeypatch):
    """Untraced: the record counts the window's hand-overs alone, not the
    set-up's, and a span first used in the window from 0."""
    _, window, record, every_n, every_count, inside_n = probed_run(
        tiny_root, capsys, monkeypatch, trace=0)
    frames = window["frames"]
    assert window["traced"] is None and record["window"]["frames"] == frames > 0
    assert every_n == every_count == inside_n == frames
    assert record["counters"]["span.odometry.upload.n"] > 0


def test_a_traced_run_counts_the_part_after_the_trace(tiny_root, capsys, monkeypatch):
    """Traced: the record holds the part of the window after the profiler
    closed, and readers added as files read a program span and a count
    from it."""
    add_readers(tiny_root)
    line, window, record, every_n, every_count, inside_n = probed_run(
        tiny_root, capsys, monkeypatch, trace=1)
    traced = window["traced"]["frames"]
    part = record["window"]["frames"]
    assert 0 < traced < window["frames"] and part == window["frames"] - traced
    assert every_n == every_count == inside_n == part
    counters = record["counters"]
    assert line["metrics"]["upload_calls"]["value"] == counters["span.odometry.upload.n"] > 0
    stepped = line["metrics"]["frames_stepped"]["value"]
    assert stepped == counters["count.odometry.frames_stepped"]
    assert abs(stepped - part) <= BATCH  # a batch's frames wait for the next flush
