"""Timing and profiling scopes (torch port of
``pylidar_slam_tpu.utils.timer``).

* ``Duration`` / ``timer`` -- wall-clock scopes with aggregation.
* ``device_timer`` -- a scope that waits for the device before it stops:
  ``torch.cuda.synchronize`` on the device of the tensor set as its
  ``sync`` (a CPU tensor needs no wait).
* ``trace`` -- a ``torch.profiler`` scope whose trace is written as a
  Chrome trace under a directory.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch


class Duration:
    """Aggregates elapsed seconds per named scope."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(f"{name}: total {self.totals[name]:.3f}s over "
                         f"{self.counts[name]} calls "
                         f"({1000 * self.mean(name):.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def timer(name: str = "", log=print):
    start = time.perf_counter()
    yield
    log(f"[timer] {name}: {1000 * (time.perf_counter() - start):.2f} ms")


@contextlib.contextmanager
def device_timer(name: str = "", sync_array=None, log=print):
    """Times a scope including the device's completion of `sync_array` (or
    of the tensor set on the context object's ``.sync`` inside the scope)."""

    class _Ctx:
        sync = sync_array

    ctx = _Ctx()
    start = time.perf_counter()
    yield ctx
    if isinstance(ctx.sync, torch.Tensor) and ctx.sync.device.type == "cuda":
        torch.cuda.synchronize(ctx.sync.device)
    log(f"[device_timer] {name}: {1000 * (time.perf_counter() - start):.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope (CPU, and CUDA where there is a card); the trace
    lands in `log_dir`/trace.json (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
