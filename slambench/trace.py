"""The traced run's reduction: device kernels and harness spans from one
``torch.profiler`` window to the numbers the per-layer readers take.

The profiler's window opens with ``FILLER`` spin kernels, left out of every
count: once other processes have used the card, the profiler drops the
first kernel records of a window, and the filler takes that loss
(``chip_smoke.py``, ``PROFILE_FILLER``, :1754-1762).  Device time and the
traced window's wall time come from the same window, in the profiler's one
clock.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

FILLER = 256
FILLER_NAME = "spin_kernel"  # torch.cuda._sleep's kernel
SPAN_PREFIX = "slambench."
WINDOW_SPAN = SPAN_PREFIX + "window"


class Tracer:
    """Profiles the card from `start()` to `stop()`; ``span(name)`` marks a
    harness stage on the host (a no-op when not tracing)."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self._prof = None
        self._window = None

    def span(self, name: str):
        if not self.enabled or self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        if self.cuda:
            for _ in range(FILLER):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def stop(self):
        """Closes the window after a synchronize; ``reduce()`` reads it."""
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def reduce(self) -> dict:
        """The closed window's numbers (run after the measured window: the
        profiler's records are read here)."""
        return reduce_events(self._done.profiler.kineto_results.events())


def _union(intervals):
    """Total length and the gaps of a set of (start, end) intervals within
    their hull, sorted by start."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def reduce_events(events) -> dict:
    """Kernel counts and times by name, the union of kernel intervals
    (busy), the window's length and its idle gaps labelled by the harness
    span open on the host at the gap's middle; times in seconds."""
    window = None
    spans = []
    kernels = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # harness spans; the profiler mirrors each on the device too
            if e.device_type() == cuda:
                continue
            if name == WINDOW_SPAN:
                window = (e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            else:
                spans.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, name[len(SPAN_PREFIX):]))
        elif e.device_type() == cuda and FILLER_NAME not in name:
            kernels.append((name, e.start_ns() * 1e-3, e.end_ns() * 1e-3))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in kernels if e > w0 and s < w1]
    time_by, count_by = defaultdict(float), defaultdict(int)
    for name, s, e in inside:
        time_by[name] += (e - s) * 1e-6
        count_by[name] += 1
    busy, gaps = _union([(s, e) for _, s, e in inside])
    edges = [(w0, min(s for _, s, _ in inside))] if inside else [(w0, w1)]
    if inside:
        edges.append((max(e for _, _, e in inside), w1))
    labelled = []
    longest = sorted(gaps + [x for x in edges if x[1] > x[0]], key=lambda g: g[0] - g[1])
    for g0, g1 in longest[:10]:
        mid = 0.5 * (g0 + g1)
        # the innermost harness span open at the gap's middle
        open_ = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_ else "none"
        labelled.append((label, (g1 - g0) * 1e-6))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": len(inside), "kernel_time_s": dict(time_by),
            "kernel_count": dict(count_by), "idle_gaps": labelled}


def kernel_sum(trace: dict, *fragments: str):
    """(launch count, device seconds) of the kernels whose names hold any
    of `fragments`."""
    n = t = 0
    for name, count in trace["kernel_count"].items():
        if any(f in name for f in fragments):
            n += count
            t += trace["kernel_time_s"][name]
    return n, t


def short_name(kernel: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    if kernel.endswith(")"):
        depth = 0
        for i in range(len(kernel) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(kernel[i], 0)
            if depth == 0:
                kernel = kernel[:i]
                break
    return kernel[:120]


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernel_time_s"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[short_name(n), t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in trace["idle_gaps"]]}


def odometry_program(config: dict) -> dict:
    program = config["program"]
    return program["odometry"] if "odometry" in program else program


def kernels_per_frame(run: dict):
    t = run["trace"]
    if t is None or not t["frames"] or not t["kernels"]:
        return None
    return t["kernels"] / t["frames"]


def idle_share(run: dict):
    t = run["trace"]
    if t is None or t["window_s"] <= 0.0 or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
