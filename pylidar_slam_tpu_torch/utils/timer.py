"""The port's spans and counters, and a profiler scope.

One registry per process, in memory, safe to use from any thread:

* ``span(name, index=None)`` -- ``with span("odometry.upload"):`` times a
  stage with two ``time.perf_counter()`` reads and adds its seconds, its
  self seconds (less the spans opened inside it on the same thread) and a
  call to `name`.  The object keeps ``t0``, ``t1`` and ``seconds`` for a
  caller that keeps its own log from the same reads.  While a
  ``torch.profiler`` runs on the calling thread, the span is also a
  profiler event named ``pls.<name>`` (with `index`, a frame or flush
  number, among its arguments when the profiler records shapes), so it
  sits on the kernels' clock in the trace.  The event is a function-scope
  record, the scope of PyTorch's own operators: unlike
  ``torch.profiler.record_function`` (a user annotation) it leaves no
  mirror on the device's timeline, and it is never entered with no
  profiler running (``record_function`` costs ~9 us a use even then on an
  H100 machine's host; a span ~1.6 us).
* ``count(name, n=1)`` -- a work count.  Inside ``recorded_counts()`` a
  thread's counts go to the dict that scope yields, not to the registry:
  the counts of a frame that a CUDA-graph capture enqueues and does not
  run, which each replay adds with ``add_counts``.
* ``device_counts(names, values)`` -- work counts that a device tensor
  holds, one element a name, added up where they live, with no host sync:
  one in-place add a call, a kernel that a captured CUDA graph replays.
  The sums are kept per names and device and read at ``snapshot()``, one
  small read each; a registry with none reads nothing from a device.
* ``snapshot()`` -- every span and count as one flat dict of numbers:
  ``span.<name>.s``, ``span.<name>.self_s``, ``span.<name>.n``,
  ``count.<name>``; ``delta(before, after)`` is the work between two.

``trace(log_dir)`` profiles a scope and writes a Chrome / Perfetto timeline
that holds the program's spans beside the kernels.
"""
from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from time import perf_counter
from typing import Dict, Optional, Sequence, Tuple

import torch

PROFILER_PREFIX = "pls."

_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_threads: list = []  # every thread's _Thread, in the order they first used one
_local = threading.local()
# (names, device) -> the float64 sums of those names on that device
_device_counts: Dict[Tuple[Tuple[str, ...], torch.device], torch.Tensor] = {}


class _Thread:
    """A thread's own totals (only that thread writes them, so a span takes
    no lock) and its innermost open span."""
    __slots__ = ("spans", "counts", "top")

    def __init__(self):
        self.spans: Dict[str, list] = {}  # name -> [seconds, self seconds, calls]
        self.counts: Dict[str, float] = {}
        self.top = None
        with _lock:
            _threads.append(self)


def _thread() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        _local.state = _Thread()
        _local.counts = _local.state.counts  # where count() adds
        return _local.state


def _profiler_event(name: str, index):
    record = torch._C._profiler._RecordFunctionFast
    rf = record(PROFILER_PREFIX + name) if index is None else \
        record(PROFILER_PREFIX + name, [], {"index": index})
    rf.__enter__()
    return rf


class span:
    """A timed stage: ``with span(name[, index]) as s:``; see the module's
    docstring."""
    __slots__ = ("name", "index", "t0", "t1", "_thread", "_parent", "_child_s", "_event")

    def __init__(self, name: str, index: Optional[int] = None):
        self.name = name
        self.index = index

    def __enter__(self) -> "span":
        try:
            th = _local.state
        except AttributeError:
            th = _thread()
        self._thread = th
        self._event = _profiler_event(self.name, self.index) if _profiling() else None
        self._parent = th.top
        th.top = self
        self._child_s = 0.0
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = t1 = perf_counter()
        if self._event is not None:
            self._event.__exit__(None, None, None)
        seconds = t1 - self.t0
        th, parent = self._thread, self._parent
        th.top = parent
        if parent is not None:
            parent._child_s += seconds
        rec = th.spans.get(self.name)
        if rec is None:
            rec = th.spans[self.name] = [0.0, 0.0, 0]
        rec[0] += seconds
        rec[1] += seconds - self._child_s
        rec[2] += 1
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def count(name: str, n: float = 1) -> None:
    try:
        counts = _local.counts
    except AttributeError:
        counts = _thread().counts
    counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recorded_counts():
    """Diverts this thread's ``count`` calls into the dict it yields, so
    that they reach no snapshot."""
    th = _thread()
    _local.counts = recorded = {}
    try:
        yield recorded
    finally:
        _local.counts = th.counts


def add_counts(counts: Dict[str, float]) -> None:
    """Adds each ``counts[name]`` to the count `name`."""
    for name, n in counts.items():
        count(name, n)


def device_counts(names: Sequence[str], values: torch.Tensor) -> None:
    """Adds ``values[i]`` to the count ``names[i]``, on the device of
    `values` (one element a name).  Each names and device keep a sum of
    their own, made at their first add, which may not fall inside a
    CUDA-graph capture: each replay would zero it again."""
    key = (tuple(names), values.device)
    acc = _device_counts.get(key)
    if acc is None:
        if values.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counts {key[0]} first used inside a CUDA-graph "
                               f"capture; add to them once before capturing")
        with _lock:
            acc = _device_counts.setdefault(
                key, torch.zeros((len(key[0]),), dtype=torch.float64, device=values.device))
    acc.add_(values.reshape(-1))


def snapshot() -> Dict[str, float]:
    """Every thread's spans and counts, summed by name; the device counts
    are read here, one small read each."""
    with _lock:
        threads = list(_threads)
        device = list(_device_counts.items())
    spans: Dict[str, list] = {}
    counts: Dict[str, float] = {}
    for th in threads:
        for name, rec in list(th.spans.items()):
            tot = spans.setdefault(name, [0.0, 0.0, 0])
            for k in range(3):
                tot[k] += rec[k]
        for name, n in list(th.counts.items()):
            counts[name] = counts.get(name, 0) + n
    for (names, _), acc in device:
        for name, n in zip(names, acc.tolist()):
            counts[name] = counts.get(name, 0) + n
    out = {}
    for name, (s, self_s, n) in spans.items():
        out[f"span.{name}.s"] = s
        out[f"span.{name}.self_s"] = self_s
        out[f"span.{name}.n"] = n
    for name, n in counts.items():
        out[f"count.{name}"] = n
    return out


def delta(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
    """`after` less `before`, over the keys of `after` (a span or count
    first used in between counts from 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope (CPU, and CUDA where there is a card); the trace
    lands in `log_dir`/trace.json (chrome://tracing, Perfetto), with the
    program's spans as ``pls.<name>`` events."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
