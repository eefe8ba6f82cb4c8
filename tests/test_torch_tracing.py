"""The port's spans and counters (``pylidar_slam_tpu_torch.utils.timer``).

The registry: nesting and self time, counts, threads, and a profiler event
only while a profiler runs.  Tiny CPU runs of ``SLAM`` at batch 1 and
batch 4: the spans' totals equal the program's own logs (``pipe_stats``,
``SLAM.elapsed_*``, ``warmup_seconds``, ``match_stats``), which read the
same clock reads.  The benchmark's side: the traced window's reduction
(``slambench/trace.py``) is not moved by the program's profiler events, and
``slambench/program_split.py`` splits the idle time and a run's part by
program span.

This file imports no jax: the ``gpu`` case runs on the card with
``python -m pytest tests/test_torch_tracing.py --noconftest -m gpu``.
"""
import contextlib
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.config import compose as tcompose, dataclass_from_dict as tdfd
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig as TCfg,
                                                      SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.slam.slam import SLAM, SLAMConfig
from pylidar_slam_tpu_torch.utils import timer

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from slambench import program_split, trace as btrace  # noqa: E402

# test_torch_slam.py's loop-closure SLAM, 13 frames: frame 0, then three
# whole batches of 4; submap events every two frames, candidates from the
# fourth submap on, one loop that the backend optimizes.
SLAM_OVERRIDES = [
    "dataset=synthetic", "dataset.num_frames=13", "dataset.lidar_height=64",
    "dataset.lidar_width=512", "dataset.turn_rate=0.01", "dataset.num_walls=40",
    "dataset.num_pillars=25", "slam/odometry/local_map=aggregated",
    "slam/odometry/alignment=point_to_plane_GN",
    "slam.odometry.alignment.gauss_newton_config.sigma=0.4",
    "slam.odometry.local_map.max_neighbor_dist=0.6", "slam.odometry.max_num_alignments=8",
    "slam.odometry.reassoc_every=8", "slam.odometry.upload_format=rimg8",
    "slam.odometry.num_points_padded=33280",
    "slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=3",
    "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=6",
    "slam.loop_closure.max_distance=1e6", "slam.loop_closure.im_size=256",
    "slam.loop_closure.pixel_size=0.25", "slam.loop_closure.min_score=0.02",
    "slam.loop_closure.icp_num_points=1024", "slam.loop_closure.max_num_candidates=1",
    "slam/backend=graph_slam"]


def _since(before: dict) -> dict:
    return timer.delta(before, timer.snapshot())


@pytest.fixture
def profiler_events(monkeypatch):
    """Names of the profiler events the registry enters."""
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def recording(name, *args):
        entered.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", recording)
    return entered


# -- the registry ----------------------------------------------------------------

def test_nesting_self_time_and_counts():
    before = timer.snapshot()
    with timer.span("t.outer", 3) as outer:
        sum(range(20000))
        with timer.span("t.inner") as inner:
            sum(range(20000))
        with timer.span("t.inner"):
            pass
    timer.count("t.items")
    timer.count("t.items", 5)
    d = _since(before)
    assert d["span.t.outer.n"] == 1 and d["span.t.inner.n"] == 2
    assert d["count.t.items"] == 6
    assert outer.t0 < inner.t0 < inner.t1 < outer.t1
    assert d["span.t.outer.s"] == pytest.approx(outer.seconds, abs=1e-12)
    assert d["span.t.inner.self_s"] == pytest.approx(d["span.t.inner.s"], abs=1e-12)
    assert d["span.t.outer.self_s"] == pytest.approx(
        d["span.t.outer.s"] - d["span.t.inner.s"], abs=1e-12)
    assert 0 < d["span.t.outer.self_s"] < d["span.t.outer.s"]


def test_recorded_counts_reach_no_snapshot():
    """Inside ``recorded_counts`` the thread's counts go to the yielded
    dict, another thread's to the registry; ``add_counts`` adds them."""
    before = timer.snapshot()
    timer.count("t.rec.items")
    with timer.recorded_counts() as recorded:
        timer.count("t.rec.items", 2)
        timer.count("t.rec.other")
        other = threading.Thread(target=timer.count, args=("t.rec.items", 7))
        other.start()
        other.join(timeout=60)
        assert not other.is_alive()
        assert _since(before)["count.t.rec.items"] == 1 + 7
    assert recorded == {"t.rec.items": 2, "t.rec.other": 1}
    timer.count("t.rec.items")
    timer.add_counts(recorded)
    timer.add_counts(recorded)
    d = _since(before)
    assert d["count.t.rec.items"] == 1 + 7 + 1 + 2 * 2
    assert d["count.t.rec.other"] == 2


def test_two_threads_at_once():
    """Spans nest per thread, and no update is lost between threads (a
    short switch interval interleaves them)."""
    n, threads_n = 3000, 4
    before = timer.snapshot()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n):
                with timer.span("t.thread.outer"):
                    with timer.span("t.thread.inner", i):
                        timer.count("t.thread.items")
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    d = _since(before)
    assert d["span.t.thread.outer.n"] == d["span.t.thread.inner.n"] == n * threads_n
    assert d["count.t.thread.items"] == n * threads_n
    # no span became the child of another thread's
    assert d["span.t.thread.inner.self_s"] == pytest.approx(d["span.t.thread.inner.s"])
    assert d["span.t.thread.outer.self_s"] == pytest.approx(
        d["span.t.thread.outer.s"] - d["span.t.thread.inner.s"], rel=1e-9, abs=1e-9)


def test_snapshot_while_threads_open_spans():
    """A snapshot taken while other threads add spans and counts of new
    names neither raises nor loses what those threads had finished."""
    stop = threading.Event()
    done = {}

    def work(k):
        i = 0
        while not stop.is_set():
            with timer.span(f"t.snap.{k}.{i % 50}"):
                timer.count(f"t.snap.{k}.items")
            i += 1
        done[k] = i
    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        seen = [timer.snapshot() for _ in range(200)]
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    last = timer.snapshot()
    assert {k: last[f"count.t.snap.{k}.items"] for k in range(3)} == done
    assert {k: sum(last[f"span.t.snap.{k}.{j}.n"] for j in range(min(done[k], 50)))
            for k in range(3)} == done
    for k in range(3):
        items = [snap.get(f"count.t.snap.{k}.items", 0) for snap in seen]
        assert items == sorted(items)  # a thread's counts only grow


def test_profiler_event_only_while_a_profiler_runs(profiler_events):
    """No profiler: no event.  Under ``torch.profiler``: each span is a
    ``pls.`` event on the host, a function-scope record (a user annotation
    would be mirrored on the device)."""
    from torch.profiler import ProfilerActivity, profile
    with timer.span("t.quiet"):
        pass
    assert profiler_events == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("t.loud", 7):
            with timer.span("t.loud.inner"):
                torch.ones(8).sum()
    with timer.span("t.after"):
        pass
    assert profiler_events == ["pls.t.loud", "pls.t.loud.inner"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pls.t.")}
    assert sorted(events) == ["pls.t.loud", "pls.t.loud.inner"]
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events.values())
    outer, inner = events["pls.t.loud"], events["pls.t.loud.inner"]
    assert outer.start_ns() <= inner.start_ns() <= inner.end_ns() <= outer.end_ns()


def test_prep_threads_enter_no_profiler_event(profiler_events):
    """A profiler runs on the thread that started it: a span on another
    thread is timed but is no profiler event."""
    from torch.profiler import ProfilerActivity, profile
    before = timer.snapshot()

    def prep():
        with timer.span("t.prep"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=prep)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert _since(before)["span.t.prep.n"] == 1
    assert "pls.t.prep" not in profiler_events


# -- the program's spans against its own logs ------------------------------------

@pytest.fixture(scope="module")
def runs():
    """SLAM with loop closure at batch 1 and 4, each with the snapshot
    before ``init()`` and after frame 0."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for batch in (1, 4):
            cfg = tcompose(str(REPO / "config"), "slam",
                           SLAM_OVERRIDES + [f"slam.odometry.batch_size={batch}"])
            loader = TLoader(tdfd(TCfg, cfg["dataset"]))
            slam = SLAM(tdfd(SLAMConfig, cfg["slam"]), projector=loader.projector(),
                        device="cpu")
            start = timer.snapshot()
            slam.init()
            ds = loader.sequences()[0][0][0]
            after_first = None
            for i in range(len(ds)):
                frame = ds[i]
                slam.host_prepare(frame)
                slam.process_next_frame(frame)
                if i == 0:
                    after_first = timer.snapshot()
            slam.finish()
            out[batch] = (slam, timer.delta(start, timer.snapshot()),
                          timer.delta(after_first, timer.snapshot()))
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("batch", [1, 4])
def test_spans_equal_the_programs_logs(runs, batch):
    slam, d, _ = runs[batch]
    lc, odom = slam.loop_closure, slam.odometry
    frames = len(slam.elapsed_odometry)
    assert d["span.slam.frame.n"] == frames == 13
    assert d["count.odometry.frames_stepped"] == frames
    assert d["span.slam.odometry.s"] == pytest.approx(sum(slam.elapsed_odometry), abs=1e-9)
    assert d["span.slam.backend.s"] == pytest.approx(sum(slam.elapsed_backend), abs=1e-9)
    assert d["span.lc.warmup.s"] == pytest.approx(lc.warmup_seconds, abs=1e-12)
    assert d["span.odometry.register.n"] == d["span.odometry.map_update.n"] == frames - 1
    assert d["span.odometry.dequant.n"] == frames - 1
    # the loop closure's events and matches, as it logs them
    assert d["count.lc.events"] == d["span.lc.event.n"] == len(lc.saved_images) > 0
    assert d["span.lc.event.match.n"] == len(lc.match_stats) > 0
    assert d["count.backend.optimizations"] == d["span.backend.optimize.n"] >= 1
    assert len(slam.backend.registered_loop_constraints()) >= 1
    # every stage of the frame lies inside it, and the step inside the dispatch
    assert d["span.slam.frame.s"] >= d["span.slam.odometry.s"] + d["span.slam.backend.s"]
    inner = sum(d[f"span.odometry.{k}.s"] for k in ("dequant", "register", "map_update"))
    assert inner <= d["span.odometry.dispatch.s"]


def test_batched_spans_equal_pipe_stats(runs):
    """After frame 0, the three batches' uploads and dispatches are the
    flushes ``pipe_stats`` times; their frames' loop closure is timed from
    the drain on, so ``elapsed_loop_closure`` is the span."""
    slam, _, d = runs[4]
    st = slam.odometry.pipe_stats
    assert st["flushes"] == d["span.odometry.dispatch.n"] == 3
    assert d["count.odometry.frames_stepped"] == 12
    assert d["span.odometry.dispatch.s"] == pytest.approx(st["dispatch_s"], abs=1e-9)
    assert d["span.odometry.upload.s"] == pytest.approx(st["upload_wait_s"], abs=1e-9)
    assert d["span.odometry.buffer.n"] == 12
    assert d["span.slam.loop_closure.s"] == pytest.approx(
        sum(slam.elapsed_loop_closure[1:]), abs=1e-9)
    assert d["span.slam.drain.n"] >= 12 and d["span.odometry.pose_collect.n"] >= 12


def test_batch_one_pose_fetch(runs):
    """At batch 1 the loop closure's time runs from the odometry's end:
    the pose's fetch, then the loop closure's span."""
    slam, d, _ = runs[1]
    assert d["span.slam.pose_fetch.n"] == 13
    assert d["span.odometry.upload.n"] == 13 and d["span.odometry.dispatch.n"] == 13
    assert "span.odometry.buffer.n" not in d or d["span.odometry.buffer.n"] == 0
    spans = d["span.slam.loop_closure.s"] + d["span.slam.pose_fetch.s"]
    assert spans <= sum(slam.elapsed_loop_closure) <= spans + 13 * 1e-3


# -- the benchmark's side ----------------------------------------------------------

def _event(name, start_us, end_us, device="cpu", thread=1):
    class Event:
        def name(self):
            return name

        def start_thread_id(self):
            return thread

        def start_ns(self):
            return int(start_us * 1e3)

        def end_ns(self):
            return int(end_us * 1e3)

        def device_type(self):
            return (torch.autograd.DeviceType.CUDA if device == "cuda"
                    else torch.autograd.DeviceType.CPU)
    return Event()


def test_program_events_leave_the_reduction_as_it_was():
    """The program's ``pls.`` events are host-side records: the kernel
    count, the busy union and the gaps' labels stay what the harness's
    spans and the kernels alone give."""
    harness = [_event("slambench.window", 0, 1000), _event("slambench.prep", 0, 90),
               _event("slambench.odometry.dispatch", 100, 900),
               _event("slambench.odometry.dispatch", 100, 900, "cuda")]
    kernels = [_event("k1", 120, 200, "cuda"), _event("k2", 300, 350, "cuda"),
               _event("k1", 700, 760, "cuda")]
    program = [_event("pls.slam.frame", 100, 900), _event("pls.odometry.dispatch", 110, 880),
               _event("pls.odometry.register", 120, 600),
               _event("pls.odometry.encode", 10, 500)]
    alone = btrace.reduce_events(harness + kernels)
    with_program = btrace.reduce_events(harness + program + kernels)
    assert with_program == alone
    assert alone["kernels"] == 3 and alone["busy_s"] == pytest.approx(190e-6)
    assert alone["idle_gaps"][0] == ("odometry.dispatch", pytest.approx(350e-6))


def test_idle_split_by_program_span():
    """``slambench/program_split.py``: each gap goes to the innermost and the
    outermost program span open on the window's thread at its middle; a
    prep thread's span never takes one, and a device-side record of a
    program span is no kernel."""
    events = [_event("slambench.window", 0, 1000), _event("k", 100, 200, "cuda"),
              _event("k", 400, 500, "cuda"), _event("pls.slam.frame", 40, 900),
              _event("pls.odometry.register", 210, 390),
              _event("pls.odometry.register", 210, 390, "cuda"),
              _event("pls.odometry.encode", 0, 1000, thread=2)]
    got = program_split.idle_by_span(events)
    assert got["idle_s"] == pytest.approx(800e-6)
    assert got["idle_by_inner_span"] == pytest.approx(
        {"pls.slam.frame": 600e-6, "pls.odometry.register": 200e-6})
    assert got["idle_by_outer_span"] == pytest.approx({"pls.slam.frame": 800e-6})
    assert got["program_events"] == {"pls.slam.frame": 1, "pls.odometry.register": 1}


def test_stage_split_per_frame_and_per_event():
    """``program_split.stage_split``: the spans between two snapshots over
    the part's frames (a span first used in the part counts from 0), the
    loop closure and the backend per event, and the set-up's spans."""
    setup = {"span.slam.init.s": 4.0, "span.slam.init.self_s": 1.0, "span.slam.init.n": 1,
             "span.slam.frame.s": 6.0, "span.slam.frame.self_s": 0.5, "span.slam.frame.n": 301}
    base = dict(setup, **{"span.odometry.register.s": 9.0, "span.odometry.register.self_s": 9.0,
                          "span.odometry.register.n": 300, "count.lc.events": 3})
    end = dict(base, **{"span.slam.frame.s": 26.0, "span.slam.frame.self_s": 1.5,
                        "span.slam.frame.n": 501, "span.odometry.register.s": 15.0,
                        "span.odometry.register.self_s": 15.0, "span.odometry.register.n": 500,
                        "span.lc.event.s": 1.5, "span.lc.event.self_s": 0.1,
                        "span.lc.event.n": 4, "count.lc.events": 7,
                        "span.backend.optimize.s": 3.0, "span.backend.optimize.self_s": 3.0,
                        "span.backend.optimize.n": 2, "count.backend.optimizations": 2})
    got = program_split.stage_split(setup, base, end, 200)
    assert got["frames"] == 200
    want = {"slam.frame": (100.0, 5.0, 200), "odometry.register": (30.0, 30.0, 200),
            "lc.event": (7.5, 0.5, 4), "backend.optimize": (15.0, 15.0, 2)}
    assert {name: (st["ms_per_frame"], st["self_ms_per_frame"], st["n"])
            for name, st in got["stages"].items()} == {
        name: (pytest.approx(ms), pytest.approx(self_ms), n)
        for name, (ms, self_ms, n) in want.items()}
    assert got["per_event"] == pytest.approx(
        {"lc.event": 375.0, "lc.match_wait": 0.0, "backend.optimize": 1500.0})
    assert got["counts"] == {"lc.events": 4, "backend.optimizations": 2}
    assert got["setup_s"] == {"slam.init": 4.0, "slam.frame": 6.0}


def test_stage_split_without_work():
    """No frame in the part: no stage; no event: nothing per event."""
    snap = {"span.odometry.dispatch.s": 2.0, "span.odometry.dispatch.self_s": 1.0,
            "span.odometry.dispatch.n": 5, "count.odometry.frames_stepped": 60}
    got = program_split.stage_split({}, snap, dict(snap), 0)
    assert got["stages"] == {} and got["per_event"] == {} and got["setup_s"] == {}
    later = dict(snap, **{"span.odometry.dispatch.s": 3.0, "span.odometry.dispatch.n": 6,
                          "count.odometry.frames_stepped": 72})
    got = program_split.stage_split(snap, snap, later, 12)
    assert got["per_event"] == {} and got["counts"] == {"odometry.frames_stepped": 12}
    assert got["stages"]["odometry.dispatch"]["ms_per_frame"] == pytest.approx(1e3 / 12)
    assert got["setup_s"] == {"odometry.dispatch": 2.0}


@pytest.mark.gpu
def test_program_events_leave_no_device_mirror():
    """On the card: the same kernels under ``torch.profiler`` give the same
    device-side events with the program's spans around them as without,
    so the traced window's kernels and busy union are the kernels' alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    x = torch.ones(1 << 20, device="cuda")

    def device_events(spans: bool):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(4):
                with timer.span("t.gpu.outer", i) if spans else contextlib.nullcontext():
                    with timer.span("t.gpu.inner") if spans else contextlib.nullcontext():
                        x.mul_(1.0001)
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        host = [e.name() for e in events if e.name().startswith("pls.t.gpu.")]
        return host, sorted(e.name() for e in events if e.device_type() == cuda)

    device_events(False)  # the profiler's first window on this card
    host, with_spans = device_events(True)
    _, without = device_events(False)
    assert sorted(host) == ["pls.t.gpu.inner"] * 4 + ["pls.t.gpu.outer"] * 4
    assert with_spans == without and len(without) >= 4
    assert not [n for n in with_spans if n.startswith("pls.")]
