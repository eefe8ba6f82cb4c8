"""The benchmark of ``pylidar_slam_tpu_torch``: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``slambench/configs/<config>.json``, and a traffic mix,
``slambench/traffic/<traffic>.json``; a per-layer metric is read by
``slambench/metrics/<name>.py``; a configuration may name its odometry
reference, ``slambench/reference/<name>.py`` (``correct.reference_run``).
Nothing here names a cell, a configuration, a mix, a reference or a
metric: a cell is added with files and entries.

A run: the scans are raycast on the card from the seed; the program is
built and driven through the mix's set-up frames; the measured window hands
it scans for ``--seconds`` in a closed loop (the next scan when the program
takes it) or an open one (each scan at its due time); the window ends in
``torch.cuda.synchronize()`` after the program's ``finish()``.  Then the
plain reference (``slambench/reference``) recomputes the run from the
scans, and the last line of standard output is the result.

The per-layer readers get the program's counters and its own spans and
counts (``pylidar_slam_tpu_torch/utils/timer.py``) over the window, read at
its start, where the profiler stops and at its end (``layer_record``).
"""
from __future__ import annotations

import gc
import json
import math
import queue
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from slambench import correct as correct_mod
from slambench.trace import Tracer, breakdown
from slambench.traffic import generator

# The traced run profiles this much of the window (whole batches), and at
# least the mix's ``trace_frames`` frames: a profiler window of the whole
# run would hold millions of kernel records.
TRACE_SECONDS = 4.0
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pylidar_slam_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(root: Path, workload: str) -> dict:
    """The workload's entry, its configuration and traffic files, and the
    metrics ``BENCHMARK.json`` asks of it, and the configuration's odometry
    reference (``correct.reference_run``): one that is not there stops the
    run here, before any scan is made."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    reference = correct_mod.reference_run(config, root)
    traffic = load_traffic(root, cell["traffic"])

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {"cell": cell, "config": config, "traffic": traffic, "reference": reference,
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def load_traffic(root: Path, name: str, seen: tuple = ()) -> dict:
    """The traffic mix ``slambench/traffic/<name>.json``.  A mix that names
    a ``base`` mix is that mix with its own keys put over the base's, so
    mixes on one route and world share them from one file."""
    if name in seen:
        raise ValueError(f"traffic mix {name!r} names itself as a base")
    mix = json.loads((root / "slambench" / "traffic" / f"{name}.json").read_text())
    base = mix.pop("base", None)
    return mix if base is None else {**load_traffic(root, base, seen + (name,)), **mix}


def load_reader(root: Path, name: str):
    path = root / "slambench" / "metrics" / f"{name}.py"
    return correct_mod.load_module(path, f"slambench_metric_{name}").read


def projector_of(sensor: dict):
    from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
    return SphericalProjection(height=int(sensor["lidar_height"]),
                               width=int(sensor["lidar_width"]),
                               up_fov=float(sensor["up_fov"]),
                               down_fov=float(sensor["down_fov"]))


# ----------------------------------------------------------------------------
# The program's entry points, as a driver of the system calls them
# ----------------------------------------------------------------------------

class OdometryDriver:
    """``ICPFrameToModel``: scans in, relative poses out.  At batch 1 the
    previous frame's pose is the next one's prior (the constant-velocity
    model); batched, the program chains the priors itself."""

    step_span = "odometry.dispatch"

    def __init__(self, program: dict, sensor: dict, batch: int, device):
        from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
        program = dict(program, batch_size=batch)
        self.batch = batch
        self.odom = ICPFrameToModel(program, projector=projector_of(sensor), device=device)
        self.prior = np.eye(4, dtype=np.float32)

    def prepare(self, cloud: np.ndarray) -> dict:
        frame = {"numpy_pc": cloud}
        if self.batch > 1:
            frame["encoded_upload"] = self.odom.encode_upload(cloud)
        return frame

    def process(self, frame: dict) -> None:
        if self.batch == 1:
            frame["init_rpose"] = self.prior
        self.odom.process_next_frame(frame)
        if self.batch == 1:
            self.prior = frame["odometry_pose"]

    def finish(self) -> None:
        self.odom.finish()

    def counters(self) -> dict:
        """The odometry's own counters, and every span and count of the
        program's registry (``span.<name>.s``, ``.self_s``, ``.n``,
        ``count.<name>``)."""
        from pylidar_slam_tpu_torch.utils import timer
        return {**timer.snapshot(), "dispatch_s": self.odom.pipe_stats["dispatch_s"],
                "flushes": self.odom.pipe_stats["flushes"]}

    def outputs(self) -> dict:
        return {"params": self.odom.fetch_params_log()}


class SlamDriver(OdometryDriver):
    """``SLAM``: the same odometry, then the loop closure and the backend
    on each frame whose pose has reached the host."""

    step_span = "slam.step"

    def __init__(self, program: dict, sensor: dict, batch: int, device):
        from pylidar_slam_tpu_torch.slam.slam import SLAM
        program = json.loads(json.dumps(program))
        program["odometry"]["batch_size"] = batch
        self.batch = batch
        self.slam = SLAM(program, projector=projector_of(sensor), device=device)
        self.slam.init()
        self.odom = self.slam.odometry
        self.lc = self.slam.loop_closure

    def prepare(self, cloud: np.ndarray) -> dict:
        frame = {"numpy_pc": cloud}
        self.slam.host_prepare(frame)
        return frame

    def process(self, frame: dict) -> None:
        self.slam.process_next_frame(frame)

    def finish(self) -> None:
        self.slam.finish()

    def counters(self) -> dict:
        out = super().counters()
        out["lc_s"] = float(sum(self.slam.elapsed_loop_closure) + sum(self.slam.elapsed_backend))
        out["lc_frames"] = len(self.slam.elapsed_loop_closure)
        out["submaps"] = len(self.lc.saved_images)
        return out

    def outputs(self) -> dict:
        from slambench.reference.loop_closure import program_record
        out = super().outputs()
        out.update(program_record(self.slam))
        return out


DRIVERS = {"odometry": OdometryDriver, "slam": SlamDriver}


class Prep:
    """Host preparation of the scans (upload encode, the loop closure's
    grid sample) in `workers` threads, frame j on worker j mod workers,
    handed over in frame order."""

    def __init__(self, prepare, clouds, first: int, workers: int, depth: int):
        self.queues = [queue.Queue(maxsize=depth) for _ in range(workers)]
        self.stopped = threading.Event()
        self.first = self.next_frame = first
        self.threads = [threading.Thread(target=self._work, args=(j, prepare, clouds, first,
                                                                  workers), daemon=True)
                        for j in range(workers)]
        for t in self.threads:
            t.start()

    def _work(self, j, prepare, clouds, first, workers):
        i = first + j
        try:
            while not self.stopped.is_set():
                item = (i, prepare(clouds[i % len(clouds)]))
                while not self.stopped.is_set():
                    try:
                        self.queues[j].put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                i += workers
        except BaseException as exc:  # noqa: BLE001 - handed to the consumer
            self.queues[j].put((None, exc))

    def get(self) -> dict:
        q = self.queues[(self.next_frame - self.first) % len(self.queues)]
        i, item = q.get()
        if i is None:
            raise item
        self.next_frame += 1
        return item

    def stop(self):
        self.stopped.set()
        for t in self.threads:
            t.join(timeout=30)
            if t.is_alive():
                raise RuntimeError("a prep thread did not stop")


# ----------------------------------------------------------------------------
# The measured window
# ----------------------------------------------------------------------------

def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(driver, clouds, first: int, seconds: float, traffic: dict,
                tracer: Tracer, device) -> dict:
    """Hands over the next scan when the program has taken the last one."""
    batch = driver.batch
    prep = Prep(driver.prepare, clouds, first, int(traffic.get("prep_workers", 1)), batch)
    counters0 = driver.counters()
    trace_frames = int(traffic.get("trace_frames", 0))
    traced = None
    try:
        tracer.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while time.perf_counter() < deadline:
            with tracer.span("prep"):
                frame = prep.get()
            with tracer.span(driver.step_span):
                driver.process(frame)
            n += 1
            if tracer.active and n % batch == 0 and n >= trace_frames and \
                    time.perf_counter() - t0 >= TRACE_SECONDS:
                traced = stop_trace(tracer, driver, n)
        with tracer.span("finish"):
            driver.finish()
            sync(device)
        t1 = time.perf_counter()
        if tracer.active:
            traced = stop_trace(tracer, driver, n)
    finally:
        prep.stop()
    return {"t0": t0, "t1": t1, "frames": n, "attempted": n, "failed": 0,
            "counters0": counters0, "traced": traced, "tracer": tracer}


def stop_trace(tracer, driver, frames) -> dict:
    """Closes the profiler's window; the window goes on untraced.  What the
    traced part saw is reduced after the measured window."""
    tracer.stop()
    return {"frames": frames, "counters": driver.counters(), "t": time.perf_counter()}


def open_loop(driver, clouds, first: int, seconds: float, traffic: dict,
              tracer: Tracer, device) -> dict:
    """Scan i is due at the window's start + i / rate and handed over then,
    or at once when the program is late; its latency runs from its due time
    to its pose on the host.  Scans still unfinished at the window's end
    count as failed, at the window's end."""
    rate = float(traffic["rate_hz"])
    due_n = int(round(seconds * rate))
    latencies, step_s, late_s = [], [], []
    trace_frames = int(traffic.get("trace_frames", 0))
    counters0 = driver.counters()
    traced = None
    tracer.start()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    failed = 0
    for i in range(due_n):
        due = t0 + i / rate
        now = time.perf_counter()
        if now < due:
            with tracer.span("schedule_wait"):
                time.sleep(due - now)
        start = time.perf_counter()
        if start >= t_end:
            failed = due_n - i
            latencies += [t_end - (t0 + k / rate) for k in range(i, due_n)]
            break
        late_s.append(start - due)
        frame = {"numpy_pc": clouds[(first + i) % len(clouds)]}
        with tracer.span(driver.step_span):
            driver.process(frame)
        step_s.append(time.perf_counter() - start)
        with tracer.span("pose_fetch"):
            frame["odometry_pose"].cpu()
        done = time.perf_counter()
        if done > t_end:  # not finished by the window's end
            failed = due_n - i
            latencies += [t_end - (t0 + k / rate) for k in range(i, due_n)]
            break
        latencies.append(done - due)
        if tracer.active and i + 1 >= trace_frames and \
                time.perf_counter() - t0 >= TRACE_SECONDS:
            traced = stop_trace(tracer, driver, i + 1)
    n = len(step_s)
    with tracer.span("finish"):
        driver.finish()
        sync(device)
    t1 = time.perf_counter()
    if tracer.active:
        traced = stop_trace(tracer, driver, n)
    return {"t0": t0, "t1": t1, "frames": n, "attempted": due_n, "failed": failed,
            "latencies": latencies, "step_s": step_s, "late_s": late_s,
            "counters0": counters0, "traced": traced, "tracer": tracer}


LOOPS = {"closed": closed_loop, "open": open_loop}


def end_to_end(window: dict, setup_s: float) -> dict:
    """Every end-to-end metric the harness knows, from the host clock."""
    out = {"setup_s": setup_s}
    if "latencies" in window:
        lat = sorted(window["latencies"])
        if len(lat) >= 20:
            q = statistics.quantiles(lat, n=100, method="inclusive")
            out["pose_latency_p95_ms"] = 1e3 * q[94]
            out["pose_latency_p50_ms"] = 1e3 * statistics.median(lat)
    out["scans_per_s"] = window["frames"] / (window["t1"] - window["t0"])
    return out


def layer_record(cell: dict, window: dict, driver) -> dict:
    """What the per-layer readers read: the program's counters, spans and
    counts over the window (``driver.counters()``), and the reduction of its
    traced part.  In a traced run the counters and spans are taken over the
    part of the window after the profiler closed (the profiler slows the
    host), or over the whole window where the trace covered it.  A counter
    or span first used inside that part counts from 0."""
    from pylidar_slam_tpu_torch.utils import timer
    tr = window["traced"]
    c0, c1 = window["counters0"], driver.counters()
    frames, first, seconds = window["frames"], 0, window["t1"] - window["t0"]
    if tr is not None and tr["frames"] < window["frames"]:
        c0, first = tr["counters"], tr["frames"]
        frames, seconds = window["frames"] - first, window["t1"] - tr["t"]
    counters = timer.delta(c0, c1)
    if "step_s" in window:
        counters["step_call_s"] = float(sum(window["step_s"][first:]))
        counters["step_calls"] = len(window["step_s"][first:])
    trace = None
    if tr is not None:
        trace = window["tracer"].reduce()
        trace["frames"] = tr["frames"]
    if hasattr(driver, "lc"):
        from slambench.reference.loop_closure import events_between
        counters["lc_events"] = events_between(driver, c0["submaps"], c1["submaps"])
        if trace is not None:
            trace["lc_events"] = events_between(driver, window["counters0"]["submaps"],
                                                tr["counters"]["submaps"])
    return {"cell": cell["cell"]["name"], "config": cell["config"],
            "window": {"frames": frames, "seconds": seconds},
            "counters": counters, "trace": trace}


def finite(obj):
    """`obj` with every non-finite float (a number that could not be
    computed reads inf) written as +-1e300: JSON has no infinity."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return math.copysign(1e300, obj) if not math.isnan(obj) else 1e300
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN_MODULES))


def run(args, t_start: float, root: Path, allow_cpu: bool = False,
        control: bool = False) -> int:
    # one process, few threads: the program drives the card from one
    # Python thread (and the mix's prep threads); torch's CPU pool would
    # only spin beside it
    torch.set_num_threads(1)
    cell = load_cell(root, args.workload)
    config, traffic = cell["config"], cell["traffic"]
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        if not allow_cpu:
            log(f"slambench: the cell needs {chips} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
            return 2
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
    sensor = config["sensor"]
    scans = generator.make_scans(traffic, sensor, args.seed, device)
    clouds = scans.clouds
    batch = int(traffic["batch"])
    driver = DRIVERS[config["entry"]](config["program"], sensor, batch, device)

    # set-up: the mix's first frames, through the same entry
    setup = int(traffic["setup_frames"])
    for i in range(setup):
        frame = driver.prepare(clouds[i % len(clouds)])
        driver.process(frame)
    sync(device)
    tracer = Tracer(bool(args.trace), device)
    setup_s = time.perf_counter() - t_start
    window = LOOPS[traffic["loop"]](driver, clouds, setup, float(args.seconds), traffic,
                                    tracer, device)
    frames_total = setup + window["frames"]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = layer_record(cell, window, driver)
    outputs = driver.outputs()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = correct_mod.check(config, clouds, frames_total, outputs, device, args.seed,
                               cell["reference"])
    is_correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if args.trace:
        for m in cell["per_layer"]:
            value = load_reader(root, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(window, setup_s)
        for m in cell["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": is_correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev_info}
    if args.trace and record["trace"] is not None:
        dev_info["busy_s"] = record["trace"]["busy_s"]
        dev_info["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown(record["trace"])
    if control:
        result["control"] = correct_mod.numbers(config, clouds, frames_total, outputs, device,
                                                args.seed, control=True,
                                                reference=cell["reference"])
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"slambench: the run loaded {found}; the port must not load the JAX package")
        return 3
    log(f"slambench: {args.workload} seed {args.seed}: {frames_total} frames "
        f"({setup} set-up), window {window['t1'] - window['t0']:.3f} s")
    if window.get("late_s"):
        log(f"slambench: hand-over late by at most {1e3 * max(window['late_s']):.3f} ms")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite(result)), flush=True)
    return 0
