"""One run of a cell split by the program's own spans, for a reader who
wants to know which stage of the program takes a cell's time:

    python3 slambench/program_split.py --workload <name> --seed <n> [--seconds 30] [--trace 0|1]

It runs the cell as ``slambench/run.py`` does and prints, after the run's
result line, one JSON line ``{"program_split": ...}`` with the spans and
counts of ``pylidar_slam_tpu_torch/utils/timer.py``:

* ``stages``: each span over the part of the window that the per-layer
  readers take (after the profiler closed in a traced run, else the whole
  window): ms a frame, self ms a frame, calls; ``per_event``: the loop
  closure's event and its match wait per event (``lc.events``) and the
  backend's optimization per optimization (``backend.optimizations``);
  ``setup_s``: each span's seconds before the window; ``harness``: the
  harness's other counters over that part (``dispatch_s``, ...).
* in a traced run, ``idle``: the traced window's idle seconds by the
  outermost and the innermost ``pls.`` span open on the pipeline thread at
  each gap's middle, over every gap (the result line's ``breakdown`` keeps
  the ten longest, labelled by the harness's spans).  Spans of other
  threads (the prep threads) never label a gap.

The spans and counts are the harness's record, which the per-layer
readers read (``span.<name>.s``, ...); this wraps the harness's
``layer_record`` and ``trace.reduce_events`` in this process to print them
split by stage.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM_PREFIX = "pls."
PER_EVENT = {"lc.event": "lc.events", "lc.match_wait": "lc.events",
             "backend.optimize": "backend.optimizations"}


def idle_by_span(events) -> dict:
    """The idle gaps of the window (as ``trace.reduce_events`` finds them)
    summed by the program span open on the window's thread at their middle."""
    import torch
    from slambench import trace
    cuda = torch.autograd.DeviceType.CUDA
    window = thread = None
    for e in events:
        if e.name() == trace.WINDOW_SPAN and e.device_type() != cuda:
            window, thread = (e.start_ns() * 1e-3, e.end_ns() * 1e-3), e.start_thread_id()
    w0, w1 = window
    kernels, spans = [], []
    for e in events:
        name, s, t = e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == cuda:
            if not name.startswith((trace.SPAN_PREFIX, PROGRAM_PREFIX)) and \
                    trace.FILLER_NAME not in name and t > w0 and s < w1:
                kernels.append((max(s, w0), min(t, w1)))
        elif name.startswith(PROGRAM_PREFIX) and e.start_thread_id() == thread \
                and t > w0 and s < w1:
            spans.append((s, t, name))
    _, gaps = trace._union(kernels)
    if kernels:
        gaps += [(w0, min(s for s, _ in kernels)), (max(t for _, t in kernels), w1)]
    else:
        gaps = [(w0, w1)]
    outer, inner = defaultdict(float), defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        open_ = sorted((sp for sp in spans if sp[0] <= mid <= sp[1]), key=lambda sp: sp[1] - sp[0])
        outer[open_[-1][2] if open_ else "none"] += (g1 - g0) * 1e-6
        inner[open_[0][2] if open_ else "none"] += (g1 - g0) * 1e-6
    events_by_name = defaultdict(int)
    for _, _, name in spans:
        events_by_name[name] += 1
    return {"window_s": (w1 - w0) * 1e-6, "idle_s": sum(outer.values()),
            "idle_by_outer_span": dict(outer), "idle_by_inner_span": dict(inner),
            "program_events": dict(events_by_name)}


def stage_split(setup: dict, base: dict, end: dict, frames: int) -> dict:
    """The spans between the snapshots `base` and `end` over `frames`
    frames, per event where a count says how many, and `setup`'s spans."""
    d = {k: v - base.get(k, 0) for k, v in end.items()}
    names = sorted(k[5:-2] for k in d if k.startswith("span.") and k.endswith(".n") and d[k])
    stages = {name: {"ms_per_frame": 1e3 * d[f"span.{name}.s"] / frames,
                     "self_ms_per_frame": 1e3 * d[f"span.{name}.self_s"] / frames,
                     "n": d[f"span.{name}.n"]} for name in names} if frames else {}
    per_event = {name: 1e3 * d.get(f"span.{name}.s", 0.0) / d[f"count.{per}"]
                 for name, per in PER_EVENT.items() if d.get(f"count.{per}")}
    return {"frames": frames, "stages": stages, "per_event": per_event,
            "counts": {k[6:]: v for k, v in d.items() if k.startswith("count.")},
            "setup_s": {k[5:-2]: v for k, v in setup.items()
                        if k.startswith("span.") and k.endswith(".s") and v}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--trace", type=int, default=1, choices=(0, 1))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness, trace
    found = {}
    layer_record, reduce_events = harness.layer_record, trace.reduce_events

    def record_and_split(cell, window, driver):
        record = layer_record(cell, window, driver)
        spans = {k: v for k, v in record["counters"].items() if k.startswith(("span.", "count."))}
        found.update(stage_split(window["counters0"], {}, spans, record["window"]["frames"]))
        found["harness"] = {k: v for k, v in record["counters"].items() if k not in spans}
        return record

    def reduce_and_split(events):
        events = list(events)
        found["idle"] = idle_by_span(events)
        return reduce_events(events)

    harness.layer_record, trace.reduce_events = record_and_split, reduce_and_split
    rc = harness.run(argparse.Namespace(workload=args.workload, seed=args.seed,
                                        seconds=args.seconds, trace=args.trace), T_START, ROOT)
    print(json.dumps({"program_split": found}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
