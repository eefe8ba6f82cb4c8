"""Times of kernel wrappers on a CUDA card, and a worker that times the
kernel wrappers of another checkout of this package.

``graph_ms`` gives a kernel's device time: N calls captured in one CUDA
graph, replayed under CUDA events, divided by N, so no host enqueue is in
it.  ``time_calls`` gives the wall time per call of back-to-back calls,
which for a small kernel is the host's enqueue.

Run as a script, it times kernels B1 and B2 of the checkout at ROOT:

    python3 -P pylidar_slam_tpu_torch/utils/device_timing.py ROOT INPUTS OUT

ROOT may hold any commit of the package whose
``ops/kernels/assoc_gn.py::assoc_gn`` and ``ops/kernels/nn_argmin.py::nn_argmin``
take the arguments they take here and launch on the current stream.  That
checkout's own wrappers build and bind its own kernel sources (into
``ROOT/build/``), so the C interface comes with the code.  INPUTS is a
``torch.save`` of {"b1": [target, model xyz, model normals, model valid],
"b1_params": [wr, wc, max_nd, scheme, sigma, plane_gate], "b2": [queries,
model, valid], "calls": {"assoc_gn": N, "nn_argmin": N}}.  OUT receives
(``torch.save``) B1's sums, B2's indices and squared distances, and each
kernel's device ms per call.  The script imports nothing of this package
before it puts ROOT first on ``sys.path`` (``-P`` keeps its own directory
off the path), so ROOT's package is the one it loads.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

GRAPH_REPLAYS = 3


def time_calls(fn, calls: int) -> float:
    """Mean ms per call over `calls` back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, calls: int, replays: int = GRAPH_REPLAYS) -> list:
    """Device ms per call: `calls` calls captured in one CUDA graph (the
    wrappers launch on the current stream, which the capture takes), then
    `replays` replays, each under CUDA events.  No host enqueue is in the
    time, only the kernels and the graph's gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    del graph
    return runs


def time_checkout(root: Path, inputs: Path, out: Path) -> dict:
    """Times B1 and B2 of the package at `root` on the saved `inputs`
    (graph replay), saves their results and times to `out` and returns the
    times."""
    root = root.resolve()
    sys.path.insert(0, str(root))
    from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
    from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
    for mod in (b1, b2):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    data = torch.load(inputs)
    dev = torch.device("cuda", 0)
    b1_args = [t.to(dev) for t in data["b1"]] + list(data["b1_params"])
    b2_args = [t.to(dev) for t in data["b2"]]
    b1.build()
    b2.build()
    sums = b1.assoc_gn(*b1_args)
    idx, sq = b2.nn_argmin(*b2_args)
    times = {"assoc_gn": graph_ms(lambda: b1.assoc_gn(*b1_args), data["calls"]["assoc_gn"]),
             "nn_argmin": graph_ms(lambda: b2.nn_argmin(*b2_args), data["calls"]["nn_argmin"])}
    torch.save({"sums": sums.cpu(), "idx": idx.cpu(), "sq": sq.cpu(), "device_ms": times}, out)
    return times


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    print(json.dumps(time_checkout(*(Path(a) for a in sys.argv[1:]))))
