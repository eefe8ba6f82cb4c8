"""Runs cells of the benchmark several times, each run a process of its own,
one after another, and summarizes them: the tool for a cell's spread and
for its seeds.

    python3 slambench/repeat.py --workload agg-offline --seeds 11 12 13 \\
        --seconds 30 [--trace 0|1] [--out chiprun_out/agg-offline.jsonl]

Each run's result line (with its seed, trace flag, exit code and the run's
wall seconds) is appended to ``--out``; the summary gives, per metric, the
median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--control", action="store_true",
                   help="run control.py: the reference in the lower precision too")
    args = p.parse_args(argv)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        script = HERE / ("control.py" if args.control else "run.py")
        proc = subprocess.run([sys.executable, str(script), "--workload", args.workload,
                               "--seed", str(seed), "--seconds", str(args.seconds),
                               "--trace", str(args.trace)],
                              capture_output=True, text=True)
        wall = time.perf_counter() - t0
        out = proc.stdout.strip().splitlines()
        try:
            line = json.loads(out[-1]) if out else None
        except json.JSONDecodeError:
            line = None
        rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": proc.returncode, "wall_s": wall, "result": line,
               "stderr_tail": proc.stderr[-3000:]}
        lines.append(rec)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        brief = {k: v["value"] for k, v in (line or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (line or {}).get("checks", {}).items()}
        if line and "control" in line:
            checks["control"] = line["control"]
        print(f"[{args.workload} seed {seed} trace {args.trace}] rc {proc.returncode} "
              f"wall {wall:.1f}s correct {(line or {}).get('correct')} "
              f"metrics {brief} checks {checks}", flush=True)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-3000:], flush=True)
    names = sorted({k for r in lines if r["result"] for k in r["result"]["metrics"]})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in lines
                if r["result"] and name in r["result"]["metrics"]]
        print(f"summary {args.workload} {name}: n {len(vals)} median "
              f"{statistics.median(vals)!r} spread {spread(vals)!r} values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
