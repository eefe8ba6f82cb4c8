"""Runs one cell of the benchmark of ``pylidar_slam_tpu_torch`` and prints
its result as the last line of standard output:

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a ``torch.profiler`` window.  See
``slambench/harness.py``.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here, before the imports

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness
    return harness.run(args, T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
