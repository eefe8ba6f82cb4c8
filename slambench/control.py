"""A run of one cell, as ``run.py`` makes it, that also computes the
control: the plain reference in the precision below the configuration's
(bfloat16 for its float32 arithmetic, float32 for the backend's float64) in
the program's place.  Its numbers, under ``control`` in the result line,
are the upper readings the limits in ``checks`` are set below; the
benchmark's own runs never compute them.

    python3 slambench/control.py --workload <name> --seed <n> --seconds <s>
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402

from run import ROOT, parse  # noqa: E402


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness
    return harness.run(args, T_START, ROOT, control=True)


if __name__ == "__main__":
    sys.exit(main())
