#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <window> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for: it exits nonzero and prints no result without them.  The last
line of standard output is the result's JSON object; the numbers that
decided `correct` are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
