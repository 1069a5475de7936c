#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from: the
compared numbers of sound runs over many seeds (the lower readings) and
of the cell's control (the upper readings), read in one process.

    python3 benchmark/readings.py --workload spn616.screen --seconds 2 \
        --seeds 11 12 13 [--control] [--out readings.jsonl]

Each seed is a whole run of the cell (inputs, set-up, a short window at
the cell's own load, the comparison) and prints one JSON line: the seed,
whether the control ran, the numbers compared with their current limits,
and the end-to-end metrics.  --control runs the traffic's
`control_settings`: the lower precision that a limit has to catch.  The
benchmark's own runs never run the control.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _, _, traffic, _ = harness.find_cell(harness.load_spec(), args.workload)
    override = traffic["control_settings"] if args.control else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                               t_start=t0, traffic_override=override)
        line = json.dumps(dict(seed=seed, control=args.control, correct=out["correct"],
                               checks=out["checks"], readings=out["readings"],
                               metrics=out["metrics"], device=out["device"],
                               attempted=out["attempted"],
                               run_s=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
