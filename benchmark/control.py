#!/usr/bin/env python3
"""Run a cell with the control in the program's place (core/control.py),
on the card, once per seed, and print each run's checks: the control has
to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
        [--seconds 1]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from core import control, harness
    from core.cell import find_cell
    cell = find_cell(args.workload)
    program = control.Control(cell.config)
    refused = 0
    for seed in args.seeds:
        r, _ = harness.run(cell, seed, args.seconds, False, device="cuda",
                           t_start=T_START, program=program)
        refused += not r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    print(f"control refused on {refused} of {len(args.seeds)} seeds")
    return 0 if refused == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
