"""The readings that a cell's comparison limits are set from.

    python -m gpbench.readings --workload <name> --seeds 1,2,... [--control-seeds 7,8,9] [--seconds 0.5]

In one process (the set-up's imports and libraries once), for each seed:
the cell's set-up from that seed, a short window at the cell's own load
(``--seconds``: by default one call, which gives as many answers to
compare as a run does) and the comparison; then the same with the cell's control in
the program's place on ``--control-seeds``; with ``--fault``, all of it
with that fault planted (``faults.py``).  Prints one JSON line a seed
with every compared number; the limits in ``limits/<cell>.json`` lie
between the largest reading of the program and the smallest of the
control.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from gpbench.faults import FAULTS
from gpbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=sorted(FAULTS), help="plant this fault first (a fault's readings)")
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            res = run_cell(args.workload, seed, args.seconds, False, device=args.device, control=control, process_start=t0)
            line = {"workload": args.workload, "seed": seed, "control": control, "fault": args.fault,
                    "correct": res["correct"],
                    "calls": res["attempted"], "seconds": time.perf_counter() - t0,
                    "numbers": {k: v["value"] for k, v in res["checks"].items()}}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
