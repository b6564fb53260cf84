"""Readings for the limits of a cell's checks, in one process on the chip.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control 1]

For each seed: one run of the cell's runner at the cell's own sizes and
load (a short window), its numbers compared (the program's: the lower
readings) and, with ``--control 1``, the same numbers of the control, the
reference computed one precision step below the configuration and put in
the program's place (the upper readings); with ``--fault``, the readings
of the program with a fault of ``faults.py`` planted.  One JSON line a
seed, with ``correct`` (and ``control_correct``) as ``harness.judge``
decides a run under the cell's limits.  The benchmark's own runs never run the control or a fault.
"""
import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import faults, harness  # noqa: E402


def _vq_bins(cfg: dict) -> int:
    return cfg["plm"]["vq_bins"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", default="", help="a fault of benchmark/faults.py to plant")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, cfg, traffic = harness.load_cell(bench, args.workload)
    limits = harness.load_limits(args.workload)
    runner = harness.load_runner(traffic["runner"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell, cfg, traffic, seed, args.seconds, False, limits=limits)
        out = {"workload": args.workload, "seed": seed}
        with contextlib.ExitStack() as stack:
            if args.fault:
                stack.enter_context(faults.planted(args.fault, _vq_bins(cfg)))
            rec = runner.run(ctx, control=bool(args.control))
        out["program"] = rec["readings"]
        out["correct"] = harness.judge(rec["checks"])  # as a run decides it, fault planted or not
        if args.control:
            out["control"] = rec["control_readings"]
            out["control_correct"] = harness.judge(rec["control_checks"])
        out["notes"] = rec["notes"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
