#!/usr/bin/env python3
"""Readings of the output check over many seeds in one process, for
setting a cell's limits (``reference/limits/<workload>.json``).

    python3 portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> [<n> ...]] [--fresh]

Sets the cell up once at the configuration's precision and runs one
window per seed, then once at float32 (the control) and one window per
control seed.  Prints one JSON line per window: the seed, the precision,
the compared numbers (``f_gap``, ``c_viol``, ``kkt``), the answers judged
and those the solver did not report stationary, and each call's
milliseconds with its iterations or trips.  ``--fresh`` leaves out the
traffic's fixed pool of starts, so that every call of a pooled mix
starts from a fresh point drawn from the seed: the check of points
outside the pool.  The benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    if args.fresh:
        cell.traffic = {k: v for k, v in cell.traffic.items()
                        if k not in ("pool", "pool_seed")}
    for dtype, seeds in (("float64", args.seeds),
                         ("float32", args.control_seeds)):
        if not seeds:
            continue
        session = harness.Session(cell, "cuda", dtype)
        for seed in seeds:
            r = session.run(seed, args.seconds, False, time.perf_counter(),
                            log=io.StringIO())
            print(json.dumps({
                "workload": args.workload, "dtype": dtype, "seed": seed,
                "fresh": args.fresh,
                "readings": {k: c["value"] for k, c in r["checks"].items()},
                "correct": r["correct"], "attempted": r["attempted"],
                "failed": r["failed"], "calls": r["window"]["calls"],
                "metrics": {k: m["value"] for k, m in r["metrics"].items()
                            if k != "setup_s"},
                "call_ms": [[round(1e3 * t, 3), c] for t, c in
                            session.calls]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
