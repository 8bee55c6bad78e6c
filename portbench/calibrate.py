"""Readings of the check's numbers on the card, in one process per cell:
the program's sound runs on many seeds, the control (the reference in
bfloat16 in the program's place) and each planted fault (faults.py) on a
few, each a short window of the cell's own requests at its own size. The
limits in limits/<cell>.json are set from these readings (PERF.md gives
them); the benchmark's own runs never call this.

    python3 portbench/calibrate.py --workload <cell> --seeds 101:12 \
        --modes sound,bf16,frozen,half,altered,no_zfactor [--out FILE]

prints one JSON line per (mode, seed): {mode, seed, requests, numbers}.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(spec):
    if ":" in spec:
        start, n = (int(v) for v in spec.split(":"))
        return list(range(start, start + n))
    return [int(v) for v in spec.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound")
    ap.add_argument("--fault-seeds", default=None,
                    help="seeds of the control and the faults (default: the "
                         "first three of --seeds)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import faults, harness
    from portbench.bench import Cell
    from portbench.workload import Spans, Workload
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    work = Workload(cell.config, cell.traffic, device="cuda")
    work.run(0, -1, Spans(False, False))
    k = cell.traffic["check"]["requests"][work.fitter]
    sound = seeds(args.seeds)
    other = seeds(args.fault_seeds) if args.fault_seeds else sound[:3]
    out = open(args.out, "a") if args.out else None
    try:
        for mode in args.modes.split(","):
            for seed in (sound if mode == "sound" else other):
                undo = (faults.apply(mode)
                        if mode in faults.NAMES else None)
                t0 = time.perf_counter()
                try:
                    win = harness.measure(work, seed, 1e9, max_requests=k)
                finally:
                    if undo is not None:
                        undo()
                t1 = time.perf_counter()
                checks = harness.judge(
                    cell, work, win, seed,
                    control="bf16" if mode == "bf16" else None,
                    device="cuda")
                rec = {"mode": mode, "seed": seed,
                       "requests": len(win.requests),
                       "window_s": round(t1 - t0, 3),
                       "check_s": round(time.perf_counter() - t1, 3),
                       "correct": harness.is_correct(checks),
                       "numbers": {n: v for n, (v, _) in checks.items()}}
                line = json.dumps(rec)
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
