"""Time two checkouts of the port on one card, in turns.

Run from a checkout's root on a machine with one CUDA GPU, with another
checkout (for example the parent commit, unpacked with `git archive` into
a directory that .gitignore lists) at OTHER:

    python3 compare_in_turns.py OTHER [--phases 6,10,13]

It runs `python3 chip_smoke.py --phases P` from OTHER, from this checkout,
from this checkout again and from OTHER again (other, this, this, other),
each in its own process on the same card, and prints every line of those
runs but the compiler's report, tagged with the run, then the card's
nvidia-smi line. Each checkout builds its own kernels under its own build/.
Exits non-zero if any run fails.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--phases", default="6,10,13",
                    help="chip_smoke.py phases to run in each turn")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    failed = []
    for i, (tag, root) in enumerate(turns):
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", args.phases],
            cwd=root, capture_output=True, text=True, timeout=1800)
        for line in run.stdout.splitlines():
            if not line.startswith("[1]   "):
                print(f"turn {i} {tag}: {line}", flush=True)
        if run.returncode != 0:
            failed.append(f"turn {i} {tag}: exit {run.returncode}\n"
                          f"{run.stderr[-3000:]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
