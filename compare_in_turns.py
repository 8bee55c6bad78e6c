"""Time two checkouts of the port on one card, in turns.

Run from a checkout's root on a machine with one CUDA GPU, with another
checkout (for example the parent commit, unpacked with `git archive` into
a directory that .gitignore lists) at OTHER:

    python3 compare_in_turns.py OTHER [--phases 6,10,13] [--no-probe]

It runs `python3 chip_smoke.py --phases P` from OTHER, from this checkout,
from this checkout again and from OTHER again (other, this, this, other),
each in its own process on the same card, and prints every line of those
runs but the compiler's report, tagged with the run, then the card's
nvidia-smi line. Each checkout builds its own kernels under its own build/.
After its phases each turn also runs the K1 probe on its checkout's
package (this checkout's chip_smoke.k1_probe, which calls only
mbb_lnprob(x, ops) and MBBFitter.__call__, so it runs on a checkout from
before K1 had a planner): the lnprob kernel's device time per launch at
250 to 1,048,576 vectors in each mode, and the host's time per call.
Exits non-zero if any run fails.

    python3 compare_in_turns.py --probe

runs the probe alone on the package of the current directory's checkout.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def probe():
    """The K1 probe of this checkout's chip_smoke.py on the package found
    in the current directory."""
    import torch
    if not torch.cuda.is_available():
        print("compare_in_turns: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    smoke.use_repo_tests_package()
    smoke.use_port_response_pack()
    smoke.k1_probe(smoke.nvidia_smi_line())
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--phases", default="6,10,13",
                    help="chip_smoke.py phases to run in each turn")
    ap.add_argument("--probe", action="store_true",
                    help="run the K1 probe on the current directory's "
                         "checkout and exit")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the K1 probe in each turn")
    args = ap.parse_args(argv)
    if args.probe:
        return probe()
    if args.other is None:
        ap.error("the other checkout's root is required")
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    failed = []
    commands = [[sys.executable, "chip_smoke.py", "--phases", args.phases]]
    if not args.no_probe:
        commands.append([sys.executable, os.path.abspath(__file__),
                         "--probe"])
    for i, (tag, root) in enumerate(turns):
        for cmd in commands:
            run = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=1800)
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
