"""The benchmark of mbb_emcee_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout and prints its
result as the last line of standard output (harness.py). Without a CUDA
card, or with fewer cards than the cell asks for, it exits with code 2 and
prints no result. --control bf16 puts the reference, computed in
bfloat16, in the program's place, to show that the check fails it
(check.py); the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    return ap.parse_args(argv)


def cache_dirs():
    """The program's build and kernel caches at fixed paths inside the
    checkout (the port builds its own library under build/ already)."""
    base = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def main(argv=None):
    args = parse(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
