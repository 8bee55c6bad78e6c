"""The check that decides `correct`, driven through the rest of a run on
the CPU at a small size (the look for a card skipped, the plain samplers
in the kernels' place): sound runs pass under each cell's limits; the
control (the reference in bfloat16 in the program's place) and every fault
planted under the timed path that the cell can have fail. The `cuda`
cases run the benchmark itself on the card."""

import json
import subprocess
import sys

import pytest

from portbench import faults, harness
from portbench.bench import ROOT, Cell, load_benchmark
from portbench.workload import Workload

SEED = 2 ** 31 + 12345
CELLS = [w["name"] for w in load_benchmark()["workloads"]]
# The number that each fault and the control has to fail.
FAILS = {"bf16": "lnp_gap", "frozen": "frozen_share", "half": "frozen_share",
         "altered": "lnp_gap", "no_zfactor": "post_gap"}


def posterior_checked(name):
    return "posterior" in Cell(name).traffic["check"]


def small(name, deep):
    """The cell cut to a CPU test's size: 4 sources (a missing band in
    every 4th, two of them checked), short chains, or chains long enough
    to reach the posterior when `deep`; a smaller importance sample."""
    cell = Cell(name)
    cfg, tr = dict(cell.config), json.loads(json.dumps(cell.traffic))
    if cfg["fitter"] == "catalog":
        cfg.update(nsources=4, missing_every=4)
    if deep:
        tr.update(nburn=500, nsteps=2000, thin=4)
    else:
        tr.update(nburn=10, nsteps=20, thin=2)
    tr["check"]["sources"] = 2
    if "posterior" in tr["check"]:
        tr["check"]["posterior"] = {"rounds": 6, "round_samples": 1 << 15,
                                    "samples": 1 << 17}
    cell.config, cell.traffic = cfg, tr
    return cell


def reading(name, mode, cell=None):
    deep = mode in ("sound", "no_zfactor") and posterior_checked(name)
    cell = small(name, deep) if cell is None else cell
    work = Workload(cell.config, cell.traffic, device="cpu")
    undo = faults.apply(mode) if mode in faults.NAMES else None
    try:
        win = harness.measure(work, SEED, 0.0,
                              max_requests=1 if deep else 2)
    finally:
        if undo is not None:
            undo()
    return harness.judge(cell, work, win, SEED,
                         control="bf16" if mode == "bf16" else None,
                         require_kernels=False)


def modes(name):
    out = ["sound", "bf16", "frozen", "half", "altered"]
    if posterior_checked(name):
        out.append("no_zfactor")
    return out


def failing(checks):
    return {n for n, (v, lim) in checks.items()
            if n != "kept" and (lim is None or v > lim)}


@pytest.mark.parametrize("name,mode", [
    (c, m) for c in CELLS for m in modes(c)])
def test_check_passes_sound_runs_and_fails_the_rest(name, mode):
    checks = reading(name, mode)
    assert harness.is_correct(checks) == (mode == "sound"), checks
    if mode != "sound":
        assert FAILS[mode] in failing(checks), checks


def test_single_path_reports_the_derived_posteriors():
    """A single-fit cell whose mix names derived posteriors returns and
    passes them (the check reads a missing one as infinite)."""
    cell = small("single_converged", deep=False)
    derived = Cell("catalog_cli_derived")
    cell.traffic = dict(cell.traffic, derived=derived.traffic["derived"])
    cell.traffic["check"] = dict(cell.traffic["check"])
    cell.traffic["check"].pop("posterior", None)
    cell.limits = derived.limits
    checks = reading("single_converged", "sound", cell)
    assert harness.is_correct(checks), checks
    assert {"lir_gap", "dustmass_gap", "peaklambda_gap"} <= set(checks)


def test_a_missing_derived_quantity_fails():
    from portbench import check
    cell = small("catalog_cli_derived", deep=False)
    work = Workload(cell.config, cell.traffic, device="cpu")
    win = harness.measure(work, SEED, 0.0, max_requests=1)
    for _, items in win.kept:
        for it in items:
            it["derived"].pop("lir")
            it["derived_cen"].pop("lir")
    numbers = check.judge(win.kept, cell.config, cell.traffic, SEED)
    assert numbers["lir_gap"] == float("inf")


def test_the_launch_gate():
    from portbench.workload import left_kernels
    ok = dict(k1=2, k2=3, k3=0, plain=0, plain_multi=0, graphed=0,
              graphed_multi=0)
    assert left_kernels("single", ok) is None
    assert left_kernels("catalog", ok) == "no K3 launch"
    assert left_kernels("single", dict(ok, graphed=1))


def _run(cell, *extra):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    return out.returncode, out.stdout.strip().splitlines()


@pytest.mark.cuda
def test_on_the_card_sound_and_control(card):
    rc, lines = _run("single_converged")
    assert rc == 0 and json.loads(lines[-1])["correct"] is True
    rc, lines = _run("single_converged", "--control", "bf16")
    assert rc == 0 and json.loads(lines[-1])["correct"] is False


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, lines = _run("single_converged")
    assert rc == 2 and not any(ln.startswith("{") for ln in lines)
