"""The port's tracing hooks and step-rate timer
(mbb_emcee_tpu_torch/utils/profiling.py) on the CPU: StepTimer against the
JAX package's on the same phases, trace() as a no-op, around a fit, and
refusing a missing card, and --profile-dir in both MBB command lines."""

import glob
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.utils import profiling as jprofiling  # noqa: E402
from mbb_emcee_tpu_torch import MBBFitter  # noqa: E402
from mbb_emcee_tpu_torch import cli, cli_batch  # noqa: E402
from mbb_emcee_tpu_torch.utils import profiling  # noqa: E402
from mbb_emcee_tpu_torch.utils.profiling import StepTimer, trace  # noqa

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
CATALOG = ("wave = 100 160 250 350 500\n"
           "a 2.2 11.2 0.8 32.1 1.9 44.8 2.4 38.2 2.1 22.9 1.5\n"
           "b 1.9 9.0 0.8 27.0 1.9 40.1 2.4 35.0 2.1 20.4 1.5\n")


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


@pytest.mark.parametrize("phases", [
    [("burn", 100, 0.5), ("production", 1000, 2.0)],
    [("fit (burn + production)", 300, 1.25), ("extend +60", 60, 0.0)]])
def test_step_timer_matches_jax(phases, monkeypatch):
    """The same phases (on a scripted clock) give the same rate() of
    each phase and of all, and the same report() text."""
    clocks = []
    for mod in (profiling, jprofiling):
        ticks = iter(np.cumsum([0.0] + [v for p in phases
                                        for v in (0.0, p[2])]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(nwalkers=250)
        for name, nsteps, _ in phases:
            with timer.phase(name, nsteps):
                pass
        clocks.append(timer)
    mine, theirs = clocks
    assert mine.phases == theirs.phases
    for name in [None] + [p[0] for p in phases]:
        a, b = mine.rate(name), theirs.rate(name)
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert mine.report() == theirs.report()
    assert mine.report().splitlines()[0].startswith(f"  {phases[0][0]}: ")


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_does_nothing(log_dir, tmp_path,
                                                monkeypatch):
    # no device is resolved either: a missing card does not matter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with trace(log_dir):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert os.listdir(tmp_path) == []


def test_trace_of_a_cpu_fit_writes_one_chrome_trace(tmp_path):
    d = tmp_path / "prof" / "run1"
    fit = MBBFitter(nwalkers=16, seed=3, opthin=True, noalpha=True,
                    device="cpu")
    fit.set_data(WAVE, FLUX, 0.06 * FLUX)
    with trace(str(d), device="cpu"):
        fit.run(nburn=4, nsteps=8)
    files = _traces(d)
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    # the fit's own arithmetic is in it (the greybody's exp/log)
    assert {"aten::exp", "aten::log"} <= names
    assert fit.chain_free.shape == (8, 16, 3)


def test_trace_refuses_a_missing_card(tmp_path, monkeypatch):
    """No CPU fallback: with no CUDA device the default device (the card)
    raises, and nothing is traced or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(d)):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(d), device="cuda"):
            pass
    assert not d.exists()


def test_trace_lets_an_error_of_the_block_through(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path / "p"), device="cpu"):
            1 / 0


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    phot = tmp_path / "phot.txt"
    phot.write_text("".join(f"{w} {f} {0.06 * f:.3f}\n"
                            for w, f in zip(WAVE, FLUX)))
    d = tmp_path / "prof"
    rc = cli.main([str(phot), str(tmp_path / "o.h5"), "-w", "16", "-b",
                   "4", "-n", "8", "--opthin", "--noalpha", "--device",
                   "cpu", "--profile-dir", str(d), "-v"])
    assert rc == 0 and len(_traces(d)) == 1
    out = capsys.readouterr().out
    assert f"profiler trace written to {d}" in out
    assert "walker-steps/s" in out


def test_batch_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    cat = tmp_path / "cat.txt"
    cat.write_text(CATALOG)
    d = tmp_path / "prof"
    rc = cli_batch.main([str(cat), str(tmp_path / "o.h5"), "-w", "16",
                         "-b", "4", "-n", "8", "--device", "cpu",
                         "--profile-dir", str(d), "-v"])
    assert rc == 0 and len(_traces(d)) == 1
    out = capsys.readouterr().out
    assert f"profiler trace written to {d}" in out
    assert "walker-steps/s" in out


@pytest.mark.parametrize("which", ["cli", "cli_batch"])
def test_profile_dir_resolves_the_cli_device(which, tmp_path, monkeypatch):
    """--profile-dir without --device is the card's trace: with no card
    the CLI exits before anything is fitted or traced."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.txt"
    src.write_text(CATALOG if which == "cli_batch" else "".join(
        f"{w} {f} 1.0\n" for w, f in zip(WAVE, FLUX)))
    d = tmp_path / "prof"
    mod = cli_batch if which == "cli_batch" else cli
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([str(src), str(tmp_path / "o.h5"), "--profile-dir",
                  str(d)])
    assert not d.exists()
