"""The port's tracing hooks and step-rate timer
(mbb_emcee_tpu_torch/utils/profiling.py) on the CPU: StepTimer against the
JAX package's on the same phases, trace() as a no-op, around a fit, and
refusing a missing card, --profile-dir in both MBB command lines, and the
program's spans and d2h_bytes counter: off without a profiler, the span
tree of a fit, its results and derived posteriors under one, the bytes
each copy moves, and the same chains either way."""

import glob
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.utils import profiling as jprofiling  # noqa: E402
from mbb_emcee_tpu_torch import MBBFitter, MBBResults, MultiFitter  # noqa
from mbb_emcee_tpu_torch import derived  # noqa: E402
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


def _recording(fn):
    """fn() under torch's CPU profiler; returns (fn's value, the spans it
    recorded)."""
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.recorded()[n0:]


def _single(backend="auto"):
    fit = MBBFitter(nwalkers=16, seed=3, opthin=True, noalpha=True,
                    device="cpu", sampler_backend=backend)
    fit.set_data(WAVE, FLUX, 0.06 * FLUX)
    fit.run(nburn=4, nsteps=8, thin=2)
    res = MBBResults(fit, redshift=2.0)
    return fit, res, res.par_cen("T")


def _catalog():
    mf = MultiFitter(nwalkers=16, seed=5, opthin=True, noalpha=True,
                     device="cpu")
    mf.set_data(WAVE, np.stack([FLUX, 1.3 * FLUX, 0.8 * FLUX]),
                0.06 * np.stack([FLUX] * 3), redshifts=[0.5, 1.5, 2.5])
    mf.run(nburn=4, nsteps=8)
    return mf, mf.par_cen("T"), mf.compute_lir(), mf.lir_cen()


@pytest.mark.parametrize("what", ["calls", "fit"])
def test_spans_without_a_profiler_are_the_shared_noop(what):
    n0 = len(profiling.recorded())
    assert profiling.span("mbb.a") is profiling.span("mbb.b", x=1)
    if what == "calls":
        with profiling.span("mbb.a", x=1) as got:
            profiling.count("d2h_bytes", 8)
            profiling.note(group=4)
        assert got is None
    else:
        _single()
        _catalog()
    assert len(profiling.recorded()) == n0


def test_note_adds_to_the_innermost_open_span():
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("mbb.outer", x=1):
            with profiling.span("mbb.inner", x=2):
                profiling.note(group=4, cluster=1)
            profiling.note(x=3)
        profiling.note(y=5)         # no span open: nothing to add to
    outer, inner = profiling.recorded()[n0:]
    assert outer.attrs == {"x": 3}
    assert inner.attrs == {"x": 2, "group": 4, "cluster": 1}


# (name, parent's position, attributes) of a CPU fit, its results and par_cen;
# the fused backend adds the kernel wrappers' spans (their plain versions),
# each with its bands and nodes a band (point bands: 1): the burn records
# every step, the re-burn none but its last
POINT = {"bands": 5, "nodes": 1}
TREE = {
    "auto": [
        ("mbb.fit.set_data", None, {}),
        ("mbb.fit.run", None, {"nburn": 4, "nsteps": 8, "thin": 2,
                               "nsources": 1}),
        ("mbb.fit.ball", 1, {}), ("mbb.fit.burn", 1, {}),
        ("mbb.fit.recentre", 1, {}), ("mbb.fit.reburn", 1, {}),
        ("mbb.fit.reset", 1, {}), ("mbb.fit.production", 1, {}),
        ("mbb.fit.record", 1, {}), ("mbb.results.load", None, {}),
        ("mbb.results.percentiles", None, {"param": "T"})],
    "fused": [
        ("mbb.fit.set_data", None, {}),
        ("mbb.fit.run", None, {"nburn": 4, "nsteps": 8, "thin": 2,
                               "nsources": 1}),
        ("mbb.fit.ball", 1, {}), ("mbb.kernel.k1", 2, POINT),
        ("mbb.fit.burn", 1, {}),
        ("mbb.kernel.k2", 4, {"steps": 4, "records": 4, "sources": 1,
                              **POINT}),
        ("mbb.fit.recentre", 1, {}), ("mbb.kernel.k1", 6, POINT),
        ("mbb.fit.reburn", 1, {}),
        ("mbb.kernel.k2", 8, {"steps": 4, "records": 1, "sources": 1,
                              **POINT}),
        ("mbb.fit.reset", 1, {}), ("mbb.fit.production", 1, {}),
        ("mbb.kernel.k2", 11, {"steps": 8, "records": 4, "sources": 1,
                               **POINT}),
        ("mbb.fit.record", 1, {}), ("mbb.results.load", None, {}),
        ("mbb.results.percentiles", None, {"param": "T"})]}


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_a_cpu_fit_records_the_span_tree(backend):
    _, spans = _recording(lambda: _single(backend))
    assert [(s.name, s.parent, s.attrs) for s in spans] == [
        (n, None if p is None else spans[0].root + p, a)
        for n, p, a in TREE[backend]]
    base = spans[0].root
    for i, s in enumerate(spans):
        # roots: set_data, run, results.load, percentiles; the rest under run
        want = base + i if s.parent is None else spans[1].root
        assert s.root == want
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent - base]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("nodes", [None, 2_000_000])
def test_multifitter_lir_records_one_chunk_span_per_chunk(nodes,
                                                          monkeypatch):
    """compute_lir's chunk loop, at its own width (one chunk here) and
    with chunks of a few samples (the chunk width counts LIR_NODES as the
    fan-out of each sample): the same chain either way."""
    mf, _, lir, _ = _catalog()
    if nodes is not None:
        monkeypatch.setattr(derived, "LIR_NODES", nodes)
    got, spans = _recording(lambda: mf.compute_lir())
    np.testing.assert_array_equal(got, lir)
    S, N = mf.nsources, lir.shape[1]
    chunk = max(1, (64 << 20) // (S * derived.LIR_NODES))
    want = -(-N // chunk)
    assert (want > 5) == (nodes is not None)
    chunks = [s for s in spans if s.name == "mbb.derived.chunk"]
    assert [s.attrs["index"] for s in chunks] == list(range(want))
    assert sum(s.attrs["samples"] for s in chunks) == N
    assert spans[0].name == "mbb.derived.lir" and spans[0].parent is None
    assert all(s.parent == spans[0].root for s in chunks)
    assert [s.name for s in spans if s.name != "mbb.derived.chunk"] == [
        "mbb.derived.lir", "mbb.derived.distance"]


SITES = {"load": "mbb.results.load", "recentre": "mbb.fit.recentre",
         "record": "mbb.fit.record",
         "percentiles": "mbb.results.percentiles",
         "chunk": "mbb.derived.chunk"}


@pytest.mark.parametrize("site", SITES)
def test_d2h_bytes_are_the_nbytes_copied(site):
    """Each copy counts what crosses: fp64 chains, lnprob, best walkers
    and acceptance fractions, par_cen's (S, 2) pairs at three
    percentiles, each derived chunk."""
    if site in ("load", "recentre", "record"):
        (fit, _, _), spans = _recording(_single)
        want = {"load": 8 * (fit.chain_free.numel()
                             + fit.lnprobability.numel()),
                "recentre": 8 * fit.free_space.nfree,
                "record": fit.acceptance_fraction.nbytes}[site]
    else:
        (mf, _, lir, _), spans = _recording(_catalog)
        want = {"percentiles": 3 * 2 * 8 * mf.nsources,
                "chunk": lir.nbytes}[site]
    assert want > 0
    assert sum(s.counters.get("d2h_bytes", 0) for s in spans
               if s.name == SITES[site]) == want


@pytest.mark.parametrize("which", ["single", "catalog"])
def test_recording_leaves_chains_and_summaries_bitwise(which):
    run = _single if which == "single" else _catalog
    off = run()
    on, spans = _recording(run)
    assert spans
    if which == "single":
        (f0, r0, c0), (f1, r1, c1) = off, on
        pairs = [(f0.chain_free, f1.chain_free),
                 (f0.lnprobability, f1.lnprobability)]
        arrays = [(r0.chain, r1.chain), (c0, c1)]
    else:
        (m0, *a0), (m1, *a1) = off, on
        pairs = [(m0.chain_free, m1.chain_free),
                 (m0.lnprobability, m1.lnprobability)]
        arrays = list(zip(a0, a1))
    for a, b in pairs:
        assert torch.equal(a, b)
    for a, b in arrays:
        np.testing.assert_array_equal(a, b)


def test_trace_holds_the_program_spans(tmp_path):
    """trace() clears the recorder when it opens; its Chrome trace holds
    every span as a user annotation."""
    with profiling.trace(str(tmp_path), device="cpu"):
        fit, res, _ = _single()
    spans = profiling.recorded()
    assert spans[0].name == "mbb.fit.set_data" and spans[0].root == 0
    with open(_traces(tmp_path)[0]) as fh:
        events = json.load(fh)["traceEvents"]
    marks = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(marks) == sorted(s.name for s in spans)
    assert {"mbb.fit.run", "mbb.fit.burn", "mbb.fit.recentre",
            "mbb.fit.production", "mbb.results.load"} <= set(marks)
