"""The captured HMC transition of the port (hmc._TransitionGraph).

On a card every HMC transition -- its Philox draws, the leapfrog's
value-and-gradient calls with their autograd backward, the accept --
replays one captured CUDA graph, where the JAX package runs the whole
sampler as one jitted program. The graph draws from a step counter on the
device and the key's round words as data, so these tests hold, on the CPU:
the device-counter tagged_bits / hmc_draws against the int-counter ones
bit for bit, and the graph's body (_TransitionGraph.transition, run
eagerly) against the eager cores hmc_core / hmc_prod_core bit for bit, for
one fit and a lead axis of sources, whole and in production segments. The
tests marked `cuda` run the captured transitions on a card. This file
imports no jax, so it runs on a machine without it (`python -m pytest
--noconftest -m cuda tests/test_torch_hmc_graph.py`)."""

import warnings

import numpy as np
import pytest
import torch

from mbb_emcee_tpu_torch import hmc as th
from mbb_emcee_tpu_torch.likelihood import (
    LikelihoodSpec, Photometry, build_lnprob)
from mbb_emcee_tpu_torch.mapfit import _to_unconstrained
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
from mbb_emcee_tpu_torch.ops.philox import (
    HMC_TAG_A, PT_TAG, hmc_draws, round_keys, tagged_bits)
from mbb_emcee_tpu_torch.sampler import make_initial_ball

torch.set_num_threads(1)

KEY = 0x1234ABCD9876FEDC
WAVE = np.linspace(100.0, 500.0, 5)
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])


@pytest.mark.parametrize("source, lane0, step0", [
    (0, 0, 17),
    (3, 0, 5),
    ([0, 5, 7], 0, 11),
    (list(range(64, 68)), 0, 2),
    (0, 10, 3),
    (0, 0, (1 << 32) - 3),
    ([1, 2], 4, (3 << 32) - 2),
], ids=["single", "int-source", "sources", "source0", "lane0",
        "across-2^32", "sources-lane0-across-2^32"])
@pytest.mark.parametrize("tag", [HMC_TAG_A, PT_TAG], ids=["hmc", "pt"])
def test_device_counter_tagged_bits_match_the_int_counter(source, lane0,
                                                          step0, tag):
    """Step t of the device-counter tagged_bits (a 0-d int64 step, the
    round-key tensor, the source as a tensor) is row t of the int form's
    draw of all the steps, bit for bit, each of the four words."""
    nsteps, nlanes = 5, 7
    want = tagged_bits(KEY, tag, step0, nsteps, nlanes, "cpu", source,
                       lane0)
    keys = round_keys(KEY, "cpu")
    src = torch.as_tensor(source, dtype=torch.int64)
    step = torch.tensor(step0, dtype=torch.int64)
    for t in range(nsteps):
        got = tagged_bits(keys, tag, step, 1, nlanes, "cpu", src, lane0)
        for g, w in zip(got, want):
            assert torch.equal(g[0], w[t]), t
        step += 1


@pytest.mark.parametrize("source, step0, nfree", [
    (0, 0, 5),
    (2, 9, 3),
    ([0, 5, 7], 11, 2),
    ([3, 4], (1 << 32) - 2, 6),
], ids=["single", "int-source", "sources", "sources-across-2^32"])
def test_device_counter_hmc_draws_match_the_int_counter(source, step0,
                                                        nfree):
    """hmc_draws from the device counter, one transition at a time,
    against the int form's block of transitions: the momenta's normals,
    the step-size jitter and the accept uniforms bit for bit (the
    Box-Muller transform included)."""
    nsteps, nchains = 6, 9
    want = hmc_draws(KEY, step0, nsteps, nchains, nfree, "cpu", source)
    keys = round_keys(KEY, "cpu")
    src = torch.as_tensor(source, dtype=torch.int64)
    step = torch.tensor(step0, dtype=torch.int64)
    for t in range(nsteps):
        got = hmc_draws(keys, step, 1, nchains, nfree, "cpu", src)
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape[1:]
            assert torch.equal(g[0], w[t]), t
        step += 1


def test_device_counter_range_is_checked_on_load():
    """The device-counter form reads no counter back; the transition's
    load refuses a run that leaves the tagged streams' range, as the int
    form refuses the draw."""
    with pytest.raises(ValueError, match="2\\^52"):
        tagged_bits(KEY, HMC_TAG_A, (1 << 52) - 2, 3, 4, "cpu")
    lnprob, lo, width, u0 = _single_problem()
    _, hmc_step = th._make_stepper(lnprob, lo, width, 2)
    g = th._TransitionGraph(hmc_step, u0, torch.zeros((), dtype=torch.int64))
    state = (u0, u0, u0[:, 0], u0[:, 0], torch.tensor(0.1),
             torch.ones(u0.shape[-1]))
    with pytest.raises(ValueError, match="2\\^52"):
        g.load(state, KEY, (1 << 52) - 2, 3)


def _single_problem(device="cpu", nchains=16):
    """(lnprob, lower, width, u0 (nchains, 3)) of a 3-parameter MBB fit in
    the unconstrained space."""
    unc = 0.05 * FLUX
    rng = np.random.default_rng(7)
    phot = Photometry(WAVE, FLUX + unc * rng.standard_normal(5), unc)
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    spec.fixed[2], spec.fixed_values[2] = True, 250.0
    spec.fixed[3], spec.fixed_values[3] = True, 3.5
    lnprob, fs = build_lnprob(phot, MBBShape(opthin=True, noalpha=True),
                              spec, device=device)
    x0 = make_initial_ball(
        torch.Generator().manual_seed(1), [32.0, 1.9, 45.0],
        [2.0, 0.1, 2.0], nchains, fs.lower, fs.upper, device=device)
    lo = torch.as_tensor(fs.lower, dtype=torch.float32, device=device)
    width = torch.as_tensor(fs.upper, dtype=torch.float32,
                            device=device) - lo
    return lnprob, lo, width, _to_unconstrained(x0, lo, width)


def _multi_problem(nsrc=3, device="cpu", nchains=8):
    """(lnprob (S, n, 2) -> (S, n), lower, width, u0 (S, nchains, 2)): a
    correlated Gaussian per source, its mean the source's own, in a box."""
    mu = torch.as_tensor(np.random.default_rng(3).normal(0, 2, (nsrc, 2)),
                         dtype=torch.float32, device=device)

    def lnprob(x):
        d = x - mu[:, None, :]
        return -0.5 * (d[..., 0] ** 2 + (d[..., 1] - 0.6 * d[..., 0]) ** 2
                       / 0.5)

    lo = torch.full((2,), -10.0, device=device)
    width = torch.full((2,), 20.0, device=device)
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((nsrc, nchains, 2), generator=gen) + mu.cpu()[:, None]
    return lnprob, lo, width, _to_unconstrained(x0.to(device), lo, width)


def _problem(kind, device="cpu"):
    """(lnprob, lower, width, u0, source) of one fit or of 3 sources (the
    global indices of a shard, 40..42)."""
    if kind == "single":
        return _single_problem(device) + (0,)
    return _multi_problem(device=device) + (
        torch.arange(40, 43, device=device),)


def _equal_runs(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nwarmup, nsteps, thin, n_leapfrog", [
    (0, 6, 1, 3), (3, 4, 2, 2), (40, 6, 3, 2)],
    ids=["no-warmup", "eps-only", "both-phases"])
@pytest.mark.parametrize("kind", ["single", "sources"])
def test_captured_body_is_the_eager_hmc_core(kind, nwarmup, nsteps, thin,
                                             n_leapfrog):
    """hmc_core's warmup and production on the graph's body (one
    transition from the device counter at a time, run eagerly) against
    the eager core (draws a block at a time): chain, lnprob, accept
    counts, step size and mass bitwise."""
    lnprob, lo, width, u0, source = _problem(kind)
    want = th.hmc_core(lnprob, lo, width, u0, nwarmup, nsteps, thin,
                       n_leapfrog, 0.8, KEY, source)
    graphs = th._HMCGraphs(cpu_body=True)
    got = th._hmc_core(lnprob, lo, width, u0, nwarmup, nsteps, thin,
                       n_leapfrog, 0.8, KEY, source, graphs)
    _equal_runs(got, want)
    if kind == "sources" or nwarmup >= 4:       # the chains moved
        assert int(want[2].sum()) > 0
    assert len(graphs.graphs) == 1              # warmup + production share
    assert graphs.mode == "eager"               # no graph on the CPU


@pytest.mark.parametrize("kind", ["single", "sources"])
def test_captured_body_segments_are_the_whole_production(kind):
    """Production on the body in two segments of one call's transitions
    (the batch tier's checkpoint segments) against hmc_prod_core's one
    eager run: chain, lnprob, state, accept counts and stream position
    bitwise; the second segment reuses the first's transition."""
    lnprob, lo, width, u0, source = _problem(kind)
    graphs = th._HMCGraphs(cpu_body=True)
    u, g, lp, raw, eps, mass, step = th._warmup_core(
        lnprob, lo, width, u0, 8, 2, 0.8, KEY, 0, source, graphs)
    assert step == 8
    nacc = torch.zeros(u.shape[:-1], dtype=torch.int32)
    want = th.hmc_prod_core(lnprob, lo, width, u, g, lp, raw, nacc, eps,
                            mass, 8, 2, 2, KEY, step, source)
    one = th._prod_core(lnprob, lo, width, u, g, lp, raw, nacc, eps, mass,
                        4, 2, 2, KEY, step, source, graphs)
    two = th._prod_core(lnprob, lo, width, *one[2:7], eps, mass, 4, 2, 2,
                        KEY, one[7], source, graphs)
    assert len(graphs.graphs) == 1
    _equal_runs([torch.cat([one[0], two[0]], dim=-3),
                 torch.cat([one[1], two[1]], dim=-2)] + list(two[2:7]),
                want[:7])
    assert two[7] == want[7] == step + 8


def test_body_outputs_are_not_its_buffers():
    """A core's returned state is its own: a later call on the same
    transition does not move it (the buffers are the graph's)."""
    lnprob, lo, width, u0, source = _problem("single")
    graphs = th._HMCGraphs(cpu_body=True)
    u, g, lp, raw, eps, mass, step = th._warmup_core(
        lnprob, lo, width, u0, 4, 2, 0.8, KEY, 0, source, graphs)
    (tr,) = graphs.graphs.values()
    assert all(a is not b for a, b in zip((u, g, lp, raw),
                                          (tr.u, tr.g, tr.lp, tr.raw)))
    before = [t.clone() for t in (u, g, lp, raw)]
    th._prod_core(lnprob, lo, width, u, g, lp, raw,
                  torch.zeros(u.shape[:-1], dtype=torch.int32), eps, mass,
                  3, 1, 2, KEY, step, source, graphs)
    _equal_runs((u, g, lp, raw), before)


def test_cpu_fits_run_hmc_eagerly():
    """On the CPU the fitters' run_hmc runs the eager loop and records
    mode 'eager'."""
    from mbb_emcee_tpu_torch import MBBFitter, MultiFitter
    fit = MBBFitter(nwalkers=16, seed=3, device="cpu")
    fit.set_data(WAVE, FLUX, 0.05 * FLUX)
    fit.run_hmc(nwarmup=4, nsteps=4, n_leapfrog=2)
    assert fit._hmc_mode == "eager"
    mf = MultiFitter(nwalkers=16, seed=3, device="cpu")
    mf.set_data(WAVE, np.tile(FLUX, (2, 1)), 0.05 * np.tile(FLUX, (2, 1)))
    mf.run_hmc(nwarmup=4, nsteps=4, n_leapfrog=2)
    assert mf._hmc_mode == "eager"


# -- on the card -------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _eager_graphs(monkeypatch):
    """An _HMCGraphs whose transitions run eagerly on the card (the private
    switch hmc._CAPTURE off while it is made)."""
    with monkeypatch.context() as m:
        m.setattr(th, "_CAPTURE", False)
        return th._HMCGraphs()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "sources"])
def test_graphed_hmc_runs_are_the_eager_runs_on_the_card(kind, monkeypatch):
    """On a CUDA machine: hmc_core on the captured transition against the
    eager core from the same start, and production in two segments of one
    call's graph against one eager run, bitwise; mode 'graph'."""
    _needs_card()
    lnprob, lo, width, u0, source = _problem(kind, "cuda")
    graphs = th._HMCGraphs()
    got = th._hmc_core(lnprob, lo, width, u0, 40, 6, 2, 3, 0.8, KEY, source,
                       graphs)
    assert graphs.mode == "graph"
    eager = _eager_graphs(monkeypatch)
    want = th._hmc_core(lnprob, lo, width, u0, 40, 6, 2, 3, 0.8, KEY, source,
                        eager)
    assert eager.mode == "eager"
    _equal_runs(got, want)
    u, g, lp, raw, eps, mass, step = th._warmup_core(
        lnprob, lo, width, u0, 8, 2, 0.8, KEY, 0, source, graphs)
    nacc = torch.zeros(u.shape[:-1], dtype=torch.int32, device="cuda")
    whole = th._prod_core(lnprob, lo, width, u, g, lp, raw, nacc, eps, mass,
                          8, 2, 2, KEY, step, source,
                          _eager_graphs(monkeypatch))
    one = th._prod_core(lnprob, lo, width, u, g, lp, raw, nacc, eps, mass,
                        4, 2, 2, KEY, step, source, graphs)
    two = th._prod_core(lnprob, lo, width, *one[2:7], eps, mass, 4, 2, 2,
                        KEY, one[7], source, graphs)
    assert graphs.mode == "graph"
    _equal_runs([torch.cat([one[0], two[0]], dim=-3),
                 torch.cat([one[1], two[1]], dim=-2)] + list(two[2:7]),
                whole[:7])


@pytest.mark.cuda
def test_fitters_replay_the_captured_transition_on_the_card(monkeypatch):
    """On a CUDA machine: MBBFitter.run_hmc and MultiFitter.run_hmc (whole
    and in checkpoint segments) run in mode 'graph', bitwise the same
    calls with the capture switched off."""
    _needs_card()
    from mbb_emcee_tpu_torch import MBBFitter, MultiFitter

    def single():
        f = MBBFitter(nwalkers=32, seed=5, device="cuda")
        f.set_data(WAVE, FLUX, 0.05 * FLUX)
        return f.run_hmc(nwarmup=10, nsteps=6, n_leapfrog=3)

    def batch():
        f = MultiFitter(nwalkers=16, seed=5, device="cuda")
        f.set_data(WAVE, np.tile(FLUX, (3, 1)),
                   0.05 * np.tile(FLUX, (3, 1)))
        return f.run_hmc(nwarmup=10, nsteps=6, n_leapfrog=3)

    got = [single(), batch()]
    assert [f._hmc_mode for f in got] == ["graph", "graph"]
    monkeypatch.setattr(th, "_CAPTURE", False)
    want = [single(), batch()]
    assert [f._hmc_mode for f in want] == ["eager", "eager"]
    for a, b in zip(got, want):
        assert torch.equal(a.chain_free, b.chain_free)
        assert torch.equal(a.lnprobability, b.lnprobability)
        assert np.array_equal(a.acceptance_fraction, b.acceptance_fraction)
    assert got[0].hmc_result.step_size == want[0].hmc_result.step_size
    assert np.array_equal(got[1].hmc_mass, want[1].hmc_mass)


@pytest.mark.cuda
def test_uncapturable_model_warns_and_runs_hmc_eagerly_on_the_card(
        monkeypatch):
    """On a CUDA machine: a lnprob that copies host data to the card in
    every call cannot be captured; the HMC run warns once naming the model
    and runs the eager loop (mode 'eager'), the eager core's chain."""
    _needs_card()
    lnprob, lo, width, u0, source = _problem("single", "cuda")

    def host_copying(x):
        return lnprob(x) + torch.tensor([0.0], device=x.device)

    host_copying.label = "host-copy"
    graphs = th._HMCGraphs()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = th._hmc_core(host_copying, lo, width, u0, 4, 4, 1, 2, 0.8, KEY,
                           source, graphs)
    assert graphs.mode == "eager"
    assert sum("host-copy" in str(x.message) for x in w) == 1
    want = th._hmc_core(host_copying, lo, width, u0, 4, 4, 1, 2, 0.8, KEY,
                        source, _eager_graphs(monkeypatch))
    _equal_runs(got, want)
