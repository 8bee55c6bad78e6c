"""The captured stretch step of the port's plain samplers.

On a card EnsembleSampler and MultiEnsembleSampler replay one captured
CUDA graph of one ensemble step (sampler._StepGraph) instead of launching
every operation of the step from Python. The graph draws its Philox
uniforms from a step counter on the device and the key's round words as
data, so these tests hold, on the CPU: the device-counter draw against the
int-counter one bit for bit (sources, a shard's source0, a walker shard's
lane0, steps across 2^32), and the captured body (_StepGraph.step_once,
run eagerly) against the eager loop of stretch_run_plain and
multi_stretch_run_plain bit for bit. The tests marked `cuda` run the
graphed runs themselves on a card. This file imports no jax, so it runs on
a machine without it (`python -m pytest --noconftest -m cuda
tests/test_torch_graph_step.py`)."""

import warnings

import numpy as np
import pytest
import torch

from mbb_emcee_tpu_torch import sampler as tsampler
from mbb_emcee_tpu_torch.likelihood import (
    LikelihoodSpec, Photometry, build_lnprob)
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
from mbb_emcee_tpu_torch.ops.philox import round_keys, stretch_uniforms

torch.set_num_threads(1)

KEY = 0x1234ABCD9876FEDC
WAVE = np.linspace(100.0, 500.0, 5)
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])


def _single_problem(device="cpu"):
    """(lnprob, start (nwalkers, 3)) of a 3-parameter MBB fit."""
    unc = 0.05 * FLUX
    rng = np.random.default_rng(7)
    phot = Photometry(WAVE, FLUX + unc * rng.standard_normal(5), unc)
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    spec.fixed[2], spec.fixed_values[2] = True, 250.0
    spec.fixed[3], spec.fixed_values[3] = True, 3.5
    lnprob, fs = build_lnprob(phot, MBBShape(opthin=True, noalpha=True),
                              spec, device=device)
    p0 = tsampler.make_initial_ball(
        torch.Generator().manual_seed(1), [32.0, 1.9, 45.0],
        [2.0, 0.1, 2.0], 64, fs.lower, fs.upper, device=device)
    return lnprob, p0


def _multi_problem(nsrc=4, device="cpu"):
    """(lnprob (S, n, 2) -> (S, n), start (S, 32, 2)): a correlated
    Gaussian per source, its mean the source's own."""
    mu = torch.as_tensor(np.random.default_rng(3).normal(0, 2, (nsrc, 2)),
                         dtype=torch.float32, device=device)

    def lnprob(x):
        d = x - mu[:, None, :]
        return -0.5 * (d[..., 0] ** 2 + (d[..., 1] - 0.6 * d[..., 0]) ** 2
                       / 0.5)

    gen = torch.Generator().manual_seed(5)
    p0 = (torch.randn((nsrc, 32, 2), generator=gen) + mu.cpu()[:, None])
    return lnprob, p0.to(device)


@pytest.mark.parametrize("source, lane0, step0", [
    (0, 0, 17),
    (3, 0, 5),
    ([0, 5, 7], 0, 11),
    ("source0", 0, 2),
    (0, 10, 3),
    (0, 0, (1 << 32) - 3),
    ([1, 2], 4, (3 << 32) - 2),
], ids=["single", "int-source", "sources", "source0", "lane0",
        "across-2^32", "sources-lane0-across-2^32"])
def test_device_counter_draws_match_the_int_counter(source, lane0, step0):
    """Step t of the device-counter form (a 0-d int64 step, the round-key
    tensor, the source as a device tensor) is rows 6t..6t+5 of the int
    form's draw of all the steps, bit for bit."""
    half, nsteps = 7, 6
    if source == "source0":
        source = list(range(64, 68))      # a shard's global sources
    want = stretch_uniforms(KEY, step0, nsteps, half, "cpu", source=source,
                            lane0=lane0)
    keys = round_keys(KEY, "cpu")
    src = torch.as_tensor(source, dtype=torch.int64)
    step = torch.tensor(step0, dtype=torch.int64)
    for t in range(nsteps):
        got = stretch_uniforms(keys, step, 1, half, "cpu", source=src,
                               lane0=lane0)
        assert torch.equal(got, want[..., 6 * t:6 * t + 6, :]), t
        step += 1
    # the int step with the round-key tensor, and the int key with a
    # tensor step, are the same draw too
    assert torch.equal(stretch_uniforms(keys, step0, nsteps, half, "cpu",
                                        source=source, lane0=lane0), want)
    assert torch.equal(
        stretch_uniforms(KEY, torch.tensor(step0), nsteps, half, "cpu",
                         source=source, lane0=lane0), want)


def test_round_keys_are_the_key_schedule():
    """Row r of round_keys is the Philox key schedule's round r: (k0 +
    r W0, k1 + r W1) mod 2^32."""
    keys = round_keys(KEY, "cpu").numpy()
    k0, k1 = KEY & 0xFFFFFFFF, KEY >> 32
    for r in range(10):
        assert keys[r, 0] == (k0 + r * 0x9E3779B9) & 0xFFFFFFFF
        assert keys[r, 1] == (k1 + r * 0xBB67AE85) & 0xFFFFFFFF


def _body_records(lnprob, pos_a, pos_b, seed, step, nrec, thin, source):
    """The captured body run eagerly: a _StepGraph loaded with the start,
    `nrec` records of `thin` steps."""
    g = tsampler._StepGraph(lnprob, pos_a, 2.0, source)
    g.load(pos_a, pos_b, lnprob(pos_a), lnprob(pos_b), seed, step)
    return g.records(nrec, thin)


@pytest.mark.parametrize("nrec, thin", [(6, 1), (3, 2), (1, 9)],
                         ids=["thin1", "thin2", "advance"])
def test_captured_body_is_the_eager_single_run(nrec, thin):
    """The single-ensemble step the graph holds, step by step from the
    device counter, against stretch_run_plain's records of `thin` steps
    drawn at once: positions, lnprob, chain and accepts bitwise
    (advance's one record of thin = nsteps too)."""
    lnprob, p0 = _single_problem()
    samp = tsampler.EnsembleSampler(64, 3, lnprob)
    state = samp.init_state(p0, seed=KEY, step=(1 << 32) - 4)
    want_state, want_chain, want_lnp = tsampler.stretch_run_plain(
        state, lnprob, nrec, thin)
    got = _body_records(lnprob, state.pos_a, state.pos_b, KEY, state.step,
                        nrec, thin, torch.zeros((), dtype=torch.int64))
    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = got
    assert torch.equal(pos_a, want_state.pos_a)
    assert torch.equal(pos_b, want_state.pos_b)
    assert torch.equal(lnp_a, want_state.lnp_a)
    assert torch.equal(lnp_b, want_state.lnp_b)
    assert torch.equal(torch.cat([acc_a, acc_b]), want_state.naccept)
    assert torch.equal(chain, want_chain)
    assert torch.equal(lnpchain, want_lnp)
    assert int(want_state.naccept.sum()) > 0


@pytest.mark.parametrize("nrec, thin, source0", [(5, 1, 0), (3, 2, 64),
                                                 (1, 8, 7)],
                         ids=["thin1", "thin2-source0", "advance-source0"])
def test_captured_body_is_the_eager_multi_run(nrec, thin, source0):
    """The multi-source step the graph holds against
    multi_stretch_run_plain at the same source0, bitwise."""
    lnprob, p0 = _multi_problem()
    samp = tsampler.MultiEnsembleSampler(4, 32, 2, lnprob, source0=source0)
    state = samp.init_state(p0, seed=KEY, step=40)
    want_state, want_chain, want_lnp = tsampler.multi_stretch_run_plain(
        state, lnprob, nrec, thin, source0=source0)
    got = _body_records(lnprob, state.pos[:, :16], state.pos[:, 16:], KEY,
                        state.step, nrec, thin,
                        torch.arange(4, dtype=torch.int64) + source0)
    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = got
    assert torch.equal(torch.cat([pos_a, pos_b], 1), want_state.pos)
    assert torch.equal(torch.cat([lnp_a, lnp_b], 1), want_state.lnp)
    assert torch.equal(torch.cat([acc_a, acc_b], 1), want_state.naccept)
    assert torch.equal(chain, want_chain)
    assert torch.equal(lnpchain, want_lnp)


def test_cpu_runs_stay_eager():
    """On the CPU both samplers run the eager loop (the plain runs'
    counters move, the graphed runs' do not) and say so."""
    lnprob, p0 = _single_problem()
    samp = tsampler.EnsembleSampler(64, 3, lnprob)
    assert samp.graph_mode is None
    before = (tsampler.stretch_run_plain.runs,
              tsampler.stretch_run_graphed.runs)
    samp.run_mcmc(samp.init_state(p0, seed=3), 4, thin=2)
    assert samp.graph_mode == "eager"
    assert tsampler.stretch_run_plain.runs == before[0] + 1
    assert tsampler.stretch_run_graphed.runs == before[1]
    mlnp, mp0 = _multi_problem()
    msamp = tsampler.MultiEnsembleSampler(4, 32, 2, mlnp)
    msamp.advance(msamp.init_state(mp0, seed=3), 3)
    assert msamp.graph_mode == "eager"


def test_captures_hold_the_collector_off():
    """Every capture runs under sampler.gc_paused: Python's cyclic
    collector is off inside (a collection there could destroy a dead
    fitter's graph and so invalidate the capture) and back as it was
    after, also when the capture raises."""
    import gc
    assert gc.isenabled()
    with tsampler.gc_paused():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError):
        with tsampler.gc_paused():
            raise RuntimeError("a capture fault")
    assert gc.isenabled()
    gc.disable()
    try:
        with tsampler.gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()               # left as it was found
    finally:
        gc.enable()


def _mbb_wrapped_model(shape=None):
    """The 5-parameter MBB as a generic SEDModel ('mbb-wrapped')."""
    from mbb_emcee_tpu_torch import SEDModel
    from mbb_emcee_tpu_torch.models.modified_blackbody import log_mbb_fnu
    shape = MBBShape() if shape is None else shape

    def fnu(theta, wave):
        return torch.exp(log_mbb_fnu(theta, wave, shape))

    return SEDModel(fnu=fnu, param_names=("T", "beta", "lambda0", "alpha",
                                          "fnorm"),
                    lower=[5.0, 0.5, 20.0, 0.5, 1.0],
                    upper=[100.0, 5.0, 2000.0, 10.0, 200.0],
                    name="mbb-wrapped")


@pytest.mark.parametrize("tier", ["SEDFitter", "SEDMultiFitter",
                                  "HierarchicalFitter"])
def test_capture_warning_names_the_model(tier):
    """The label a capture warning names (sampler._label): each fitter
    labels the lnprob it builds with its model, and a lnprob without a
    label is named by its qualified name."""
    from mbb_emcee_tpu_torch import SEDFitter, SEDMultiFitter
    from mbb_emcee_tpu_torch.hierarchy import (
        HierarchicalFitter, TruncatedGaussianPopulation)
    if tier == "SEDFitter":
        fit = SEDFitter(_mbb_wrapped_model(), nwalkers=64, device="cpu")
        fit.set_data(WAVE, FLUX, 0.05 * FLUX)
        lnprob = fit.build()[2].lnprob_batch
        want = "'mbb-wrapped'"
    elif tier == "SEDMultiFitter":
        fit = SEDMultiFitter(_mbb_wrapped_model(), nwalkers=64,
                             device="cpu")
        fit.set_data(WAVE, np.tile(FLUX, (3, 1)), 0.05 * np.tile(FLUX, (3, 1)))
        lnprob = fit._build_sampler(fit._effective_spec()).lnprob_batch
        want = "'mbb-wrapped'"
    else:
        pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
        samples = np.random.default_rng(1).uniform(20.0, 40.0, (4, 16, 1))
        fit = HierarchicalFitter(samples, pop, nwalkers=32, device="cpu")
        samp = fit.build()[2]
        lnprob = samp.lnprob_batch
        want = "the hyper-lnprob of TruncatedGaussianPopulation"
        assert samp.capture                     # one device: captured
    assert tsampler._label(lnprob) == want
    lnprob0, _ = _single_problem()
    assert tsampler._label(lnprob0) == lnprob0.__qualname__


# -- on the card -------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_graphed_runs_are_the_eager_runs_on_the_card():
    """On a CUDA machine: EnsembleSampler.run_mcmc and advance, and
    MultiEnsembleSampler's, on the captured step against
    stretch_run_plain / multi_stretch_run_plain from the same state,
    bitwise; graph mode 'graph'."""
    _needs_card()
    lnprob, p0 = _single_problem("cuda")
    samp = tsampler.EnsembleSampler(64, 3, lnprob)
    state = samp.init_state(p0, seed=KEY, step=(1 << 32) - 5)
    got = samp.run_mcmc(samp.advance(state, 7), 12, thin=2)
    assert samp.graph_mode == "graph"
    mid = tsampler.stretch_run_plain(state, lnprob, 1, 7)[0]
    want = tsampler.stretch_run_plain(mid, lnprob, 6, 2)
    for g, w in zip((got[0].pos_a, got[0].lnp_b, got[0].naccept, got[1],
                     got[2]), (want[0].pos_a, want[0].lnp_b,
                               want[0].naccept, want[1], want[2])):
        assert torch.equal(g, w)
    mlnp, mp0 = _multi_problem(device="cuda")
    msamp = tsampler.MultiEnsembleSampler(4, 32, 2, mlnp, source0=9)
    mstate = msamp.init_state(mp0, seed=KEY, step=3)
    mgot = msamp.run_mcmc(mstate, 10, thin=5)
    assert msamp.graph_mode == "graph"
    mwant = tsampler.multi_stretch_run_plain(mstate, mlnp, 2, 5, source0=9)
    assert torch.equal(mgot[1], mwant[1])
    assert torch.equal(mgot[0].naccept, mwant[0].naccept)


@pytest.mark.cuda
def test_graphed_extend_is_the_longer_run_on_the_card():
    """On a CUDA machine: SEDFitter of the wrapped MBB, run(n1) +
    extend(n2) bitwise run(n1 + n2) on the captured step, graph mode
    'graph'."""
    _needs_card()
    from mbb_emcee_tpu_torch import SEDFitter
    model = _mbb_wrapped_model()

    def fit(nsteps):
        f = SEDFitter(model, nwalkers=64, seed=11, device="cuda")
        f.set_data(WAVE, FLUX, 0.05 * FLUX)
        f.set_param_init("T", 32.0, 2.0).set_param_init("fnorm", 45.0, 2.0)
        return f.run(nburn=10, nsteps=nsteps)

    whole, part = fit(30), fit(20)
    part.extend(10)
    assert part._sampler.graph_mode == "graph"
    assert torch.equal(whole.chain_free, part.chain_free)
    assert torch.equal(whole.lnprobability, part.lnprobability)


@pytest.mark.cuda
def test_kernel_lnprob_runs_eagerly_on_the_card():
    """On a CUDA machine: a lnprob on the lnprob kernel cannot stay in a
    captured step (a replay would launch the kernel uncounted): its
    capture is discarded with the warning, the run is the eager loop's
    chain, and a later run on the same sampler launches the kernel 2 times
    to start and 2 per step, all counted."""
    _needs_card()
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        mbb_lnprob, prepare_lnprob_inputs)
    unc = 0.05 * FLUX
    phot = Photometry(WAVE, FLUX, unc)
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = 100.0, 5.0
    ops = prepare_lnprob_inputs(phot, MBBShape(), spec, device="cuda")

    def k1(x):
        return mbb_lnprob(x.contiguous(), ops)

    p0 = tsampler.make_initial_ball(
        torch.Generator().manual_seed(2), [32.0, 1.9, 250.0, 3.5, 45.0],
        [2.0, 0.1, 20.0, 0.3, 2.0], 64, ops.free_space.lower,
        ops.free_space.upper, device="cuda")
    samp = tsampler.EnsembleSampler(64, 5, k1)
    state = samp.init_state(p0, seed=KEY)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = samp.run_mcmc(state, 6, thin=2)
    assert any("hand-written kernel" in str(x.message) for x in w)
    assert samp.graph_mode == "eager"
    want = tsampler.stretch_run_plain(state, k1, 3, 2)
    assert torch.equal(got[1], want[1])
    mbb_lnprob.launches = 0
    again = samp.run_mcmc(state, 6, thin=2)
    assert samp.graph_mode == "eager" and mbb_lnprob.launches == 2 + 2 * 6
    assert torch.equal(again[1], want[1])


@pytest.mark.cuda
def test_uncapturable_model_warns_and_runs_eagerly_on_the_card():
    """On a CUDA machine: a lnprob that copies host data to the card in
    every call cannot be captured; the run warns once naming the model and
    runs the eager loop (graph mode 'eager'), the same chain as
    stretch_run_plain."""
    _needs_card()
    lnprob, p0 = _single_problem("cuda")

    def host_copying(x):
        return lnprob(x) + torch.tensor([0.0], device=x.device)

    host_copying.label = "host-copy"
    samp = tsampler.EnsembleSampler(64, 3, host_copying)
    state = samp.init_state(p0, seed=KEY)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = samp.run_mcmc(state, 4)
    assert samp.graph_mode == "eager"
    assert any("host-copy" in str(x.message) for x in w)
    want = tsampler.stretch_run_plain(state, host_copying, 4, 1)
    assert torch.equal(got[1], want[1])
