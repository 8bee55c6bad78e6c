"""The derived posteriors' kernel (ops/derived_kernel.py, csrc/derived.cu).

On the CPU: MBBResults' and MultiFitter's compute_lir, compute_dustmass and
compute_peaklambda take the kernel's plain twin there (no launch, the same
span tree as before the kernel, the host copy counted), the twin runs
derived.py's public formulas on the operands' own fp32 inputs, which are
the inputs the plain path computed with, the wrapper refuses what the
kernel does not take, and derived._percentile_summary summarises one
chain or a batch alike. On a CUDA device (`-m cuda`): the kernel against
its plain twin on the card, for the three quantities, the four model
shapes and sizes across the old plain path's 65,536-row chunk, and end to
end through MBBResults and a 7-source MultiFitter. This file imports no
jax:

    python -m pytest --noconftest -q -s -m cuda tests/test_torch_derived_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from mbb_emcee_tpu_torch import MBBFitter, MBBResults, MultiFitter
from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.models.modified_blackbody import LOG_C2, MBBShape
from mbb_emcee_tpu_torch.ops import derived_kernel as dk
from mbb_emcee_tpu_torch.utils import profiling

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
QUANTITIES = ("lir", "dustmass", "peaklambda")
SHAPES = [MBBShape(opthin=t, noalpha=n, wavenorm=350.0)
          for t in (False, True) for n in (False, True)]
# Non-default arguments of each compute_* call.
KW = {"lir": dict(wavemin=5.0, wavemax=1500.0),
      "dustmass": dict(kappa=1.9, kappa_wave=250.0),
      "peaklambda": dict(lo=5.0, hi=3000.0)}
# The kernel against its plain twin, relative: L_IR's sum runs in another
# order; the peak is the root of a flat fp32 maximum.
RTOL = {"lir": 1e-5, "dustmass": 1e-5, "peaklambda": 1e-3}


def _recording(fn):
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.recorded()[n0:]


def _single(device="cpu", nwalkers=16, nsteps=8, shape=MBBShape()):
    fit = MBBFitter(nwalkers=nwalkers, seed=3, opthin=shape.opthin,
                    noalpha=shape.noalpha, wavenorm=shape.wavenorm,
                    device=device)
    fit.set_data(WAVE, FLUX, 0.06 * FLUX)
    fit.run(nburn=4, nsteps=nsteps)
    return MBBResults(fit, redshift=2.0)


def _catalog(device="cpu", nsources=3, nwalkers=16, nsteps=8,
             shape=MBBShape()):
    mf = MultiFitter(nwalkers=nwalkers, seed=5, opthin=shape.opthin,
                     noalpha=shape.noalpha, wavenorm=shape.wavenorm,
                     device=device)
    scale = np.linspace(0.7, 1.4, nsources)[:, None]
    mf.set_data(WAVE, scale * FLUX, 0.06 * scale * FLUX,
                redshifts=np.linspace(0.5, 3.5, nsources))
    mf.run(nburn=4, nsteps=nsteps)
    return mf


# -- CPU ---------------------------------------------------------------------

# The span tree (name, parent's position, attributes) of each call on the
# CPU, as before the kernel: its root, one chunk, then the distances.
def _tree(fitter, q, n):
    tree = [(f"mbb.derived.{q}", None, {}),
            ("mbb.derived.chunk", 0, {"index": 0, "samples": n})]
    if q != "peaklambda":
        tree.append(("mbb.derived.distance", 0,
                     {} if fitter == "single" else {"redshifts": 3}))
    return tree


@pytest.fixture(scope="module")
def cpu_fits():
    return {"single": _single(), "catalog": _catalog()}


@pytest.mark.parametrize("q", QUANTITIES)
@pytest.mark.parametrize("fitter", ["single", "catalog"])
def test_cpu_samples_take_the_plain_path(cpu_fits, fitter, q):
    """No launch, the span tree of the plain path, and the host copy
    counted as `d2h_bytes` in the chunk."""
    obj = cpu_fits[fitter]
    n0 = dk.mbb_derived.launches
    got, spans = _recording(lambda: getattr(obj, f"compute_{q}")())
    assert dk.mbb_derived.launches == n0
    n = got.size if fitter == "single" else got.shape[1]
    base = spans[0].root
    assert [(s.name, None if s.parent is None else s.parent - base, s.attrs)
            for s in spans] == _tree(fitter, q, n)
    assert spans[1].counters == {"d2h_bytes": 8 * got.size}
    assert np.all(np.isfinite(got))


def _capture(monkeypatch):
    """Record the fp32 inputs derived.py's formulas receive."""
    seen = {}
    lir_integrand, dustmass_integrand = (derived.lir_integrand,
                                         derived.dustmass_integrand)
    golden, finder = derived.golden_max, derived.peak_finder

    def lir(shape):
        one = lir_integrand(shape)

        def wrapped(th, lam, w):
            seen["lam32"], seen["w32"] = lam, w
            return one(th, lam, w)
        seen["shape"] = shape
        return wrapped

    def dust(shape):
        one = dustmass_integrand(shape)

        def wrapped(th, lam_obs):
            seen["lam32"] = lam_obs
            return one(th, lam_obs)
        seen["shape"] = shape
        return wrapped

    def record_golden(f, lo, hi, iters):
        seen["lo"], seen["hi"], seen["iters"] = lo, hi, iters
        return golden(f, lo, hi, iters=iters)

    def record_finder(shape, *a):
        seen["shape"] = shape
        return finder(shape, *a)
    monkeypatch.setattr(derived, "lir_integrand", lir)
    monkeypatch.setattr(derived, "dustmass_integrand", dust)
    monkeypatch.setattr(derived, "golden_max", record_golden)
    monkeypatch.setattr(derived, "peak_finder", record_finder)
    return seen


@pytest.mark.parametrize("q", QUANTITIES)
@pytest.mark.parametrize("fitter", ["single", "catalog"])
def test_operands_are_the_plain_paths_inputs(fitter, q, monkeypatch):
    """The kernel's operands, and what derived.py's formulas receive on
    the CPU, are the plain path's inputs: the per-source nodes and weights
    of lir_nodes_weights and kappa_wave (1 + z) cast to fp32, fp32 ln lo
    and ln hi and the golden-section iterations, the shape, and the
    normalization's fp32 (LOG_C2 - ln wavenorm)."""
    shape = MBBShape(opthin=True, noalpha=False, wavenorm=350.0)
    obj = (_single(shape=shape) if fitter == "single"
           else _catalog(shape=shape))
    seen = _capture(monkeypatch)
    getattr(obj, f"compute_{q}")(**{k: v for k, v in KW[q].items()
                                    if k != "kappa"})
    monkeypatch.undo()
    opz = (1.0 + obj.redshift if fitter == "single"
           else 1.0 + np.asarray(obj.redshifts))
    nsrc = 1 if fitter == "single" else obj.nsources
    if q == "lir":
        ops = dk.lir_operands(shape, opz, **KW[q])
        lam, w = derived.lir_nodes_weights(np.reshape(opz, (-1, 1)),
                                           **KW[q])
        for got, want in ((ops.nodes, lam), (ops.weights, w),
                          (seen["lam32"].numpy(), lam),
                          (seen["w32"].numpy(), w)):
            np.testing.assert_array_equal(got, want.astype(np.float32))
        assert ops.nodes.dtype == ops.weights.dtype == np.float32
        assert ops.nodes.shape == (nsrc, derived.LIR_NODES)
    elif q == "dustmass":
        ops = dk.dustmass_operands(shape, opz, KW[q]["kappa_wave"])
        want = np.float32(KW[q]["kappa_wave"] * np.reshape(opz, (-1, 1)))
        np.testing.assert_array_equal(ops.nodes, want)
        np.testing.assert_array_equal(seen["lam32"].numpy(), want[:, 0])
        assert ops.p0 == np.float32(derived.HCOK_UM_K)
        assert ops.p1 == np.float32(derived.DUST_X_CLAMP)
    else:
        ops = dk.peak_operands(shape, KW[q]["lo"], KW[q]["hi"])
        for p, bound, key in ((ops.p0, "lo", "lo"), (ops.p1, "hi", "hi")):
            assert p == np.float32(np.log(KW[q][bound]))
            assert np.all(seen[key].numpy() == p)
        assert ops.iters == seen["iters"] == derived.PEAK_ITERS
        assert ops.nodes is None
    assert ops.shape == seen["shape"] == shape
    assert (ops.opthin, ops.noalpha) == (shape.opthin, shape.noalpha)
    assert ops.lxn_base == np.float32(LOG_C2 - math.log(shape.wavenorm))


@pytest.mark.parametrize("shape", SHAPES)
def test_operands_layout(shape):
    """The constants the kernel reads (nodes, then L_IR's weights) and
    the SED evaluations a sample each quantity counts."""
    opz = np.array([1.5, 3.0])
    lir = dk.lir_operands(shape, opz, 8.0, 1000.0)
    np.testing.assert_array_equal(
        lir.consts(), np.concatenate([lir.nodes.ravel(),
                                      lir.weights.ravel()]))
    assert (lir.nsources, lir.evals_per_sample) == (2, derived.LIR_NODES)
    dust = dk.dustmass_operands(shape, opz, 125.0)
    np.testing.assert_array_equal(dust.consts(),
                                  np.float32(125.0 * opz))
    assert (dust.nsources, dust.evals_per_sample) == (2, 1)
    peak = dk.peak_operands(shape)
    assert (peak.nsources, peak.evals_per_sample, peak.consts()) == (
        None, 2 + derived.PEAK_ITERS, None)
    for ops in (lir, dust, peak):
        assert (ops.opthin, ops.noalpha) == (shape.opthin, shape.noalpha)


def _bad(case):
    good = torch.ones((2, 10, 5), dtype=torch.float32)
    ops = dk.lir_operands(MBBShape(), np.array([2.0, 3.0]), 8.0, 1000.0)
    if case == "cpu":
        return good, ops, "CUDA device"
    if case == "float64":
        return good.double(), ops, "float32"
    if case == "width":
        return torch.ones((2, 10, 4)), ops, "float32"
    if case == "rank":
        return torch.ones(50), ops, "float32"
    if case == "strided":
        return good.transpose(0, 1), ops, "contiguous"
    if case == "sources":
        return torch.ones((3, 10, 5)), ops, "2 sources"
    return good, dk.DerivedOperands("sed", MBBShape()), "unknown"


@pytest.mark.parametrize("case", ["cpu", "float64", "width", "rank",
                                  "strided", "sources", "quantity"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    samples, ops, match = _bad(case)
    n0 = dk.mbb_derived.launches
    with pytest.raises(ValueError, match=match):
        dk.mbb_derived(samples, ops)
    assert dk.mbb_derived.launches == n0


def test_device_part_off_the_card_is_the_plain_path():
    """CPU samples take the plain twin: no launch, (S, n) host fp64 of the
    formula on the operands and no device values beside it, the bytes it
    copies counted."""
    samples = _samples(4, nsrc=3, device="cpu")
    ops = dk.lir_operands(MBBShape(), np.array([1.5, 2.0, 3.5]), 8.0, 1000.0)

    def call():
        with profiling.span("mbb.derived.lir"):
            return dk.device_part(samples, ops)

    n0 = dk.mbb_derived.launches
    (got, values), spans = _recording(call)
    assert dk.mbb_derived.launches == n0
    assert values is None
    assert got.dtype == np.float64 and got.shape == (3, 4)
    want = derived.lir_integrand(MBBShape())(
        samples, torch.as_tensor(ops.nodes), torch.as_tensor(ops.weights))
    np.testing.assert_array_equal(got, want.double().numpy())
    assert sum(s.counters.get("d2h_bytes", 0) for s in spans) == got.nbytes


@pytest.mark.parametrize("nsrc", [1, 3])
@pytest.mark.parametrize("q", QUANTITIES)
def test_plain_twin_matches_the_public_formulas(q, nsrc):
    """Each source's row of the twin is derived.py's public single-source
    integrand or peak finder on that source's own nodes, bit for bit."""
    shape = MBBShape(opthin=False, noalpha=False, wavenorm=350.0)
    samples = _samples(50, nsrc=nsrc, seed=nsrc, device="cpu")
    opz = np.array([1.7, 2.9, 4.4])[:nsrc]
    ops = _operands(q, shape, opz)
    got = dk._plain_twin(samples, ops)
    assert got.dtype == np.float64 and got.shape == (nsrc, 50)
    for s in range(nsrc):
        th = samples[s]
        if q == "lir":
            want = derived.lir_integrand(shape)(
                th, torch.as_tensor(ops.nodes[s]),
                torch.as_tensor(ops.weights[s]))
        elif q == "dustmass":
            want = derived.dustmass_integrand(shape)(
                th, torch.tensor(ops.nodes[s, 0]))
        else:
            want = derived.peak_finder(shape, KW[q]["lo"], KW[q]["hi"])(th)
        np.testing.assert_array_equal(got[s], want.double().numpy())


def test_percentile_summary_of_a_batch_is_its_rows():
    """The one summary: (S, n) gives each row's (n,) summary bit for bit,
    and (n,) gives the median and its distances to the percentile bounds
    as MBBResults has always reported them."""
    chains = np.random.default_rng(4).lognormal(3.0, 0.4, (5, 1_001))
    for p in (68.3, 90.0):
        got = derived._percentile_summary(chains, p)
        assert got.shape == (5, 3)
        for row, chain in zip(got, chains):
            one = derived._percentile_summary(chain, p)
            assert one.shape == (3,)
            assert row.tobytes() == one.tobytes()
            lo, mid, hi = np.percentile(chain, [50 - p / 2, 50, 50 + p / 2])
            assert one.tobytes() == np.array([mid, hi - mid,
                                              mid - lo]).tobytes()


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _samples(n, nsrc=None, seed=0, device=None):
    """Posterior-like parameters (T, beta, lambda0, alpha, fnorm), on the
    card unless `device` names another."""
    g = np.random.default_rng(seed)
    shape = (n,) if nsrc is None else (nsrc, n)
    lo = np.array([8.0, 0.8, 80.0, 1.5, 1.0])
    hi = np.array([45.0, 2.6, 900.0, 6.0, 60.0])
    th = lo + (hi - lo) * g.random(shape + (5,))
    return torch.as_tensor(th.astype(np.float32),
                           device=_card() if device is None else device)


def _plain(samples, ops):
    """The plain twin of (n, 5) samples on their own device, host fp64."""
    return dk._plain_twin(samples[None], ops)[0]


def _operands(q, shape, opz):
    if q == "lir":
        return dk.lir_operands(shape, opz, **KW[q])
    if q == "dustmass":
        return dk.dustmass_operands(shape, opz, KW[q]["kappa_wave"])
    return dk.peak_operands(shape, KW[q]["lo"], KW[q]["hi"])


def _gap(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert np.all(np.isfinite(want))
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 62_500, 65_537])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("q", QUANTITIES)
def test_kernel_matches_plain_on_the_card(q, shape, n):
    samples = _samples(n, seed=n)
    ops = _operands(q, shape, 2.7)
    n0 = dk.mbb_derived.launches
    got = dk.mbb_derived(samples, ops)
    assert dk.mbb_derived.launches == n0 + 1
    assert got.dtype == torch.float64 and got.shape == (n,)
    want = _plain(samples, ops)
    gap = _gap(got.cpu(), want)
    print(f"\n{q} opthin={shape.opthin} noalpha={shape.noalpha} n={n}: "
          f"largest relative gap {gap:.3e}")
    assert gap <= RTOL[q]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("q", QUANTITIES)
def test_catalog_operands_per_source_on_the_card(q, shape):
    """Seven sources, each at its own redshift, in one launch: each
    source's row is the plain path at that source's operands."""
    z = np.array([0.3, 0.9, 1.4, 2.0, 2.6, 3.3, 4.1])
    samples = _samples(1_000, nsrc=7, seed=7)
    got = dk.mbb_derived(samples, _operands(q, shape, 1.0 + z)).cpu()
    assert got.shape == (7, 1_000)
    gap = max(_gap(got[s], _plain(samples[s], _operands(q, shape, 1.0 + z[s])))
              for s in range(7))
    print(f"\n7 sources {q} opthin={shape.opthin} noalpha={shape.noalpha}: "
          f"largest relative gap {gap:.3e}")
    assert gap <= RTOL[q]


@pytest.mark.cuda
def test_the_launcher_refuses_what_the_kernel_cannot_run():
    """L_IR nodes beyond a block's 48 KB of shared memory: the launcher
    returns cudaErrorInvalidValue (1), the wrapper raises it and counts no
    launch."""
    samples = _samples(10, nsrc=2)
    wide = dk.DerivedOperands("lir", MBBShape(),
                              nodes=np.ones((2, 7000), np.float32),
                              weights=np.ones((2, 7000), np.float32))
    n0 = dk.mbb_derived.launches
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        dk.mbb_derived(samples, wide)
    assert dk.mbb_derived.launches == n0


def _both_routes(obj, q, thin, monkeypatch):
    """compute_q(thin=...) through the kernel, then through the plain twin
    on the same card."""
    kw = {**KW[q], "thin": thin}
    n0 = dk.mbb_derived.launches
    got, spans = _recording(lambda: getattr(obj, f"compute_{q}")(**kw))
    assert dk.mbb_derived.launches == n0 + 1
    root = spans[0]
    kernel = [s for s in spans if s.name == "mbb.kernel.derived"]
    assert len(kernel) == 1 and kernel[0].parent == root.root
    assert root.counters["d2h_bytes"] == 8 * got.size
    assert kernel[0].attrs["quantity"] == q
    assert kernel[0].attrs["samples"] == got.size
    assert kernel[0].counters["derived_sed_evals"] == \
        got.size * kernel[0].attrs["evals_per_sample"]
    assert not any(s.name == "mbb.derived.chunk" for s in spans)
    with monkeypatch.context() as m:
        m.setattr(dk, "mbb_derived",
                  lambda samples, ops: torch.as_tensor(
                      dk._plain_twin(samples, ops)))
        want = getattr(obj, f"compute_{q}")(**kw)
    assert dk.mbb_derived.launches == n0 + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("thin", [1, 3])
@pytest.mark.parametrize("q", QUANTITIES)
def test_results_match_plain_on_the_card(q, thin, monkeypatch):
    _card()
    res = _single("cuda", nwalkers=32, nsteps=40,
                  shape=MBBShape(wavenorm=350.0))
    got, want = _both_routes(res, q, thin, monkeypatch)
    assert got.shape == want.shape == (-(-32 * 40 // thin),)
    gap = _gap(got, want)
    print(f"\nMBBResults {q} thin={thin}: largest relative gap {gap:.3e}")
    assert gap <= RTOL[q]


@pytest.mark.cuda
@pytest.mark.parametrize("thin", [1, 3])
@pytest.mark.parametrize("q", QUANTITIES)
def test_multifitter_matches_plain_on_the_card(q, thin, monkeypatch):
    _card()
    mf = _catalog("cuda", nsources=7, nwalkers=32, nsteps=40,
                  shape=MBBShape(wavenorm=350.0))
    got, want = _both_routes(mf, q, thin, monkeypatch)
    assert got.shape == want.shape == (7, -(-32 * 40 // thin))
    gap = _gap(got, want)
    print(f"\nMultiFitter {q} thin={thin}: largest relative gap {gap:.3e}")
    assert gap <= RTOL[q]
