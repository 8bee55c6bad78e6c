"""The derived posteriors' summaries (derived.derived_summary).

On the CPU: derived._order_summary, the order statistics of (S, n) values
times a positive per-source factor, is derived._percentile_summary of the
product chain (np.percentile) bit for bit, and declines what it cannot
give exactly; MultiFitter's and MBBResults' *_cen take the device route
only while the kept device part stands for the public chain (the values
are wrapped to report a CUDA device, so the route runs here), and the two
routes agree. On a CUDA device (`-m cuda`): every *_cen of both tiers is
_percentile_summary of its public chain bit for bit, and a `cli_derived`
request counts three device summaries. This file imports no jax:

    python -m pytest --noconftest -q -s -m cuda tests/test_torch_derived_summary.py
"""

import numpy as np
import pytest
import torch

from mbb_emcee_tpu_torch import MBBFitter, MBBResults, MultiFitter
from mbb_emcee_tpu_torch import derived, multifit, results
from mbb_emcee_tpu_torch.ops import derived_kernel as dk
from mbb_emcee_tpu_torch.utils import profiling

torch.set_num_threads(1)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
QUANTITIES = ("lir", "dustmass", "peaklambda")


def _summaries(fn):
    """fn() under the profiler, and the `mbb.derived.summary` spans it
    recorded."""
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.recorded()[n0:]
                 if s.name == "mbb.derived.summary"]


def _values(nsrc, n, seed):
    g = np.random.default_rng(seed)
    return g.lognormal(0.0, 1.0, (nsrc, n)).astype(np.float32)


# -- the order statistics ----------------------------------------------------

@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("percentile", [68.3, 95.0, 50.0])
@pytest.mark.parametrize("nsrc", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 7, 250, 1001])
def test_order_summary_is_numpys_percentile(n, nsrc, percentile, scaled):
    """Sorted fp32 values, times a factor of 1e50-1e54 a source, give
    _percentile_summary of the fp64 product chain bit for bit."""
    x = _values(nsrc, n, seed=n + nsrc)
    factor = (10.0 ** np.random.default_rng(n).uniform(50, 54, nsrc)
              if scaled else None)
    chain = x.astype(np.float64)
    if scaled:
        chain = factor[:, None] * chain
    got = derived._order_summary(torch.as_tensor(x), factor, percentile)
    want = derived._percentile_summary(chain, percentile)
    assert got.shape == want.shape == (nsrc, 3)
    assert np.array_equal(got, want)
    lo, mid, hi = np.percentile(
        chain, [50 - percentile / 2, 50, 50 + percentile / 2], axis=-1)
    assert np.array_equal(got, np.stack([mid, hi - mid, mid - lo], -1))


@pytest.mark.parametrize("case", ["nan_row", "zero_factor", "nan_factor",
                                  "negative_factor", "percentile_above_100"])
def test_order_summary_declines_what_numpy_answers_otherwise(case):
    """None (the caller then takes the host chain) for a row holding a
    NaN, a factor not finite and positive, a percentile past 100."""
    x = _values(3, 40, seed=1)
    factor, percentile = np.full(3, 1e52), 68.3
    if case == "nan_row":
        x[1, 17] = np.nan
    elif case == "zero_factor":
        factor[2] = 0.0
    elif case == "nan_factor":
        factor[0] = np.nan
    elif case == "negative_factor":
        factor[1] = -1e52
    else:
        percentile = 240.0
    assert derived._order_summary(torch.as_tensor(x), factor,
                                  percentile) is None


def test_order_summary_copies_one_small_block():
    """One host copy: the six order statistics and the last column, fp32,
    counted as the summary span's `d2h_bytes`."""
    x = torch.as_tensor(_values(3, 500, seed=2))

    def call():
        with profiling.span("mbb.derived.summary"):
            return derived._order_summary(x, np.full(3, 1e51))

    _, spans = _summaries(call)
    assert spans[0].counters == {"d2h_bytes": 3 * 7 * 4}


# -- routing through both tiers ------------------------------------------------

class _AsOnCard(torch.Tensor):
    """CPU values that report a CUDA device, so the device route runs on
    the CPU."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def as_on_card(monkeypatch):
    """The plain twin's device part kept as if the kernel had written it."""
    real = dk.device_part

    def part(samples, ops):
        host, values = real(samples, ops)
        assert values is None
        return host, torch.as_tensor(host).float().as_subclass(_AsOnCard)

    monkeypatch.setattr(multifit, "device_part", part)
    monkeypatch.setattr(results, "device_part", part)


def _catalog(device="cpu", nsources=3, nwalkers=16, nsteps=8):
    mf = MultiFitter(nwalkers=nwalkers, seed=5, wavenorm=350.0,
                     device=device)
    scale = np.linspace(0.7, 1.4, nsources)[:, None]
    mf.set_data(WAVE, scale * FLUX, 0.06 * scale * FLUX,
                redshifts=np.linspace(0.5, 3.5, nsources))
    mf.run(nburn=4, nsteps=nsteps)
    return mf


def _single(device="cpu", nwalkers=16, nsteps=8):
    fit = MBBFitter(nwalkers=nwalkers, seed=3, wavenorm=350.0,
                    device=device)
    fit.set_data(WAVE, FLUX, 0.06 * FLUX)
    fit.run(nburn=4, nsteps=nsteps)
    return MBBResults(fit, redshift=2.0)


@pytest.fixture(scope="module")
def cpu_fits():
    return {"catalog": _catalog(), "single": _single()}


def _route(obj, q, percentile=68.3):
    """(summary, route, device summaries counted) of obj.q_cen()."""
    got, spans = _summaries(lambda: getattr(obj, f"{q}_cen")(percentile))
    assert len(spans) == 1
    return (got, spans[0].attrs["route"],
            spans[0].counters.get("derived_device_summaries", 0))


@pytest.mark.parametrize("percentile", [68.3, 95.0])
@pytest.mark.parametrize("q", QUANTITIES)
@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_the_routes_agree(cpu_fits, as_on_card, fitter, q, percentile):
    """The kept part's order statistics, counted once, and the host
    chain's np.percentile give the same summary bit for bit."""
    obj = cpu_fits[fitter]
    chain = getattr(obj, f"compute_{q}")()
    got, route, counted = _route(obj, q, percentile)
    assert (route, counted) == ("device", 1)
    want = derived._percentile_summary(chain, percentile)
    assert got.shape == want.shape == ((3, 3) if fitter == "catalog"
                                       else (3,))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("q", QUANTITIES)
@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_a_chain_the_part_does_not_stand_for_takes_the_host(
        cpu_fits, as_on_card, fitter, q):
    """An assigned chain, or the first chain put back after a second
    compute_* replaced the part, is summarised from the host; the second
    call's own chain takes the device route."""
    obj = cpu_fits[fitter]
    first = getattr(obj, f"compute_{q}")()
    setattr(obj, f"{q}_chain", 2.0 * first)
    got, route, counted = _route(obj, q)
    assert (route, counted) == ("host", 0)
    assert got.tobytes() == derived._percentile_summary(
        2.0 * first).tobytes()
    second = getattr(obj, f"compute_{q}")(thin=2)
    assert _route(obj, q)[1:] == ("device", 1)
    setattr(obj, f"{q}_chain", first)
    got, route, _ = _route(obj, q)
    assert route == "host"
    assert got.tobytes() == derived._percentile_summary(first).tobytes()
    assert second.shape[-1] < first.shape[-1]


@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_a_row_with_a_nan_takes_the_host(cpu_fits, as_on_card, fitter,
                                         monkeypatch):
    """A NaN in the kernel's values: numpy's NaN summary, from the host."""
    obj = cpu_fits[fitter]
    real = multifit.device_part

    def with_nan(samples, ops):
        host, values = real(samples, ops)
        host[0, 3] = np.nan
        values[0, 3] = np.nan
        return host, values

    monkeypatch.setattr(multifit, "device_part", with_nan)
    monkeypatch.setattr(results, "device_part", with_nan)
    chain = obj.compute_peaklambda()
    got, route, counted = _route(obj, "peaklambda")
    assert (route, counted) == ("host", 0)
    want = derived._percentile_summary(chain)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(np.atleast_2d(got)[0]).all()


@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_a_chain_from_a_file_takes_the_host(as_on_card, fitter, tmp_path):
    """A file's chains hold no device part."""
    pytest.importorskip("h5py")
    obj = _catalog() if fitter == "catalog" else _single()
    for q in QUANTITIES:
        getattr(obj, f"compute_{q}")()
    path = str(tmp_path / "fit.h5")
    obj.writeToHDF5(path)
    back = (MultiFitter.from_h5(path, device="cpu") if fitter == "catalog"
            else MBBResults(h5file=path, device="cpu"))
    for q in QUANTITIES:
        got, route, counted = _route(back, q)
        assert (route, counted) == ("host", 0)
        assert got.tobytes() == derived._percentile_summary(
            getattr(back, f"{q}_chain")).tobytes()


@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_the_cpu_keeps_the_host_route(cpu_fits, fitter):
    """Off the card nothing is kept on a device: the host route."""
    obj = cpu_fits[fitter]
    for q in QUANTITIES:
        chain = getattr(obj, f"compute_{q}")()
        got, route, counted = _route(obj, q)
        assert (route, counted) == ("host", 0)
        assert got.tobytes() == derived._percentile_summary(chain).tobytes()


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("percentile", [68.3, 95.0])
@pytest.mark.parametrize("n", [1, 2, 7, 62_500])
def test_order_summary_on_the_card(n, percentile):
    """The card's sort gives np.percentile's answer bit for bit, at the
    catalog's 62,500 samples a source too."""
    dev = _card()
    x = _values(16, n, seed=n)
    factor = 10.0 ** np.random.default_rng(n).uniform(50, 54, 16)
    got = derived._order_summary(torch.as_tensor(x, device=dev), factor,
                                 percentile)
    want = derived._percentile_summary(
        factor[:, None] * x.astype(np.float64), percentile)
    assert np.array_equal(got, want)


def _cli_derived(obj):
    """compute_q then q_cen for the three quantities, as a `cli_derived`
    request makes them; the chains, the summaries and the spans."""
    chains, cens = {}, {}

    def request():
        for q in QUANTITIES:
            chains[q] = getattr(obj, f"compute_{q}")()
            cens[q] = getattr(obj, f"{q}_cen")()

    _, spans = _summaries(request)
    return chains, cens, spans


@pytest.mark.cuda
@pytest.mark.parametrize("fitter", ["catalog", "single"])
def test_the_card_summaries_are_the_host_chains(fitter):
    """On the card every *_cen is _percentile_summary of its public chain
    bit for bit, the chains stay host fp64, and a request counts three
    device summaries."""
    dev = _card()
    obj = (_catalog(dev, nsources=7, nwalkers=32, nsteps=40)
           if fitter == "catalog" else _single(dev, nwalkers=32, nsteps=40))
    chains, cens, spans = _cli_derived(obj)
    assert [s.attrs["route"] for s in spans] == ["device"] * 3
    assert sum(s.counters.get("derived_device_summaries", 0)
               for s in spans) == 3
    for q in QUANTITIES:
        chain = chains[q]
        assert type(chain) is np.ndarray and chain.dtype == np.float64
        assert chain.shape == ((7, 32 * 40) if fitter == "catalog"
                               else (32 * 40,))
        for p in (68.3, 90.0):
            got = cens[q] if p == 68.3 else getattr(obj, f"{q}_cen")(p)
            assert got.tobytes() == derived._percentile_summary(
                chain, p).tobytes()
