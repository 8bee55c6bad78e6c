"""The port's upstream-API compat layer (mbb_emcee_tpu_torch/compat.py)
on the CPU: twins of tests/test_compat.py, the upstream positional order
held bitwise against MBBFitter called by keyword, the constructors'
signatures against the JAX compat classes', and the posterior against the
JAX compat fitter's on one problem."""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import compat as jcompat  # noqa: E402
from mbb_emcee_tpu_torch import MBBFitter  # noqa: E402
from mbb_emcee_tpu_torch import compat as tcompat  # noqa: E402
from mbb_emcee_tpu_torch.compat import (  # noqa: E402
    mbb_fitter, mbb_results, modified_blackbody, response, response_set)
from mbb_emcee_tpu_torch.sampler import autocorrelation_time  # noqa: E402


@pytest.fixture(scope="module")
def photfile(tmp_path_factory):
    p = tmp_path_factory.mktemp("compat") / "phot.txt"
    p.write_text("100.0  11.2  0.8\n160.0  32.1  1.9\n250.0  44.8  2.4\n"
                 "350.0  38.2  2.1\n500.0  22.9  1.5\n")
    return str(p)


def test_upstream_fit_and_results_flow(photfile, tmp_path):
    # Constructor shape of the reference: photfile + options in __init__,
    # nthreads accepted (ignored), redshift carried to the results layer.
    fit = mbb_fitter(nwalkers=64, photfile=photfile, redshift=2.2,
                     opthin=True, noalpha=True, nthreads=4, seed=11,
                     device="cpu")
    fit.set_gaussian_prior("beta", 1.9, 0.4)
    fit.set_uplim("T", 80.0)
    fit.run(40, 120)

    # __call__ / like() give lnprob at a full parameter vector.
    theta = np.array([30.0, 1.8, 250.0, 3.5, 40.0])
    assert np.isfinite(float(fit(theta)))
    assert float(fit.like(theta)) == float(fit(theta))

    res = mbb_results(fit=fit)
    # redshift flowed from the fitter -- no explicit redshift= needed for
    # the derived quantities, exactly as upstream.
    assert res.redshift == 2.2
    lir = res.compute_lir()
    assert np.all(np.isfinite(lir)) and np.all(lir > 0)
    c, plus, minus = res.par_cen("T")
    assert plus > 0 and minus > 0

    out = str(tmp_path / "fit.h5")
    res.writeToHDF5(out)
    back = mbb_results(h5file=out, device="cpu")
    np.testing.assert_allclose(back.par_cen("T"), res.par_cen("T"),
                               rtol=1e-6)


def test_upstream_positional_order(photfile):
    """Upstream positional calls put nthreads in slot 8; it must bind to
    nthreads (ignored), never to redshift."""
    fit = mbb_fitter(64, photfile, None, 0, 500.0, False, True, 4,
                     device="cpu")
    assert fit.redshift is None
    fit2 = mbb_fitter(64, photfile, None, 0, 500.0, False, True, 4, 2.5,
                      device="cpu")
    assert fit2.redshift == 2.5
    # The native class refuses the ambiguity outright.
    with pytest.raises(TypeError):
        MBBFitter(64, photfile, None, 0, 500.0, False, True, 4,
                  device="cpu")


def test_cosmo_type_keyword(photfile):
    fit = mbb_fitter(nwalkers=32, photfile=photfile, redshift=1.5,
                     opthin=True, noalpha=True, seed=3, device="cpu")
    fit.run(10, 40)
    r = mbb_results(fit=fit, cosmo_type="Planck18")
    assert r.cosmology_name == "Planck18"
    with pytest.raises(ValueError, match="not both"):
        mbb_results(fit=fit, cosmo_type="WMAP9", cosmology="Planck18")


def test_physics_and_response_aliases():
    mbb = modified_blackbody(32.0, 1.9, 250.0, 3.5, 45.0)
    f = np.asarray(mbb(np.array([250.0, 500.0])))
    assert np.all(np.isfinite(f)) and f.size == 2
    # normalization convention: S(wavenorm=500) = fnorm
    assert f[1] == pytest.approx(45.0, rel=1e-5)

    rs = response_set()
    rs.add("B1", "box:250:50")
    assert rs["B1"].name == "B1"
    assert response is not None


def test_positional_binding_is_the_keyword_call_bitwise(photfile):
    """mbb_fitter's upstream positional slots bind to MBBFitter's keywords
    of the same meaning: the same chain, bit for bit."""
    a = mbb_fitter(64, photfile, None, 0, 500.0, True, True, 4,
                   redshift=2.2, seed=11, device="cpu")
    b = MBBFitter(nwalkers=64, photfile=photfile, covfile=None, covextn=0,
                  wavenorm=500.0, noalpha=True, opthin=True, nthreads=4,
                  redshift=2.2, seed=11, device="cpu")
    assert (a.shape, a.redshift, a.nwalkers) == (b.shape, b.redshift,
                                                 b.nwalkers)
    a.run(20, 40)
    b.run(20, 40)
    assert torch.equal(a.chain_free, b.chain_free)
    assert torch.equal(a.lnprobability, b.lnprobability)


def test_compat_keywords_pass_through_the_jax_policy(photfile):
    """**kwargs reaches MBBFitter: device= and the JAX keywords, which
    fitter.check_jax_keywords refuses by name where the port cannot
    honour them."""
    assert mbb_fitter(photfile=photfile, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="prng_impl"):
        mbb_fitter(photfile=photfile, device="cpu", prng_impl="threefry")


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["mbb_fitter", "mbb_results"])
def test_signatures_match_the_jax_compat_classes(name):
    """The same parameters in the same positional order, with the same
    defaults; the port adds only `device` (mbb_fitter takes it through
    **kwargs)."""
    got = _params(getattr(tcompat, name).__init__)
    want = _params(getattr(jcompat, name).__init__)
    extra = [p for p in got if p not in want]
    assert [p for p in got if p in want] == want
    assert [p[0] for p in extra] == ([] if name == "mbb_fitter"
                                     else ["device"])
    assert tcompat.__all__ == jcompat.__all__


def _median_and_se(chain_free, flat, free):
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain_free),
                                   nan=1.0), 1.0)
    std = flat[:, free].std(axis=0)
    return (np.median(flat[:, free], axis=0),
            1.2533 * std / np.sqrt(flat.shape[0] / tau))


def test_posterior_matches_the_jax_compat_fitter(photfile):
    """One problem through both packages' compat.mbb_fitter: the free
    parameters' medians within max(1%, 3 sigma_MC) (sigma_MC from each
    chain's autocorrelation time, combined)."""
    kw = dict(redshift=2.2, seed=5)
    free = [0, 1, 4]
    tfit = mbb_fitter(64, photfile, None, 0, 500.0, True, True, 1,
                      device="cpu", **kw)
    jfit = jcompat.mbb_fitter(64, photfile, None, 0, 500.0, True, True, 1,
                              **kw)
    for fit in (tfit, jfit):
        fit.set_uplim("T", 100.0)
        fit.set_gaussian_prior("beta", 1.9, 0.4)
        fit.run(200, 600)
    mt, st = _median_and_se(tfit.chain_free.double().numpy(),
                            tfit.chain.reshape(-1, 5), free)
    mj, sj = _median_and_se(np.asarray(jfit.chain_free, np.float64),
                            np.asarray(jfit.chain).reshape(-1, 5), free)
    tol = np.maximum(0.01 * np.abs(mj), 3.0 * np.hypot(st, sj))
    assert np.all(np.abs(mt - mj) <= tol), (mt, mj, tol)
    # the results layer's derived posterior agrees too
    lt = mbb_results(fit=tfit, cosmo_type="WMAP9").compute_lir()
    lj = jcompat.mbb_results(fit=jfit, cosmo_type="WMAP9").compute_lir()
    assert np.median(lt) == pytest.approx(np.median(lj), rel=0.05)
