"""The generic-model tier's MAP, HMC, PT and nested-sampling paths
(SEDFitter.fit_map / map_importance / run(init="map") / run_hmc / run_pt /
compute_evidence) against the JAX package's on the CPU: map_core from
shared starts with the Hessian of the vmapped model (double backward)
against jax.hessian, and each tier's posterior or evidence against the JAX
SEDFitter's within their errors; then the port's twins of the tier tests of
tests/test_sed.py. A companion of tests/test_torch_sed.py, split from it to
keep each file near a minute on one CPU thread."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import mapfit as jmapfit  # noqa: E402
from mbb_emcee_tpu import sed as jsed  # noqa: E402
from mbb_emcee_tpu.likelihood import Photometry as JPhotometry  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape, log_mbb_fnu as j_log_mbb_fnu)
from mbb_emcee_tpu_torch import mapfit  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu, mbb_fnu)
from mbb_emcee_tpu_torch.sed import (  # noqa: E402
    SEDModel, SEDFitter, build_sed_lnprob)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
NAMES = ("T", "beta", "lambda0", "alpha", "fnorm")
LOWER = [0.1, 0.01, 1.0, 0.01, 1e-5]
UPPER = [100.0, 5.0, 2e4, 60.0, 1e7]
SHAPE_THIN = MBBShape(opthin=True, noalpha=True)
JSHAPE_THIN = JShape(opthin=True, noalpha=True)
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])


def _models():
    def fnu(theta, wave):
        return torch.exp(log_mbb_fnu(theta, wave, SHAPE_THIN))

    def jfnu(theta, wave):
        return jnp.exp(j_log_mbb_fnu(theta, wave, JSHAPE_THIN))
    kw = dict(param_names=NAMES, lower=LOWER, upper=UPPER,
              name="mbb-wrapped")
    return SEDModel(fnu=fnu, **kw), jsed.SEDModel(fnu=jfnu, **kw)


def _data():
    f = mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                torch.tensor(WAVE, dtype=torch.float32),
                SHAPE_THIN).double().numpy()
    unc = 0.05 * f
    return f + unc * np.random.default_rng(42).standard_normal(f.size), unc


def _setup(fit, narrow=False):
    flux, unc = _data()
    fit.set_data(WAVE, flux, unc)
    fit.fix_param("lambda0", 250.0).fix_param("alpha", 3.5)
    fit.set_param_init("T", 30.0, 3.0)
    fit.set_param_init("fnorm", 40.0, 5.0)
    if narrow:   # a sane prior volume for the evidence comparisons
        fit.set_lowlim("T", 5.0).set_uplim("T", 80.0)
        fit.set_lowlim("beta", 0.2).set_uplim("beta", 4.0)
        fit.set_lowlim("fnorm", 5.0).set_uplim("fnorm", 200.0)
    return fit


def _thin_fit(nwalkers=48, seed=9, narrow=False):
    return _setup(SEDFitter(_models()[0], nwalkers=nwalkers, seed=seed,
                            device="cpu"), narrow)


def _jax_fit(nwalkers=48, seed=9, narrow=False):
    return _setup(jsed.SEDFitter(_models()[1], nwalkers=nwalkers,
                                 seed=seed), narrow)


@pytest.fixture(scope="module")
def stretch_ref():
    """The stretch-move posterior the tiers are held against."""
    res = _thin_fit().run(nburn=80, nsteps=250).results()
    return {n: res.par_cen(n) for n in ("T", "beta", "fnorm")}


def _near(got, ref, frac=0.75):
    for name, c in ref.items():
        width = c[1] + c[2]
        assert abs(got.par_cen(name)[0] - c[0]) < frac * width, (
            name, got.par_cen(name), c)


# -- MAP: map_core from shared starts, the Hessian against jax.hessian --------------

def test_map_core_and_hessian_match_jax():
    """The same 8 unconstrained starts through both map_cores on the SED
    lnprob: modes within 1e-3 Laplace sigma, lnp at the mode within 1e-3;
    the port's Hessian (double backward through the vmapped model, fp32)
    at the JAX package's mode against -jax.hessian of the jnp twin there
    (rtol 1e-3 of the largest element), Laplace sigmas to rtol 1e-2."""
    tm, jm = _models()
    fit, jfit = _thin_fit(), _jax_fit()
    tl, fs = build_sed_lnprob(fit.phot, tm, fit.spec)
    flux, unc = _data()
    jl, _ = jsed.build_sed_lnprob(JPhotometry(WAVE, flux, unc), jm,
                                  jfit.spec)
    free = fs.free_idx
    x0 = (TRUE[free][None] * np.random.default_rng(1).uniform(
        0.8, 1.2, (8, free.size))).astype(np.float32)
    lower = np.asarray(fs.lower, np.float32)
    width = np.asarray(fs.upper - fs.lower, np.float32)
    u0 = np.asarray(jmapfit._to_unconstrained(jnp.asarray(x0), lower,
                                              width))
    ju, jlnp = jax.jit(lambda u: jmapfit.map_core(
        jl, lower, width, u, 150, 12, 0.1))(jnp.asarray(u0))
    jx = lower + width * jax.nn.sigmoid(ju)
    jH = np.asarray(jmapfit.neg_hessian(jl, jx), np.float64)
    jcov, _ = jmapfit.laplace_cov_host(jH)
    lo, wd = torch.tensor(lower), torch.tensor(width)
    tu, tlnp = mapfit.map_core(tl, lo, wd, torch.tensor(u0), 150, 12, 0.1)
    tx = lo + wd * torch.sigmoid(tu)
    sig = np.sqrt(np.diag(jcov))
    assert np.all(np.abs(tx.double().numpy() - np.asarray(jx)) < 1e-3 * sig)
    assert abs(float(tlnp) - float(jlnp)) < 1e-3
    tH, _ = mapfit.neg_hessian(tl, torch.tensor(np.array(jx)))
    tH = tH.double().numpy()
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-3 * np.abs(jH).max())
    tcov, _ = mapfit.laplace_cov_host(tH)
    np.testing.assert_allclose(np.sqrt(np.diag(tcov)), sig, rtol=1e-2)


def test_fit_map_triage():
    fit = _thin_fit()
    r = fit.fit_map()
    assert r.interior
    names = [fit.model.param_names[i] for i in fit.free_space.free_idx]
    true = {"T": 32.0, "beta": 1.9, "fnorm": 45.0}
    for j, name in enumerate(names):
        assert abs(r.x[j] - true[name]) < 4 * max(r.sigma[j], 1e-3), (
            name, r.x[j], r.sigma[j])
    # a second call from the same seed finds the same mode
    r2 = fit.fit_map()
    np.testing.assert_allclose(r2.x, r.x)


def test_fit_map_matches_jax_fit_map():
    """The two fitters' fit_map (their own starts from their own seeds)
    land on one mode: within 1e-2 Laplace sigma, the sigmas to rtol 2e-2."""
    r = _thin_fit().fit_map()
    rj = _jax_fit().fit_map()
    assert np.all(np.abs(r.x - rj.x) < 1e-2 * rj.sigma)
    np.testing.assert_allclose(r.sigma, rj.sigma, rtol=2e-2)


def test_map_importance_and_seeded_run():
    """Single-fit triage-then-refine on the generic surface: importance
    summaries near the MCMC posterior; init='map' runs; stale guard."""
    fit = _thin_fit()
    fit.fit_map()
    x, logw, ess = fit.map_importance(nsamples=1024)
    assert ess > 50
    c_is = fit.map_par_cen("T")
    fit.run(nburn=60, nsteps=200, init="map")
    c_mc = fit.results().par_cen("T")
    assert abs(c_is[0] - c_mc[0]) < 2.0 * (c_mc[1] + c_mc[2])
    np.testing.assert_allclose(fit.map_par_cen("lambda0"),
                               [250.0, 0.0, 0.0])
    fit.set_gaussian_prior("T", 20.0, 0.5)
    with pytest.raises(RuntimeError, match="different posterior"):
        fit.map_importance(nsamples=16)
    with pytest.raises(RuntimeError, match="different posterior"):
        fit.run(nburn=2, nsteps=2, init="map")


# -- HMC, PT and nested sampling ----------------------------------------------------

def test_run_hmc_matches_stretch_and_jax(stretch_ref):
    """run_hmc (autograd forces through the vmapped model) against the
    stretch posterior and the JAX package's run_hmc on the same data:
    medians within 0.75 of the stretch 68% width."""
    fit = _thin_fit()
    fit.run_hmc(nwarmup=150, nsteps=250, nchains=16)
    res_h = fit.results()
    assert res_h.chain.shape == (16, 250, 5)
    assert 0.5 < np.mean(fit.acceptance_fraction) <= 1.0
    with pytest.raises(RuntimeError, match="finished run"):
        fit.extend(10)
    _near(res_h, stretch_ref)
    jfit = _jax_fit()
    jfit.run_hmc(nwarmup=150, nsteps=250, nchains=16)
    _near(jfit.results(), stretch_ref)


def test_run_pt_and_evidence_match_jax(stretch_ref):
    """run_pt's cold chain near the stretch posterior; its stepping-stone
    lnZ and compute_evidence's nested lnZ against each other and against
    the JAX package's same calls (3x the combined error + 0.5, the twin's
    tolerance)."""
    fit = _thin_fit(nwalkers=32, narrow=True)
    fit.run_pt(nrungs=8, nburn=120, nsteps=300)
    assert np.isfinite(fit.logz_pt[0]) and np.isfinite(fit.logz_ti[0])
    assert fit.pt_result.betas.size >= 8
    with pytest.raises(RuntimeError, match="finished run"):
        fit.extend(10)
    _near(fit.results(), stretch_ref)
    ev = fit.compute_evidence(nlive=200, nbatch=16, nsteps=16,
                              max_iter=1500)
    assert ev.samples.shape[-1] == 5 and fit.evidence is ev
    jfit = _jax_fit(nwalkers=32, narrow=True)
    jfit.run_pt(nrungs=8, nburn=120, nsteps=300)
    jev = jfit.compute_evidence(nlive=200, nbatch=16, nsteps=16,
                                max_iter=1500)
    for a, da, b, db in ((ev.logz, ev.logz_err, fit.logz_pt[0],
                          fit.logz_pt[1]),
                         (ev.logz, ev.logz_err, jev.logz, jev.logz_err),
                         (fit.logz_pt[0], fit.logz_pt[1], jfit.logz_pt[0],
                          jfit.logz_pt[1])):
        assert abs(a - b) < 3.0 * np.hypot(da, db) + 0.5, (a, b)
