"""The port's Fisher forecasts (forecast.py) against the JAX package's on
the same inputs (the model written twice, in jnp and in torch), and twins
of tests/test_forecast.py: exactness on a linear model, agreement with real
MCMC widths, the correlated / response / prior plumbing and the input
refusals. The two photo-z forecasts wait for photoz.py (ROADMAP.md A10b)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.forecast import (  # noqa: E402
    forecast as j_forecast, forecast_mbb as j_forecast_mbb)
from mbb_emcee_tpu.response import ResponseSet as JResponseSet  # noqa: E402
from mbb_emcee_tpu.sed import SEDModel as JSEDModel  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape, log_mbb_fnu as j_log_mbb_fnu)
from mbb_emcee_tpu_torch.forecast import forecast, forecast_mbb  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu, mbb_fnu)
from mbb_emcee_tpu_torch.response import ResponseSet  # noqa: E402
from mbb_emcee_tpu_torch.sed import SEDModel  # noqa: E402

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUTH = np.array([30.0, 1.8, 250.0, 4.0, 40.0])
SHAPE = MBBShape(opthin=True, noalpha=True)


def _fluxes(truth=TRUTH, shape=SHAPE, wave=WAVE):
    return mbb_fnu(torch.tensor(truth, dtype=torch.float32),
                   torch.tensor(wave, dtype=torch.float32),
                   shape).double().numpy()


def _linear(A, names=("a", "b"), name="linear"):
    """(port, JAX) twins of m(theta) = A theta."""
    a_t = torch.as_tensor(np.asarray(A, np.float32))
    a_j = jnp.asarray(A, jnp.float32)
    kw = dict(param_names=names, lower=[0.0] * len(names),
              upper=[10.0] * len(names), name=name)
    return (SEDModel(fnu=lambda th, w: a_t @ th, **kw),
            JSEDModel(fnu=lambda th, w: a_j @ th, **kw))


def _same(fr, jr, rtol=1e-5):
    assert fr.param_names == jr.param_names
    np.testing.assert_allclose(fr.fluxes, jr.fluxes, rtol=1e-6)
    np.testing.assert_allclose(fr.fisher, jr.fisher, rtol=rtol)
    np.testing.assert_allclose(fr.cov, jr.cov, rtol=rtol)
    np.testing.assert_allclose(fr.snr, jr.snr, rtol=1e-6)


def test_linear_model_is_exact():
    """For m(theta) = A theta the Fisher covariance IS the least-squares
    covariance (A^T C^-1 A)^-1; the same through the JAX package."""
    rng = np.random.default_rng(0)
    A = rng.uniform(0.5, 2.0, (WAVE.size, 2))
    model, jmodel = _linear(A)
    unc = rng.uniform(0.5, 1.5, WAVE.size)
    fr = forecast(model, [2.0, 3.0], WAVE, unc=unc, device="cpu")
    want = np.linalg.inv(A.T @ np.diag(1.0 / unc ** 2) @ A)
    np.testing.assert_allclose(fr.cov, want, rtol=1e-4)
    _same(fr, j_forecast(jmodel, [2.0, 3.0], WAVE, unc=unc))
    fr2 = forecast(model, [2.0, 3.0], WAVE, cov=np.diag(unc ** 2),
                   device="cpu")
    np.testing.assert_allclose(fr2.cov, want, rtol=1e-4)
    fr3 = forecast(model, [2.0, 3.0], WAVE, unc=unc,
                   priors={"a": (2.0, 0.1)}, device="cpu")
    want3 = np.linalg.inv(np.linalg.inv(want)
                          + np.diag([1.0 / 0.1 ** 2, 0.0]))
    np.testing.assert_allclose(fr3.cov, want3, rtol=1e-4)
    assert fr3.sigma("a") < fr.sigma("a")
    _same(fr3, j_forecast(jmodel, [2.0, 3.0], WAVE, unc=unc,
                                  priors={"a": (2.0, 0.1)}))


@pytest.mark.parametrize("opthin,noalpha,fixed", [
    (True, True, ()), (False, True, ("lambda0",)), (False, False, ())],
    ids=["thin", "thick", "full"])
def test_forecast_mbb_matches_jax(opthin, noalpha, fixed):
    """forecast_mbb's Jacobian (torch.func.jacfwd through the merge solve
    where there is one) against jax.jacfwd's, with bands on the Wien side
    (24 and 70 um) where alpha acts: the Fisher matrix and its inverse to
    rtol 1e-3 (fp32 derivatives of fp32 model fluxes)."""
    shape = MBBShape(opthin=opthin, noalpha=noalpha)
    truth = np.array([40.0, 1.8, 150.0, 3.0, 40.0])
    wave = np.concatenate([[24.0, 70.0], WAVE])
    unc = 0.05 * _fluxes(truth, shape, wave)
    kw = dict(unc=unc, opthin=opthin, noalpha=noalpha, fixed=fixed,
              priors={"beta": (1.8, 0.5)})
    fr = forecast_mbb(truth, wave, device="cpu", **kw)
    jr = j_forecast_mbb(truth, wave, **kw)
    _same(fr, jr, rtol=1e-3)


def test_matches_mcmc_widths_mbb():
    """On a well-measured SED the Fisher forecast predicts the port's own
    MCMC widths."""
    from mbb_emcee_tpu_torch import MBBFitter, MBBResults
    f = _fluxes()
    unc = 0.05 * f
    fr = forecast_mbb(TRUTH, WAVE, unc=unc, opthin=True, noalpha=True,
                      device="cpu")
    assert set(n.lower() for n in fr.param_names) == {"t", "beta", "fnorm"}
    fit = MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=3,
                    device="cpu")
    fit.set_data(WAVE, f, unc)
    fit.run(nburn=150, nsteps=800)
    res = MBBResults(fit=fit)
    for p in ("T", "beta", "fnorm"):
        cen = res.par_cen(p)
        width = 0.5 * (cen[1] + cen[2])
        assert abs(fr.sigma(p) - width) < 0.2 * width, (p, fr.sigma(p),
                                                        width)


def test_response_mode_and_snr():
    names = [f"B{int(w)}" for w in WAVE]
    rs, jrs = ResponseSet(), JResponseSet()
    for nm, w in zip(names, WAVE):
        rs.add(nm, f"gauss:{w:g}:{0.3 * w:g}")
        jrs.add(nm, f"gauss:{w:g}:{0.3 * w:g}")
    unc = 0.05 * _fluxes()
    js = JShape(opthin=True, noalpha=True)
    kw = dict(param_names=("T", "beta", "lambda0", "alpha", "fnorm"),
              lower=[0.1, 0.01, 1.0, 0.01, 1e-5],
              upper=[1e3, 20.0, 2e4, 60.0, 1e7], name="mbb-resp")
    model = SEDModel(fnu=lambda th, w: torch.exp(log_mbb_fnu(th, w, SHAPE)),
                     **kw)
    jmodel = JSEDModel(fnu=lambda th, w: jnp.exp(j_log_mbb_fnu(th, w, js)),
                       **kw)
    fr_pt = forecast(model, TRUTH, WAVE, unc=unc,
                     fixed=("lambda0", "alpha"), device="cpu")
    fr_rs = forecast(model, TRUTH, WAVE, unc=unc, responses=rs.pack(names),
                     fixed=("lambda0", "alpha"), device="cpu")
    for p in ("T", "beta", "fnorm"):
        assert 0.5 < fr_rs.sigma(p) / fr_pt.sigma(p) < 2.0
    assert fr_pt.snr.shape == WAVE.shape and (fr_pt.snr > 10).all()
    _same(fr_rs, j_forecast(jmodel, TRUTH, WAVE, unc=unc,
                                    responses=jrs.pack(names),
                                    fixed=("lambda0", "alpha")), rtol=1e-3)


def test_validation_errors():
    model = SEDModel(fnu=lambda th, w: th[0] * w,
                     param_names=("a",), lower=[0.0], upper=[10.0])
    with pytest.raises(ValueError, match="positive"):
        forecast(model, [1.0], WAVE, unc=np.zeros(WAVE.size), device="cpu")
    with pytest.raises(ValueError, match="nothing to forecast"):
        forecast(model, [1.0], WAVE, unc=np.ones(WAVE.size), fixed=("a",),
                 device="cpu")
    with pytest.raises(ValueError, match="not a free"):
        forecast(model, [1.0], WAVE, unc=np.ones(WAVE.size),
                 priors={"nope": (0.0, 1.0)}, device="cpu")
    with pytest.raises(ValueError, match="cov must be"):
        forecast(model, [1.0], WAVE, cov=np.eye(2), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        forecast(model, [1.0], WAVE, unc=np.ones(WAVE.size),
                 cov=np.eye(WAVE.size), device="cpu")


def test_scale_disparity_is_not_degeneracy():
    model, jmodel = _linear(np.array([[1e4, 0.0], [0.0, 1e-4]]),
                            names=("big", "small"), name="scales")
    fr = forecast(model, [1.0, 1.0], WAVE[:2], unc=np.ones(2), device="cpu")
    np.testing.assert_allclose(fr.sigma("big"), 1e-4, rtol=1e-3)
    np.testing.assert_allclose(fr.sigma("small"), 1e4, rtol=1e-3)
    _same(fr, j_forecast(jmodel, [1.0, 1.0], WAVE[:2],
                                 unc=np.ones(2)))


def test_snr_and_errors_under_cov():
    rng = np.random.default_rng(3)
    A = rng.uniform(0.5, 2.0, (2, 2))
    model, jmodel = _linear(A, name="c2")
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    fr = forecast(model, [2.0, 1.0], WAVE[:2], cov=cov, device="cpu")
    m = A @ np.array([2.0, 1.0])
    np.testing.assert_allclose(fr.snr, m / np.sqrt(np.diag(cov)), rtol=1e-5)
    _same(fr, j_forecast(jmodel, [2.0, 1.0], WAVE[:2], cov=cov))
    with pytest.raises(ValueError, match="positive-definite"):
        forecast(model, [2.0, 1.0], WAVE[:2],
                 cov=np.array([[1.0, 2.0], [2.0, 1.0]]), device="cpu")
    with pytest.raises(ValueError, match="unc= .*or cov="):
        forecast(model, [2.0, 1.0], WAVE[:2], device="cpu")


def test_response_pack_size_mismatch():
    rs = ResponseSet()
    for w in WAVE[:3]:
        rs.add(f"B{int(w)}", f"gauss:{w:g}:{0.3 * w:g}")
    model = SEDModel(fnu=lambda th, w: th[0] * w, param_names=("a",),
                     lower=[0.0], upper=[10.0])
    with pytest.raises(ValueError, match="3 bands but wave/unc"):
        forecast(model, [1.0], WAVE, unc=np.ones(WAVE.size),
                 responses=rs.pack([f"B{int(w)}" for w in WAVE[:3]]),
                 device="cpu")


def test_forecast_mbb_fixed_by_index():
    unc = np.full(WAVE.size, 1.0)
    by_name = forecast_mbb(TRUTH, WAVE, unc=unc, opthin=True, noalpha=True,
                           fixed=("beta",), device="cpu")
    by_idx = forecast_mbb(TRUTH, WAVE, unc=unc, opthin=True, noalpha=True,
                          fixed=(1,), device="cpu")
    assert by_name.param_names == by_idx.param_names
    np.testing.assert_allclose(by_name.cov, by_idx.cov, rtol=1e-12)
