"""The port's generic-model tier (sed.py) against the JAX package's on the
CPU: every model is written twice with the same formula, once in jnp and
once in torch, and the same numpy inputs made from a seed go through both.
The lnprob builders (single, batch with correlated whitening) on shared
thetas, stretch half-steps replayed from shared uniforms, the run's
posterior, __call__, the derived posteriors, PPC and LOO on a chain shared
through an SED HDF5 file, and SEDModel's vmap/autograd validation; then the
port's twins of tests/test_sed.py's fit, results and file tests
(tests/test_torch_sed_tiers.py holds the MAP, HMC, PT and nested tiers)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu import sed as jsed  # noqa: E402
from mbb_emcee_tpu.likelihood import (  # noqa: E402
    Photometry as JPhotometry, LikelihoodSpec as JSpec)
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape, log_mbb_fnu as j_log_mbb_fnu)
from mbb_emcee_tpu_torch import derived  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    Photometry, LikelihoodSpec, build_lnprob, signed_iunc)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu, mbb_fnu)
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    EnsembleSampler, autocorrelation_time)
from mbb_emcee_tpu_torch.sed import (  # noqa: E402
    SEDModel, SEDFitter, SEDResults, build_sed_lnprob,
    build_sed_lnprob_data, batched_fnu)

# the port's lnprob tolerance (tests/test_torch_lnprob.py)
RTOL, ATOL = 1e-5, 1e-4

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE5 = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
NAMES = ("T", "beta", "lambda0", "alpha", "fnorm")
LOWER = [0.1, 0.01, 1.0, 0.01, 1e-5]
UPPER = [100.0, 5.0, 2e4, 60.0, 1e7]
SHAPE5 = MBBShape()
SHAPE_THIN = MBBShape(opthin=True, noalpha=True)


def _jshape(shape):
    return JShape(opthin=shape.opthin, noalpha=shape.noalpha,
                  wavenorm=shape.wavenorm)


def _mbb_wrapped(shape=SHAPE5):
    """The full 5-parameter MBB as a port SEDModel."""
    def fnu(theta, wave):
        return torch.exp(log_mbb_fnu(theta, wave, shape))
    return SEDModel(fnu=fnu, param_names=NAMES, lower=LOWER, upper=UPPER,
                    name="mbb-wrapped")


def _j_mbb_wrapped(shape=SHAPE5):
    """Its jnp twin."""
    js = _jshape(shape)

    def fnu(theta, wave):
        return jnp.exp(j_log_mbb_fnu(theta, wave, js))
    return jsed.SEDModel(fnu=fnu, param_names=NAMES, lower=LOWER,
                         upper=UPPER, name="mbb-wrapped")


def _mock_flux(shape=SHAPE5, true=TRUE5, frac=0.05, seed=42):
    f = mbb_fnu(torch.tensor(true, dtype=torch.float32),
                torch.tensor(WAVE, dtype=torch.float32),
                shape).double().numpy()
    unc = frac * f
    rng = np.random.default_rng(seed)
    return f + unc * rng.standard_normal(f.size), unc


def _jspec(spec):
    return JSpec(**{k: (None if v is None else np.array(v, copy=True))
                    for k, v in dataclasses.asdict(spec).items()})


def _spec(fixed_alpha=True, priors=True):
    spec = LikelihoodSpec.default()
    spec.upper[0] = 100.0
    spec.upper[1] = 5.0
    if fixed_alpha:   # an out-of-box fixed alpha: the clip-window widening
        spec = dataclasses.replace(
            spec, fixed=np.array([False, False, False, True, False]),
            fixed_values=np.zeros(5))
    if priors:
        spec = dataclasses.replace(
            spec, prior_mean=np.array([0.0, 1.9, 0.0, 0.0, 0.0]),
            prior_isigma=np.array([0.0, 1.0 / 0.3, 0.0, 0.0, 0.0]))
    return spec


def _response_pack(nnodes=17):
    u = np.linspace(-0.2, 0.2, nnodes)
    nodes = WAVE[:, None] * np.exp(u)[None, :]
    w = np.full(nodes.shape, 1.0 / nnodes)
    return nodes, w


def _fit(shape=SHAPE_THIN, nwalkers=48, seed=9, **kw):
    flux, unc = _mock_flux(shape)
    fit = SEDFitter(_mbb_wrapped(shape), nwalkers=nwalkers, seed=seed,
                    device="cpu", **kw)
    fit.set_data(WAVE, flux, unc)
    fit.fix_param("lambda0", 250.0).fix_param("alpha", 3.5)
    fit.set_param_init("T", 30.0, 3.0)
    fit.set_param_init("fnorm", 40.0, 5.0)
    return fit


def _mc_se(chain_free):
    """Per-free-parameter standard error of the median of a
    (nrec, nwalkers, nfree) chain from its autocorrelation time."""
    chain_free = np.asarray(chain_free, np.float64)
    flat = chain_free.reshape(-1, chain_free.shape[-1])
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain_free),
                                   nan=1.0), 1.0)
    return 1.2533 * flat.std(axis=0) / np.sqrt(flat.shape[0] / tau)


# -- the lnprob builders against the JAX package's ------------------------------

MODES = ["point", "cov", "uplim", "response"]


def _phot_and_spec(mode):
    flux, unc = _mock_flux()
    cov = (np.diag(unc ** 2) + 0.2 * np.outer(unc, unc)
           if mode == "cov" else None)
    uplim = np.array([False] * 4 + [True]) if mode == "uplim" else None
    names = [f"b{i}" for i in range(WAVE.size)]
    return (Photometry(WAVE, flux, unc, cov=cov, band_names=names),
            JPhotometry(WAVE, flux, unc, cov=cov, band_names=names),
            dataclasses.replace(_spec(), uplim_bands=uplim),
            _response_pack() if mode == "response" else None)


@pytest.mark.parametrize("mode", MODES)
def test_lnprob_matches_jax(mode):
    """build_sed_lnprob on the wrapped MBB against the JAX package's on 64
    shared free vectors (about 10% out of the box), point, covariance,
    upper-limit and response mode: the port's lnprob tolerance, floors
    identical."""
    phot, jphot, spec, pack = _phot_and_spec(mode)
    t_fn, fs = build_sed_lnprob(phot, _mbb_wrapped(), spec,
                                response_pack=pack, device="cpu")
    j_fn, jfs = jsed.build_sed_lnprob(jphot, _j_mbb_wrapped(),
                                      _jspec(spec), response_pack=pack)
    assert np.array_equal(fs.free_idx, jfs.free_idx)
    rng = np.random.default_rng(3)
    x = (TRUE5[fs.free_idx][None] * rng.uniform(0.8, 1.2, (64, fs.nfree))
         ).astype(np.float32)
    x[::10, 0] = 150.0                      # T above its box
    got = t_fn(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.vmap(j_fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all((got <= -1e25) == (want <= -1e25))
    assert np.sum(got <= -1e25) == 7


def test_lnprob_matches_mbb_builder():
    """build_sed_lnprob on the wrapped MBB reproduces the port's own
    build_lnprob (same whitening, priors, box floor, fixed-value widening)
    at rtol 1e-6 -- point mode, covariance mode, and upper-limit mode."""
    flux, unc = _mock_flux()
    model = _mbb_wrapped()
    rng = np.random.default_rng(0)
    for cov, uplim in [(None, None),
                       (np.diag(unc ** 2) + 0.2 * np.outer(unc, unc), None),
                       (None, np.array([False] * 4 + [True]))]:
        phot = Photometry(WAVE, flux, unc, cov=cov)
        sp = dataclasses.replace(_spec(), uplim_bands=uplim)
        ln_mbb, fs_mbb = build_lnprob(phot, SHAPE5, sp, device="cpu")
        ln_sed, fs_sed = build_sed_lnprob(phot, model, sp, device="cpu")
        assert np.array_equal(fs_mbb.free_idx, fs_sed.free_idx)
        thetas = torch.as_tensor((rng.uniform(0.9, 1.1, (16, fs_mbb.nfree))
                                  * np.array([32.0, 1.9, 250.0, 45.0])
                                  ).astype(np.float32))
        np.testing.assert_allclose(ln_sed(thetas).numpy(),
                                   ln_mbb(thetas).numpy(), rtol=1e-6)


def test_builder_equivalence_random_configs():
    """Property sweep: on RANDOM combinations of fixed params, priors, box
    edits, uplims and covariance, the generic builder equals the port's MBB
    builder on the wrapped model (rtol 1e-6) and the JAX package's generic
    builder (the lnprob tolerance)."""
    model, jmodel = _mbb_wrapped(), _j_mbb_wrapped()
    rng = np.random.default_rng(7)
    flux, unc = _mock_flux()
    for trial in range(10):
        spec = _spec(fixed_alpha=False, priors=False)
        fixed = rng.random(5) < 0.3
        if fixed.all():
            fixed[rng.integers(5)] = False
        fixed_vals = np.where(fixed, [30.0, 2.0, 250.0, 3.5, 40.0], 0.0)
        pm = np.where(rng.random(5) < 0.4,
                      [30.0, 1.9, 250.0, 3.5, 45.0], 0.0)
        pis = np.where(pm > 0, 1.0 / rng.uniform(0.2, 3.0, 5), 0.0)
        uplim = (rng.random(5) < 0.25) if rng.random() < 0.5 else None
        cov = None
        if uplim is None and rng.random() < 0.5:
            cov = np.diag(unc ** 2) + 0.15 * np.outer(unc, unc)
        spec = dataclasses.replace(
            spec, fixed=fixed, fixed_values=fixed_vals,
            prior_mean=pm, prior_isigma=pis, uplim_bands=uplim)
        phot = Photometry(WAVE, flux, unc, cov=cov)
        ln_mbb, fs = build_lnprob(phot, SHAPE5, spec, device="cpu")
        ln_sed, fs2 = build_sed_lnprob(phot, model, spec, device="cpu")
        j_fn, _ = jsed.build_sed_lnprob(JPhotometry(WAVE, flux, unc,
                                                    cov=cov),
                                        jmodel, _jspec(spec))
        assert np.array_equal(fs.free_idx, fs2.free_idx)
        thetas = (TRUE5[fs.free_idx][None, :]
                  * rng.uniform(0.85, 1.15, (8, fs.nfree))).astype(
            np.float32)
        a = ln_mbb(torch.as_tensor(thetas)).numpy()
        b = ln_sed(torch.as_tensor(thetas)).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5,
                                   err_msg=f"trial {trial}")
        np.testing.assert_allclose(
            b, np.asarray(jax.vmap(j_fn)(jnp.asarray(thetas))), rtol=RTOL,
            atol=ATOL, err_msg=f"trial {trial}")


@pytest.mark.parametrize("correlated", [False, True],
                         ids=["signed_iunc", "whitened"])
def test_lnprob_data_matches_jax(correlated):
    """build_sed_lnprob_data, (S, n, nfree) -> (S, n), against the JAX
    package's per-source function vmapped over sources and walkers: 3
    sources, a missing band, per-source upper limits (signed 1/sigma) or a
    per-source whitening matrix of correlated band errors."""
    spec = _spec()
    model, jmodel = _mbb_wrapped(), _j_mbb_wrapped()
    flux0, unc0 = _mock_flux()
    flux = np.stack([flux0 * s for s in (0.8, 1.0, 1.3)])
    unc = 0.05 * flux
    unc[1, 0] = np.inf
    flux[1, 0] = 0.0
    if correlated:
        aux = []
        for s in range(3):
            cov = np.diag(unc[s] ** 2) + 0.2 * np.outer(unc[s], unc[s])
            keep = np.isfinite(unc[s])
            w = np.zeros((5, 5))
            sub = np.linalg.inv(np.linalg.cholesky(
                np.where(np.isfinite(cov), cov, 0.0)[np.ix_(keep, keep)]))
            w[np.ix_(keep, keep)] = sub
            aux.append(w)
        aux = np.asarray(aux)
    else:
        ul = np.zeros((3, 5), bool)
        ul[0, 4] = ul[2, 1] = True
        aux = signed_iunc(unc, ul)
    t_fn, fs = build_sed_lnprob_data(model, spec, correlated=correlated,
                                     device="cpu")
    j_fn, _ = jsed.build_sed_lnprob_data(jmodel, _jspec(spec),
                                         correlated=correlated)
    rng = np.random.default_rng(5)
    x = (TRUE5[fs.free_idx][None, None] * rng.uniform(
        0.85, 1.15, (3, 12, fs.nfree))).astype(np.float32)
    f32 = [np.asarray(a, np.float32) for a in (WAVE, flux, aux)]
    got = t_fn(torch.as_tensor(x), *(torch.as_tensor(a) for a in f32))
    want = jax.vmap(lambda xs, fl, ax: jax.vmap(
        lambda th: j_fn(th, jnp.asarray(f32[0]), fl, ax))(xs))(
        jnp.asarray(x), jnp.asarray(f32[1]), jnp.asarray(f32[2]))
    assert got.shape == (3, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_half_steps_replay_jax():
    """64 walkers, 3 records x thin 2 of stretch half-steps of the SED
    lnprob on shared uniforms against the JAX package's
    stretch_half_step_from_uniforms on its SED lnprob: chain and lnp at
    rtol 2e-5, accept counts equal."""
    flux, unc = _mock_flux(SHAPE5)
    spec = _spec()
    t_fn, fs = build_sed_lnprob(Photometry(WAVE, flux, unc), _mbb_wrapped(),
                                spec, device="cpu")
    j_fn, _ = jsed.build_sed_lnprob(JPhotometry(WAVE, flux, unc),
                                    _j_mbb_wrapped(), _jspec(spec))
    j_batch = jax.jit(jax.vmap(j_fn))
    rng = np.random.default_rng(11)
    c = TRUE5[fs.free_idx]
    nw, nrec, thin = 64, 3, 2
    half = nw // 2
    p0 = (c + 0.05 * c * rng.standard_normal((nw, c.size))).astype(
        np.float32)
    u = rng.uniform(0.001, 0.999, (nrec, 6 * thin, half)).astype(np.float32)

    pos_a, pos_b = jnp.asarray(p0[:half]), jnp.asarray(p0[half:])
    lnp = j_batch(jnp.asarray(p0))
    lnp_a, lnp_b = lnp[:half], lnp[half:]
    want, want_lnp, nacc = [], [], np.zeros(nw, np.int64)
    for r in range(nrec):
        for t in range(thin):
            ur = u[r, 6 * t:6 * t + 6]
            pos_a, lnp_a, acc_a = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(ur[0:3]), pos_a, pos_b, lnp_a, j_batch)
            pos_b, lnp_b, acc_b = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(ur[3:6]), pos_b, pos_a, lnp_b, j_batch)
            nacc += np.concatenate([np.asarray(acc_a), np.asarray(acc_b)])
        want.append(np.concatenate([np.asarray(pos_a), np.asarray(pos_b)]))
        want_lnp.append(np.concatenate([np.asarray(lnp_a),
                                        np.asarray(lnp_b)]))

    sampler = EnsembleSampler(nw, fs.nfree, t_fn)
    state = sampler.init_state(torch.as_tensor(p0), seed=1)
    state, chain, lnpc = sampler.run_mcmc(state, nrec * thin, thin,
                                          uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(chain.numpy(), np.stack(want), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lnpc.numpy(), np.stack(want_lnp), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(state.naccept.numpy(), nacc)


# -- SEDModel validation ----------------------------------------------------------

def test_sedmodel_validation():
    good = _mbb_wrapped()
    assert good.npar == 5
    assert good.param_index("LAMBDA0") == 2
    assert good.param_index(4) == 4
    with pytest.raises(ValueError, match="unknown parameter"):
        good.param_index("T_dust")
    with pytest.raises(ValueError, match="out of range"):
        good.param_index(5)
    with pytest.raises(ValueError, match="lower/upper"):
        SEDModel(fnu=good.fnu, param_names=("a", "b"),
                 lower=[0.0], upper=[1.0, 2.0])
    with pytest.raises(ValueError, match="unique"):
        SEDModel(fnu=good.fnu, param_names=("a", "A"),
                 lower=[0.0, 0.0], upper=[1.0, 1.0])
    with pytest.raises(ValueError, match="lower limit"):
        SEDModel(fnu=good.fnu, param_names=("a",), lower=[2.0], upper=[1.0])
    # validate() catches a wrong-shape fnu before any sampling starts.
    bad = SEDModel(fnu=lambda th, w: torch.sum(w) * th[0],
                   param_names=("a",), lower=[0.5], upper=[1.5])
    with pytest.raises(ValueError, match="shape"):
        bad.validate(device="cpu")


def _branchy(th, w):
    if th[0] > 1.0:            # a Python branch on a tensor value
        return th[0] * w
    return w


def _item(th, w):
    return w * th[0].item()


def _inplace(th, w):
    w.mul_(th[0])              # an in-place write to an input
    return w


@pytest.mark.parametrize("fnu", [_branchy, _item, _inplace],
                         ids=["branch", "item", "inplace"])
def test_validate_refuses_what_vmap_cannot_batch(fnu):
    """A model that evaluates at one theta but that torch.func.vmap cannot
    batch (or autograd cannot differentiate) fails at the fitter's
    construction, naming the model -- not deep inside a sampler."""
    model = SEDModel(fnu=fnu, param_names=("a",), lower=[0.5], upper=[2.5],
                     name="unbatchable")
    with pytest.raises(ValueError, match="unbatchable.*vmap"):
        SEDFitter(model, nwalkers=8, device="cpu")
    # the plain-ops twin of the branch passes
    ok = SEDModel(fnu=lambda th, w: torch.where(th[0] > 1.0, th[0] * w, w),
                  param_names=("a",), lower=[0.5], upper=[2.5])
    SEDFitter(ok, nwalkers=8, device="cpu")


def test_vmap_of_the_mbb_physics_on_every_grid():
    """The wrapped MBB's single-theta fnu under vmap equals log_mbb_fnu
    batched over rows, on the (nb,) data grid, a (nb, nnodes) response
    pack and a (1,) normalization grid -- the merge solve included."""
    rng = np.random.default_rng(2)
    th = (TRUE5[None] * rng.uniform(0.7, 1.3, (32, 5))).astype(np.float32)
    model = _mbb_wrapped()
    for grid in (WAVE, _response_pack()[0], np.array([500.0])):
        g = torch.as_tensor(grid.astype(np.float32))
        got = batched_fnu(model.fnu)(torch.as_tensor(th), g)
        want = mbb_fnu(torch.as_tensor(th), g, SHAPE5)
        assert got.shape == (32,) + grid.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


# -- fitting -------------------------------------------------------------------------

def _wrapped_setup(fit, true):
    fit.fix_param("lambda0", 250.0).fix_param("alpha", 3.5)
    fit.set_param_init("T", 30.0, 3.0)
    fit.set_param_init("fnorm", 40.0, 5.0)
    fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    return fit


@pytest.fixture(scope="module")
def wrapped_fit():
    """Wrapped-MBB SEDFitter run on thin 3-param mock data."""
    true = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
    flux, unc = _mock_flux(SHAPE_THIN, true)
    fit = SEDFitter(_mbb_wrapped(SHAPE_THIN), nwalkers=64, redshift=2.5,
                    seed=17, device="cpu")
    fit.set_data(WAVE, flux, unc)
    _wrapped_setup(fit, true)
    fit.run(nburn=80, nsteps=300)
    return fit


def test_sedfitter_recovers_truth(wrapped_fit):
    fit = wrapped_fit
    chain = fit.chain
    assert chain.shape == (64, 300, 5)
    assert np.all(chain[:, :, 2] == 250.0)
    assert np.all(chain[:, :, 3] == 3.5)
    res = fit.results()
    for name, true_v in [("T", 32.0), ("beta", 1.9), ("fnorm", 45.0)]:
        c = res.par_cen(name)
        assert abs(c[0] - true_v) < 5 * max(c[1], c[2]), (name, c)
    assert 0.2 < np.mean(fit.acceptance_fraction) < 0.8
    names, rhat = fit.gelman_rubin()
    assert names == ["T", "beta", "fnorm"]
    assert rhat.max() < 1.2
    assert np.all(fit.autocorrelation_time() > 0)


def test_run_matches_jax_posterior(wrapped_fit):
    """The same data and setup through the JAX package's SEDFitter: the
    medians agree within 3 sigma_MC (both chains' autocorrelation times)
    and the 68% widths within 25% (not bitwise: other random streams)."""
    jfit = jsed.SEDFitter(_j_mbb_wrapped(SHAPE_THIN), nwalkers=64,
                          redshift=2.5, seed=17)
    jfit.set_data(WAVE, wrapped_fit.phot.flux, wrapped_fit.phot.unc)
    _wrapped_setup(jfit, TRUE5)
    jfit.run(nburn=80, nsteps=300)
    a = wrapped_fit.chain_free.double().numpy()
    b = np.asarray(jfit.chain_free, np.float64)
    fa, fb = a.reshape(-1, 3), b.reshape(-1, 3)
    tol = 3.0 * np.hypot(_mc_se(a), _mc_se(b))
    assert np.all(np.abs(np.median(fa, 0) - np.median(fb, 0)) < tol), (
        np.median(fa, 0), np.median(fb, 0), tol)
    wa, wb = (np.diff(np.percentile(f, [15.85, 84.15], axis=0), axis=0)[0]
              for f in (fa, fb))
    assert np.all(np.abs(wa - wb) < 0.25 * wb), (wa, wb)


def test_sedfitter_matches_mbbfitter_posterior(wrapped_fit):
    """Same data, same posterior through the port's MBBFitter: the two
    pipelines agree statistically."""
    from mbb_emcee_tpu_torch import MBBFitter
    fit = wrapped_fit
    mfit = MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=23,
                     device="cpu")
    mfit.set_data(WAVE, fit.phot.flux, fit.phot.unc)
    mfit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    mfit.run(nburn=80, nsteps=300)
    res_s = fit.results()
    flat_m = mfit.chain.reshape(-1, 5)
    for i, name in [(0, "T"), (1, "beta"), (4, "fnorm")]:
        med_s = res_s.par_cen(name)[0]
        med_m = np.median(flat_m[:, i])
        width_s = res_s.par_cen(name)[1] + res_s.par_cen(name)[2]
        width_m = np.diff(np.percentile(flat_m[:, i], [15.85, 84.15]))[0]
        assert abs(med_s - med_m) < 0.25 * width_m, (name, med_s, med_m)
        assert abs(width_s - width_m) < 0.5 * width_m, (name, width_s,
                                                        width_m)


def test_gaussian_prior_pulls_posterior():
    def run(prior):
        fit = _fit()
        if prior:
            fit.set_gaussian_prior("T", 25.0, 0.5)
        fit.run(nburn=60, nsteps=200)
        return fit.results().par_cen("T")[0]

    assert run(True) < run(False) - 1.0


def test_box_limits_respected():
    fit = _fit()
    fit.set_lowlim("T", 33.0).set_uplim("T", 40.0)
    fit.run(nburn=40, nsteps=120)
    t = fit.chain[:, :, 0]
    assert t.min() >= 33.0 and t.max() <= 40.0


def test_call_full_vector(wrapped_fit):
    """__call__ evaluates lnprob at a full theta; out-of-box free values
    floor; fixed slots accept their pinned values; the JAX package's
    __call__ agrees at the lnprob tolerance."""
    fit = wrapped_fit
    jfit = jsed.SEDFitter(_j_mbb_wrapped(SHAPE_THIN), nwalkers=64)
    jfit.set_data(WAVE, fit.phot.flux, fit.phot.unc)
    _wrapped_setup(jfit, TRUE5)
    good = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
    v = fit(good)
    assert np.isfinite(v) and v > -1e20
    rng = np.random.default_rng(4)
    for p in [good] + [good * rng.uniform(0.9, 1.1, 5) for _ in range(4)]:
        np.testing.assert_allclose(fit(p), jfit(p), rtol=RTOL, atol=ATOL)
    bad = good.copy()
    bad[0] = 1e4
    assert fit(bad) <= -1e25 and jfit(bad) <= -1e25
    with pytest.raises(ValueError, match="full parameter"):
        fit(np.array([32.0, 1.9]))


def test_extend_and_guard():
    """run(n1) + extend(n2) is run(n1 + n2)'s chain bit for bit (the
    Philox stream continues); a changed posterior refuses to extend."""
    fit = _fit()
    fit.run(nburn=30, nsteps=60)
    fit.extend(40)
    assert fit.chain.shape[1] == 100
    assert fit.lnprobability.shape[0] == 100
    whole = _fit().run(nburn=30, nsteps=100)
    assert torch.equal(fit.chain_free, whole.chain_free)
    assert torch.equal(fit.lnprobability, whole.lnprobability)
    np.testing.assert_array_equal(fit.acceptance_fraction * 100,
                                  whole.acceptance_fraction * 100)
    fit.set_gaussian_prior("T", 30.0, 1.0)
    with pytest.raises(RuntimeError, match="changed since run"):
        fit.extend(20)


def test_response_mode_matches_manual_quadrature():
    from mbb_emcee_tpu_torch.response import ResponseSet
    flux, unc = _mock_flux()
    names = [f"b{i}" for i in range(WAVE.size)]
    rs = ResponseSet()
    for n, w in zip(names, WAVE):
        rs.add(n, f"box:{w}:{0.2 * w}:33")
    model = _mbb_wrapped()
    fit = SEDFitter(model, nwalkers=16, seed=3, device="cpu")
    fit.set_data(WAVE, flux, unc, band_names=names)
    fit.set_responses(rs)
    pack = fit._response_pack()
    theta = np.array([30.0, 2.0, 200.0, 3.0, 40.0])
    vals = model.fnu(torch.tensor(theta, dtype=torch.float32),
                     torch.tensor(pack[0], dtype=torch.float32)).numpy()
    manual = np.sum(np.asarray(pack[1]) * vals, axis=-1)
    lnp, fs = build_sed_lnprob(fit.phot, model, fit.spec,
                               response_pack=pack, device="cpu")
    r = (manual - flux) / unc
    expect = -0.5 * np.sum(r * r)
    got = float(lnp(torch.tensor(theta[fs.free_idx][None],
                                 dtype=torch.float32))[0])
    np.testing.assert_allclose(got, expect, rtol=2e-4)


def test_requires_named_bands_for_responses():
    from mbb_emcee_tpu_torch.response import ResponseSet
    flux, unc = _mock_flux()
    fit = SEDFitter(_mbb_wrapped(), nwalkers=16, seed=3, device="cpu")
    fit.set_data(WAVE, flux, unc)
    fit.set_responses(ResponseSet())
    with pytest.raises(ValueError, match="named photometry bands"):
        fit.build()


def test_uplim_cov_guard_is_bidirectional(tmp_path):
    from mbb_emcee_tpu_torch.utils.fits import write_fits_image
    flux, unc = _mock_flux()
    model = _mbb_wrapped()
    cov = np.diag(unc ** 2)
    f1 = SEDFitter(model, nwalkers=16, device="cpu")
    f1.set_data(WAVE, flux, unc, cov=cov)
    with pytest.raises(ValueError, match="do not compose"):
        f1.set_phot_upperlimits([True, False, False, False, False])
    f2 = SEDFitter(model, nwalkers=16, device="cpu")
    f2.set_data(WAVE, flux, unc)
    f2.set_phot_upperlimits([True, False, False, False, False])
    with pytest.raises(ValueError, match="do not compose"):
        f2.set_data(WAVE, flux, unc, cov=cov)
    covf = str(tmp_path / "c.fits")
    write_fits_image(covf, cov)
    with pytest.raises(ValueError, match="do not compose"):
        f2.read_cov(covf, is_total=True)
    f3 = SEDFitter(model, nwalkers=16, device="cpu")
    f3.set_data(WAVE, flux, unc)
    f3.set_phot_upperlimits([False] * 5)
    f3.set_data(WAVE, flux, unc, cov=cov)


def test_spec_size_mismatch_raises():
    flux, unc = _mock_flux()
    with pytest.raises(ValueError, match="sized for"):
        build_sed_lnprob(Photometry(WAVE, flux, unc), _mbb_wrapped(),
                         LikelihoodSpec.for_box([0.0, 1.0], [1.0, 2.0]),
                         device="cpu")


# -- derived quantities and model checks on a chain shared with the JAX package --

@pytest.fixture(scope="module")
def shared(wrapped_fit, tmp_path_factory):
    """(port SEDResults, JAX SEDResults) of one chain: the port's file read
    by the JAX package."""
    res = wrapped_fit.results()
    path = str(tmp_path_factory.mktemp("sed") / "shared.h5")
    res.writeToHDF5(path)
    return res, jsed.SEDResults(h5file=path,
                                model=_j_mbb_wrapped(SHAPE_THIN)), path


def test_derived_match_mbbresults(wrapped_fit):
    """On the SAME chain, generic L_IR / peak-lambda / sed band equal the
    port's MBBResults evaluators (the wrapped model IS the MBB)."""
    res = wrapped_fit.results()
    samples = torch.as_tensor(res._thinned(7), dtype=torch.float32)
    lam, w = derived.lir_nodes_weights(res._opz(), 8.0, 1000.0)
    one = derived.lir_integrand(SHAPE_THIN)
    ref = one(samples, torch.as_tensor(lam, dtype=torch.float32),
              torch.as_tensor(w, dtype=torch.float32)).double().numpy()
    ref *= derived.lir_prefactor(res._dl_mpc())
    np.testing.assert_allclose(res.compute_lir(thin=7), ref, rtol=3e-5)
    ref_p = derived.peak_finder(SHAPE_THIN)(samples).double().numpy()
    np.testing.assert_allclose(res.compute_peaklambda(thin=7), ref_p,
                               rtol=1e-4)
    grid = np.geomspace(50.0, 2000.0, 16)
    sed = derived.sed_eval(SHAPE_THIN, torch.as_tensor(grid,
                                                       dtype=torch.float32))
    fl = sed(torch.as_tensor(res._thinned(1),
                             dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(res.sed_percentiles(grid),
                               derived.sed_band(fl, 68.3, sample_axis=0),
                               rtol=2e-5)


def test_derived_match_jax_on_a_shared_chain(shared):
    """compute_lir (rtol 1e-4), compute_peaklambda (rtol 2e-3, the packages'
    fp32 golden-section plateau) and sed_percentiles of the port against
    the JAX package's SEDResults on the same chain."""
    res, jres, _ = shared
    np.testing.assert_allclose(res.compute_lir(thin=5),
                               jres.compute_lir(thin=5), rtol=1e-4)
    np.testing.assert_allclose(res.compute_peaklambda(thin=5),
                               jres.compute_peaklambda(thin=5), rtol=2e-3)
    grid = np.geomspace(60.0, 1500.0, 9)
    np.testing.assert_allclose(res.sed_percentiles(grid, thin=3),
                               jres.sed_percentiles(grid, thin=3), rtol=1e-5)


def _z_models():
    """(port, JAX) twins of a model with a SAMPLED redshift: a thin
    greybody whose observed temperature is T / (1 + z)."""
    js = _jshape(SHAPE_THIN)

    def fnu(th, w):
        t_obs = th[0] / (1.0 + th[3])
        p = torch.stack([t_obs, th[1], torch.full_like(t_obs, 250.0),
                         torch.full_like(t_obs, 3.5), th[2]])
        return torch.exp(log_mbb_fnu(p, w, SHAPE_THIN))

    def jfnu(th, w):
        t_obs = th[0] / (1.0 + th[3])
        p = jnp.stack([t_obs, th[1], 250.0, 3.5, th[2]])
        return jnp.exp(j_log_mbb_fnu(p, w, js))

    kw = dict(param_names=("T", "beta", "fnorm", "z"),
              lower=[5.0, 0.5, 1.0, 0.5], upper=[150.0, 4.0, 500.0, 6.0],
              name="photoz-greybody")
    return SEDModel(fnu=fnu, **kw), jsed.SEDModel(fnu=jfnu, **kw)


def test_lir_with_a_sampled_redshift_matches_jax(tmp_path):
    """compute_lir(z_param="z"): each sample integrated over its own
    observed window with its own D_L (luminosity_distance_batch), against
    the JAX package's on the same chain (rtol 1e-4); an explicit lumdist=
    contradicts a sampled z."""
    from mbb_emcee_tpu_torch.models.cosmology import (
        luminosity_distance, luminosity_distance_batch)
    from mbb_emcee_tpu.models.cosmology import (
        luminosity_distance_batch as j_dl_batch)
    tm, jm = _z_models()
    wave = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
    f = batched_fnu(tm.fnu)(torch.tensor([[38.0, 1.9, 10.0, 3.0]]),
                            torch.tensor(wave, dtype=torch.float32))
    f = f[0].double().numpy()
    fit = SEDFitter(tm, nwalkers=32, seed=4, device="cpu")
    fit.set_data(wave, f, 0.07 * f)
    fit.set_gaussian_prior("T", 38.0, 6.0)
    for n, v in zip(tm.param_names, (38.0, 1.9, 10.0, 3.0)):
        fit.set_param_init(n, v, 0.05 * v)
    fit.run(nburn=20, nsteps=40)
    path = str(tmp_path / "z.h5")
    res = fit.results()
    res.writeToHDF5(path)
    jres = jsed.SEDResults(h5file=path, model=jm)
    got = res.compute_lir(thin=3, z_param="z")
    np.testing.assert_allclose(got, jres.compute_lir(thin=3, z_param="z"),
                               rtol=1e-4)
    assert res.lir_meta["z_param"] == "z" and np.all(got > 0)
    zs = np.array([0.0, 0.5, 3.0, 7.5])
    np.testing.assert_allclose(luminosity_distance_batch(zs),
                               j_dl_batch(zs), rtol=1e-12)
    np.testing.assert_allclose(luminosity_distance_batch(zs)[1:],
                               [luminosity_distance(z) for z in zs[1:]],
                               rtol=1e-10)
    with pytest.raises(ValueError, match="lumdist"):
        SEDResults(fit=fit, lumdist=100.0).compute_lir(z_param="z")


def _p_tol(p, n):
    p = np.clip(np.asarray(p, np.float64), 1.0 / n, 1.0 - 1.0 / n)
    return 4.0 * np.sqrt(2.0 * p * (1.0 - p) / n)


def test_ppc_and_loo_match_jax_on_a_shared_chain(shared):
    """posterior_predictive: chi2_obs of each sample to rtol 1e-5 (plus the
    fp32 model fluxes' rounding), p_value within 4 standard errors of two
    independent replicate draws; compute_loo: the pointwise lpd and
    elpd_loo of the JAX package's."""
    res, jres, _ = shared
    tp, jp = res.posterior_predictive(thin=5), jres.posterior_predictive(
        thin=5)
    snr = np.max(np.abs(res.phot.flux) / res.phot.unc)
    tol = 1e-5 * np.abs(jp.chi2_obs) + 2e-6 * snr * (
        1.0 + np.sqrt(np.abs(jp.chi2_obs)))
    assert np.all(np.abs(tp.chi2_obs - jp.chi2_obs) <= tol)
    assert abs(tp.p_value - jp.p_value) <= _p_tol(jp.p_value, tp.nsamples)
    assert tp.ndata == jp.ndata == 5 and tp.nfree == jp.nfree == 3
    tl, jl = res.compute_loo(thin=5), jres.compute_loo(thin=5)
    np.testing.assert_allclose(tl.pointwise_lpd, jl.pointwise_lpd,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.elpd_loo, jl.elpd_loo, rtol=1e-3)


def test_ppc_wellspecified(wrapped_fit):
    ppc = wrapped_fit.results().posterior_predictive(thin=5)
    assert 0.01 < ppc.p_value < 0.99
    det = np.isfinite(ppc.band_p)
    assert det.all()
    assert np.all((ppc.band_p > 0.001) & (ppc.band_p < 0.999))


# -- persistence ----------------------------------------------------------------------

def test_hdf5_roundtrip(wrapped_fit, tmp_path):
    res = wrapped_fit.results()
    res.compute_lir(thin=11)
    res.compute_peaklambda(thin=11)
    res.compute_loo(thin=11)
    path = str(tmp_path / "sed.h5")
    res.writeToHDF5(path)

    r2 = SEDResults(h5file=path, model=wrapped_fit.model, device="cpu")
    np.testing.assert_array_equal(np.asarray(res.chain, np.float32),
                                  r2.chain.astype(np.float32))
    np.testing.assert_allclose(r2.lir_chain, res.lir_chain)
    np.testing.assert_allclose(r2.peaklambda_chain, res.peaklambda_chain)
    np.testing.assert_allclose(r2.loo_result.elpd_loo,
                               res.loo_result.elpd_loo)
    assert r2.redshift == res.redshift
    assert r2.thin == res.thin
    assert r2.param_spec.fixed.tolist() == res.param_spec.fixed.tolist()
    np.testing.assert_allclose(r2.par_cen("T"), res.par_cen("T"))
    p1 = res.posterior_predictive(thin=17).p_value
    p2 = r2.posterior_predictive(thin=17).p_value
    assert abs(p1 - p2) < 0.05

    r3 = SEDResults(h5file=path, device="cpu")
    np.testing.assert_allclose(r3.par_cen("beta"), res.par_cen("beta"))
    assert r3.free_param_names == ["T", "beta", "fnorm"]
    with pytest.raises(RuntimeError, match="model="):
        r3.compute_lir()
    other = SEDModel(fnu=wrapped_fit.model.fnu, param_names=("x", "y"),
                     lower=[0.0, 0.0], upper=[1.0, 1.0], name="other")
    with pytest.raises(ValueError, match="parameters"):
        SEDResults(h5file=path, model=other, device="cpu")


def test_sed_files_cross_between_the_packages(shared, tmp_path):
    """A port SED file loads in the JAX package's SEDResults (chains,
    summaries, the stored derived chains) and a JAX SED file in the
    port's, with its LOO group."""
    res, jres, _ = shared
    np.testing.assert_allclose(jres.chain, np.asarray(res.chain,
                                                      np.float32))
    np.testing.assert_allclose(jres.par_cen("fnorm"), res.par_cen("fnorm"),
                               rtol=1e-6)
    assert jres.free_param_names == res.free_param_names
    jres.compute_lir(thin=9)
    jres.compute_loo(thin=9)
    path = str(tmp_path / "jax.h5")
    jres.writeToHDF5(path)
    back = SEDResults(h5file=path, model=_mbb_wrapped(SHAPE_THIN),
                      device="cpu")
    np.testing.assert_array_equal(back.lir_chain, jres.lir_chain)
    np.testing.assert_allclose(back.loo_result.elpd_loo,
                               jres.loo_result.elpd_loo)
    assert back.lir_meta["thin"] == 9 and back.redshift == 2.5
    np.testing.assert_allclose(back.compute_lir(thin=9), jres.lir_chain,
                               rtol=1e-4)


def test_mbb_file_refused(tmp_path, shared):
    """An MBB results file is not an SED results file in either package's
    SEDResults, and an SED file is refused by the port's MBBResults."""
    from mbb_emcee_tpu_torch import MBBFitter, MBBResults
    from mbb_emcee_tpu import MBBFitter as JMBBFitter, MBBResults as JMBBRes
    flux, unc = _mock_flux(SHAPE_THIN)
    mfit = MBBFitter(nwalkers=16, opthin=True, noalpha=True, seed=2,
                     device="cpu")
    mfit.set_data(WAVE, flux, unc)
    mfit.run(nburn=10, nsteps=20)
    path = str(tmp_path / "mbb.h5")
    MBBResults(fit=mfit).writeToHDF5(path)
    with pytest.raises(ValueError, match="not an SEDResults file"):
        SEDResults(h5file=path, device="cpu")
    with pytest.raises(ValueError, match="not an SEDResults file"):
        jsed.SEDResults(h5file=path)
    jfit = JMBBFitter(nwalkers=16, opthin=True, noalpha=True, seed=2)
    jfit.set_data(WAVE, flux, unc)
    jfit.run(nburn=10, nsteps=20)
    jpath = str(tmp_path / "jmbb.h5")
    JMBBRes(fit=jfit).writeToHDF5(jpath)
    with pytest.raises(ValueError, match="not an SEDResults file"):
        SEDResults(h5file=jpath, device="cpu")
    with pytest.raises(ValueError, match="SEDResults file"):
        MBBResults(h5file=shared[2], device="cpu")


# -- a genuinely non-MBB model through the full stack -------------------------------------

def test_two_temperature_model_end_to_end(tmp_path):
    """The canonical custom model (two-temperature greybody) recovers its
    truth and flows through derived quantities + persistence + PPC; its fnu
    agrees with the jnp twin."""
    def two_mbb(theta, wave):
        t_c, t_w, beta, f_c, f_w = theta
        p_c = torch.stack([t_c, beta, torch.full_like(t_c, 250.0),
                           torch.full_like(t_c, 4.0), f_c])
        p_w = torch.stack([t_w, beta, torch.full_like(t_c, 250.0),
                           torch.full_like(t_c, 4.0), f_w])
        return (torch.exp(log_mbb_fnu(p_c, wave, SHAPE_THIN))
                + torch.exp(log_mbb_fnu(p_w, wave, SHAPE_THIN)))

    def j_two_mbb(theta, wave):
        js = _jshape(SHAPE_THIN)
        t_c, t_w, beta, f_c, f_w = theta
        p_c = jnp.stack([t_c, beta, 250.0, 4.0, f_c])
        p_w = jnp.stack([t_w, beta, 250.0, 4.0, f_w])
        return (jnp.exp(j_log_mbb_fnu(p_c, wave, js))
                + jnp.exp(j_log_mbb_fnu(p_w, wave, js)))

    model = SEDModel(
        fnu=two_mbb,
        param_names=("T_cold", "T_warm", "beta", "fnorm_cold",
                     "fnorm_warm"),
        lower=[5.0, 25.0, 0.5, 1e-3, 1e-4],
        upper=[25.0, 80.0, 4.0, 1e3, 1e2], name="two-temp")
    true = np.array([20.0, 45.0, 1.8, 30.0, 0.8])
    wave = np.array([60.0, 100.0, 160.0, 250.0, 350.0, 500.0, 850.0,
                     1100.0, 2000.0])
    f = two_mbb(torch.tensor(true, dtype=torch.float32),
                torch.tensor(wave, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(f, np.asarray(j_two_mbb(
        jnp.asarray(true, jnp.float32), jnp.asarray(wave, jnp.float32))),
        rtol=1e-5)
    unc = 0.05 * f
    rng = np.random.default_rng(3)
    fit = SEDFitter(model, nwalkers=64, redshift=2.0, seed=11, device="cpu")
    fit.set_data(wave, f + unc * rng.standard_normal(f.size), unc)
    for n, v in zip(model.param_names, true):
        fit.set_param_init(n, v, 0.1 * abs(v))
    fit.set_gaussian_prior("beta", 1.8, 0.5)
    fit.run(nburn=60, nsteps=150)
    res = fit.results()
    for name, v in zip(model.param_names, true):
        c = res.par_cen(name)
        assert abs(c[0] - v) < 6 * max(c[1], c[2]), (name, c, v)
    assert 0.01 < res.posterior_predictive(thin=5).p_value < 0.99
    lir = res.lir_cen()
    assert lir[0] > 0 and np.isfinite(lir).all()
    pk = res.peaklambda_cen()
    assert 40.0 < pk[0] < 400.0
    path = str(tmp_path / "twotemp.h5")
    res.writeToHDF5(path)
    r2 = SEDResults(h5file=path, model=model, device="cpu")
    np.testing.assert_allclose(r2.par_cen("T_warm"), res.par_cen("T_warm"))


def test_plot_hooks(wrapped_fit):
    """Each plot hook of SEDResults draws its figure (plot_pz of any
    sampled parameter)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    res = wrapped_fit.results()
    for hook, kw in ((res.plot_sed, {}), (res.plot_corner, {}),
                     (res.plot_chain, {}), (res.plot_ppc, {"thin": 8}),
                     (res.plot_pz, {"param": "T"})):
        fig = hook(**kw)
        assert fig.axes
        matplotlib.pyplot.close(fig)
