"""The port's generic batch tier (sedmulti.SEDMultiFitter) against the JAX
package's on the CPU: the model is written twice, in jnp and in torch, and
the same numpy inputs made from a seed go through both. The per-source
lnprob under upper limits, missing bands, per-source priors, correlated
whitening and a response pack; half-steps replayed from shared uniforms;
the wrapped 5-parameter MBB against MultiFitter's plain multi run on the
same Philox streams; posteriors against the JAX SEDMultiFitter's; extend
and checkpoint-resume bitwise; run(init="map"); the per-source SEDResults
view against a single SEDFitter; sed-batch files both ways; the photo-z
catalog's derived posteriors; then twins of tests/test_sedmulti.py's
guards. PT, HMC and the batch evidence against the JAX package's are in
the slow lane, as their JAX twins are; tier-1 runs each once, small."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu import sed as jsed  # noqa: E402
from mbb_emcee_tpu import sedmulti as jsedmulti  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape, log_mbb_fnu as j_log_mbb_fnu)
from mbb_emcee_tpu_torch import MultiFitter, SEDFitter  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    DEFAULT_LOWER, DEFAULT_UPPER)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu)
from mbb_emcee_tpu_torch.response import ResponseSet  # noqa: E402
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    MultiSamplerState, autocorrelation_time, multi_stretch_run_plain)
from mbb_emcee_tpu_torch.sed import SEDModel  # noqa: E402
from mbb_emcee_tpu_torch.sedmulti import SEDMultiFitter  # noqa: E402

# the port's lnprob tolerance (tests/test_torch_lnprob.py)
RTOL, ATOL = 1e-5, 1e-4

SHAPE = MBBShape(opthin=True, noalpha=True)
JSHAPE = JShape(opthin=True, noalpha=True)
WAVE = np.array([60.0, 100.0, 160.0, 250.0, 350.0, 500.0, 850.0,
                 1100.0, 2000.0])
NAMES = ("T_cold", "T_warm", "beta", "fnorm_cold", "fnorm_warm")
INIT = np.array([18.0, 45.0, 1.8, 30.0, 1.0])
LOWER = [5.0, 25.0, 0.5, 1e-3, 1e-4]
UPPER = [25.0, 80.0, 4.0, 1e3, 1e2]


def _two_mbb(theta, wave):
    t_c, t_w, beta, f_c, f_w = theta
    pin = [torch.full_like(t_c, 250.0), torch.full_like(t_c, 4.0)]
    p_c = torch.stack([t_c, beta, *pin, f_c])
    p_w = torch.stack([t_w, beta, *pin, f_w])
    return (torch.exp(log_mbb_fnu(p_c, wave, SHAPE))
            + torch.exp(log_mbb_fnu(p_w, wave, SHAPE)))


def _j_two_mbb(theta, wave):
    t_c, t_w, beta, f_c, f_w = theta
    p_c = jnp.stack([t_c, beta, 250.0, 4.0, f_c])
    p_w = jnp.stack([t_w, beta, 250.0, 4.0, f_w])
    return (jnp.exp(j_log_mbb_fnu(p_c, wave, JSHAPE))
            + jnp.exp(j_log_mbb_fnu(p_w, wave, JSHAPE)))


MODEL = SEDModel(fnu=_two_mbb, param_names=NAMES, lower=LOWER, upper=UPPER,
                 name="two-temp")
J_MODEL = jsed.SEDModel(fnu=_j_two_mbb, param_names=NAMES, lower=LOWER,
                        upper=UPPER, name="two-temp")


def _mock_batch(S=8, seed=5, frac=0.05):
    rng = np.random.default_rng(seed)
    truths = np.column_stack([
        rng.uniform(15, 22, S), rng.uniform(35, 55, S), np.full(S, 1.8),
        rng.uniform(10, 60, S), rng.uniform(0.3, 2.0, S)])
    f = torch.func.vmap(_two_mbb, in_dims=(0, None))(
        torch.as_tensor(truths, dtype=torch.float32),
        torch.as_tensor(WAVE, dtype=torch.float32)).double().numpy()
    unc = frac * f
    return truths, f + unc * rng.standard_normal(f.shape), unc


def _setup(mf, flux, unc, **kw):
    mf.set_data(WAVE, flux, unc, **kw)
    for n, v in zip(NAMES, INIT):
        mf.set_param_init(n, v, 0.15 * abs(v))
    mf.set_gaussian_prior("beta", 1.8, 0.4)
    return mf


def _fitter(flux, unc, seed=7, nwalkers=48, **kw):
    return _setup(SEDMultiFitter(MODEL, nwalkers=nwalkers, seed=seed,
                                 device="cpu"), flux, unc, **kw)


def _j_fitter(flux, unc, seed=7, nwalkers=48, **kw):
    return _setup(jsedmulti.SEDMultiFitter(J_MODEL, nwalkers=nwalkers,
                                           seed=seed), flux, unc, **kw)


def _random_corr(nb, seed=7, strength=0.4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, nb))
    C = A @ A.T + nb * np.eye(nb)
    d = np.sqrt(np.diag(C))
    return (1 - strength) * np.eye(nb) + strength * C / np.outer(d, d)


def _mc_se(chain):
    """Per-free-parameter standard error of the median of one source's
    (nrec, nwalkers, nfree) chain from its autocorrelation time."""
    chain = np.asarray(chain, np.float64)
    flat = chain.reshape(-1, chain.shape[-1])
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain), nan=1.0),
                     1.0)
    return 1.2533 * flat.std(axis=0) / np.sqrt(flat.shape[0] / tau)


# -- the per-source lnprob against the JAX package's --------------------------

LNP_MODES = ["shared-uplim", "ps-uplim", "missing+ps-prior", "correlated",
             "correlated+ps-prior", "response"]


def _configure(mode, mf, S):
    if mode == "shared-uplim":
        mf.set_phot_upperlimits([False] * (WAVE.size - 1) + [True])
    if mode == "ps-uplim":
        m = np.zeros((S, WAVE.size), bool)
        m[0, -1] = m[2, 0] = True
        mf.set_phot_upperlimits(m)
    if mode.startswith("correlated"):
        mf.set_band_correlation(_random_corr(WAVE.size))
    if mode.endswith("ps-prior"):
        mf.set_gaussian_prior("T_warm", np.array([40.0, 45.0, 0.0]),
                              np.array([4.0, 5.0, np.inf]))
    if mode == "response":
        rs = mf._response_set_cls()
        for n, w in zip(mf.band_names, WAVE):
            rs.add(n, f"box:{w}:{0.2 * w}:17")
        mf.set_responses(rs)
    return mf


@pytest.mark.parametrize("mode", LNP_MODES)
def test_lnprob_matches_jax(mode):
    """The batch likelihood, (S, n, nfree) -> (S, n), against the JAX
    SEDMultiFitter's per-source function vmapped over sources and walkers
    on its own operands, 3 sources (source 1 misses band 3): shared and
    per-source upper limits, per-source priors, the correlated whitening
    (also with per-source priors) and a response pack. RTOL/ATOL."""
    truths, flux, unc = _mock_batch(S=3, seed=9)
    flux[1, 3] = np.nan
    kw = {}
    if mode == "response":
        kw["band_names"] = [f"b{i}" for i in range(WAVE.size)]
    mf = _fitter(flux, unc, **kw)
    jmf = _j_fitter(flux, unc, **kw)
    from mbb_emcee_tpu.response import ResponseSet as JResponseSet
    mf._response_set_cls, jmf._response_set_cls = ResponseSet, JResponseSet
    _configure(mode, mf, 3)
    _configure(mode, jmf, 3)
    ops = mf._lnprob_operands(mf._effective_spec())
    j_fn, fs = jmf._build_lnprob_data(jmf._effective_spec())
    assert np.array_equal(fs.free_idx, ops.free_space.free_idx)
    flux_op, aux_op = jmf._data_operands(fs)
    rng = np.random.default_rng(5)
    x = (INIT[fs.free_idx][None, None] * rng.uniform(
        0.85, 1.15, (3, 12, fs.nfree))).astype(np.float32)
    x[0, 0, 0] = 30.0                           # out of the box: the floor
    got = ops.plain(torch.as_tensor(x)).numpy()
    w32 = jnp.asarray(WAVE, jnp.float32)
    want = jax.vmap(lambda xs, fl, ax: jax.vmap(
        lambda th: j_fn(th, w32, fl, ax))(xs))(jnp.asarray(x), flux_op,
                                               aux_op)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_half_steps_replay_jax():
    """2 sources x 32 walkers, 2 records x thin 2 of stretch half-steps of
    the batch likelihood (per-source priors, a missing band) on shared
    uniforms against the JAX package's stretch_half_step_from_uniforms on
    its per-source likelihood: chain and lnp at rtol 2e-5, accept counts
    equal."""
    truths, flux, unc = _mock_batch(S=2, seed=13)
    flux[0, 2] = np.nan
    mf, jmf = _fitter(flux, unc), _j_fitter(flux, unc)
    for f in (mf, jmf):
        f.set_gaussian_prior("T_warm", np.array([44.0, 0.0]),
                             np.array([3.0, np.inf]))
    ops = mf._lnprob_operands(mf._effective_spec())
    j_fn, fs = jmf._build_lnprob_data(jmf._effective_spec())
    flux_op, aux_op = jmf._data_operands(fs)
    w32 = jnp.asarray(WAVE, jnp.float32)
    rng = np.random.default_rng(11)
    S, nw, nrec, thin = 2, 32, 2, 2
    half = nw // 2
    p0 = (truths[:, None, :] * (1.0 + 0.03 * rng.standard_normal(
        (S, nw, 5)))).astype(np.float32)
    u = rng.uniform(0.001, 0.999, (S, nrec, 6 * thin, half)).astype(
        np.float32)
    want, want_lnp, nacc = [], [], np.zeros((S, nw), np.int64)
    for s in range(S):
        batch = jax.jit(jax.vmap(lambda th, s=s: j_fn(th, w32, flux_op[s],
                                                      aux_op[s])))
        pos_a, pos_b = jnp.asarray(p0[s, :half]), jnp.asarray(p0[s, half:])
        lnp = batch(jnp.asarray(p0[s]))
        lnp_a, lnp_b = lnp[:half], lnp[half:]
        rec, rec_l = [], []
        for r in range(nrec):
            for t in range(thin):
                ur = u[s, r, 6 * t:6 * t + 6]
                pos_a, lnp_a, ok_a = jsampler.stretch_half_step_from_uniforms(
                    jnp.asarray(ur[0:3]), pos_a, pos_b, lnp_a, batch)
                pos_b, lnp_b, ok_b = jsampler.stretch_half_step_from_uniforms(
                    jnp.asarray(ur[3:6]), pos_b, pos_a, lnp_b, batch)
                nacc[s] += np.concatenate([np.asarray(ok_a),
                                           np.asarray(ok_b)])
            rec.append(np.concatenate([np.asarray(pos_a),
                                       np.asarray(pos_b)]))
            rec_l.append(np.concatenate([np.asarray(lnp_a),
                                         np.asarray(lnp_b)]))
        want.append(rec)
        want_lnp.append(rec_l)
    state = MultiSamplerState(
        pos=torch.as_tensor(p0), lnp=torch.zeros(S, nw),
        naccept=torch.zeros(S, nw, dtype=torch.int32), nsteps=0, seed=1)
    state, chain, lnpc = multi_stretch_run_plain(
        state, ops.plain, nrec, thin, uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(chain.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lnpc.numpy(), np.asarray(want_lnp),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(state.naccept.numpy(), nacc)


# -- the wrapped 5-parameter MBB against MultiFitter's plain multi run ---------

def _mbb_wrapped():
    shape = MBBShape()

    def fnu(theta, wave):
        return torch.exp(log_mbb_fnu(theta, wave, shape))
    return SEDModel(fnu=fnu, param_names=("T", "beta", "lambda0", "alpha",
                                          "fnorm"),
                    lower=DEFAULT_LOWER, upper=DEFAULT_UPPER,
                    name="mbb-wrapped")


@pytest.mark.parametrize("extra", ["missing+uplim", "correlated"])
def test_wrapped_mbb_matches_multifitter_plain_run(extra):
    """The 5-parameter MBB as a user model through SEDMultiFitter against
    MultiFitter(sampler_backend="torch") on the same 4 sources (one
    missing band), box, init and seed: both draw the same walker balls and
    the same per-source Philox streams, so run(20, 40)'s chains agree to
    rtol 1e-6 / atol 1e-6 (the two likelihoods are the same formulas; an
    accept decision flipped by rounding would part them by far more)."""
    from mbb_emcee_tpu_torch.models.modified_blackbody import mbb_fnu
    wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
    rng = np.random.default_rng(3)
    truth = np.array([30.0, 1.8, 250.0, 3.5, 40.0])
    th = truth[None] * rng.uniform(0.9, 1.1, (4, 5))
    f = mbb_fnu(torch.tensor(th, dtype=torch.float32),
                torch.tensor(wave, dtype=torch.float32),
                MBBShape()).double().numpy()
    unc = 0.05 * f
    flux = f + unc * rng.standard_normal(f.shape)
    flux[1, 0] = np.nan
    sca = np.array([3.0, 0.3, 50.0, 0.8, 5.0])

    def setup(mf):
        mf.set_data(wave, flux, unc)
        for i in range(5):
            mf.set_param_init(i, truth[i], sca[i])
        mf.set_gaussian_prior("beta", 1.8, 0.4)
        if extra == "missing+uplim":
            m = np.zeros((4, 5), bool)
            m[2, 4] = True
            mf.set_phot_upperlimits(m)
        else:
            mf.set_band_correlation(_random_corr(5, strength=0.3))
        return mf.run(nburn=20, nsteps=40)

    a = setup(SEDMultiFitter(_mbb_wrapped(), nwalkers=32, seed=5,
                             device="cpu"))
    b = setup(MultiFitter(nwalkers=32, seed=5, device="cpu",
                          sampler_backend="torch"))
    np.testing.assert_allclose(a.chain_free.numpy(), b.chain_free.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a.lnprobability.numpy(),
                               b.lnprobability.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)
    assert a._backend_used == "torch"


# -- posteriors, views and derived quantities on one batch fit ----------------

@pytest.fixture(scope="module")
def batch_fit():
    truths, flux, unc = _mock_batch(S=4)
    flux = flux.copy()
    flux[0, 3] = np.nan          # a missing band in a ragged catalog
    mf = _fitter(flux, unc, redshifts=np.full(4, 2.0))
    mf.run(nburn=100, nsteps=240)
    return truths, mf


def test_batch_recovers_truths(batch_fit):
    truths, mf = batch_fit
    assert mf.chain.shape == (4, 48, 240, 5)
    for j, name in [(0, "T_cold"), (1, "T_warm"), (3, "fnorm_cold")]:
        cen = mf.par_cen(name)
        sig = np.maximum(np.maximum(cen[:, 1], cen[:, 2]), 1e-6)
        assert np.all(np.abs(cen[:, 0] - truths[:, j]) < 6 * sig), name
    assert 0.2 < mf.acceptance_fraction.mean() < 0.8
    assert mf.free_param_names == list(NAMES)
    best, blnp = mf.best_fit()
    assert best.shape == (4, 5) and np.isfinite(blnp).all()
    assert mf.gelman_rubin().shape == (4, 5)
    assert np.all(mf.autocorrelation_time() > 0)
    assert mf.converged(rhat_max=10.0).all()
    assert "4 sources x 48 walkers" in repr(mf)


def _thin_models():
    """(port, JAX) twins of the optically thin greybody with alpha and
    lambda0 pinned: T, beta and fnorm free, a well-identified posterior."""
    def fnu(th, w):
        p = torch.stack([th[0], th[1], torch.full_like(th[0], 250.0),
                         torch.full_like(th[0], 4.0), th[2]])
        return torch.exp(log_mbb_fnu(p, w, SHAPE))

    def jfnu(th, w):
        return jnp.exp(j_log_mbb_fnu(jnp.stack([th[0], th[1], 250.0, 4.0,
                                                th[2]]), w, JSHAPE))
    kw = dict(param_names=("T", "beta", "fnorm"), lower=[5.0, 0.5, 1.0],
              upper=[80.0, 4.0, 200.0], name="thin-greybody")
    return SEDModel(fnu=fnu, **kw), jsed.SEDModel(fnu=jfnu, **kw)


def test_posterior_matches_jax():
    """A 4-source catalog of the thin greybody (one source missing a band,
    a beta prior) through run(100, 300) of both packages' SEDMultiFitter:
    per-source medians within max(1%, 3 sigma_MC) (both chains'
    autocorrelation times; other random streams, not bitwise)."""
    tm, jm = _thin_models()
    wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0, 850.0])
    rng = np.random.default_rng(21)
    truths = np.column_stack([rng.uniform(20, 40, 4), np.full(4, 1.8),
                              rng.uniform(20, 60, 4)])
    f = torch.func.vmap(tm.fnu, in_dims=(0, None))(
        torch.as_tensor(truths, dtype=torch.float32),
        torch.as_tensor(wave, dtype=torch.float32)).double().numpy()
    unc = 0.06 * f
    flux = f + unc * rng.standard_normal(f.shape)
    flux[2, 0] = np.nan
    fits = []
    for mf in (SEDMultiFitter(tm, nwalkers=48, seed=7, device="cpu"),
               jsedmulti.SEDMultiFitter(jm, nwalkers=48, seed=7)):
        mf.set_data(wave, flux, unc)
        for n, v in zip(tm.param_names, (30.0, 1.8, 40.0)):
            mf.set_param_init(n, v, 0.1 * v)
        mf.set_gaussian_prior("beta", 1.8, 0.3)
        fits.append(mf.run(nburn=100, nsteps=300))
    a = fits[0].chain_free.double().numpy()
    b = np.asarray(fits[1].chain_free, np.float64)
    for s in range(4):
        ma = np.median(a[s].reshape(-1, 3), axis=0)
        mb = np.median(b[s].reshape(-1, 3), axis=0)
        tol = np.maximum(0.01 * np.abs(mb),
                         3.0 * np.hypot(_mc_se(a[s]), _mc_se(b[s])))
        assert np.all(np.abs(ma - mb) <= tol), (s, ma, mb, tol)


def test_results_view_matches_single_sedfitter(batch_fit, tmp_path):
    """results(i): a full SEDResults for one source whose summaries match
    the batch reductions, and whose posterior agrees with a single
    SEDFitter on the same data (other random streams: within 0.6 of the
    68% width, tests/test_sedmulti.py's bound); the ragged source's
    missing band is excluded from its PPC; an SED file of the view
    reloads."""
    from mbb_emcee_tpu_torch.sed import SEDResults
    truths, mf = batch_fit
    s = 3
    res = mf.results(s)
    assert res.redshift == 2.0
    np.testing.assert_allclose(res.par_cen("T_warm"),
                               mf.par_cen("T_warm")[s], rtol=1e-6)
    b_best, b_lnp = mf.best_fit()
    r_best, r_lnp = res.best_fit
    np.testing.assert_allclose(r_best, b_best[s], rtol=1e-5)
    assert abs(r_lnp - b_lnp[s]) < 1e-3
    fit = SEDFitter(MODEL, nwalkers=48, seed=101, device="cpu")
    fit.set_data(WAVE, mf.flux[s], mf.unc[s])
    for n, v in zip(NAMES, INIT):
        fit.set_param_init(n, v, 0.15 * abs(v))
    fit.set_gaussian_prior("beta", 1.8, 0.4)
    fit.run(nburn=100, nsteps=240)
    single = fit.results()
    for name in ("T_cold", "T_warm", "fnorm_cold"):
        c_b, c_s = res.par_cen(name), single.par_cen(name)
        assert abs(c_b[0] - c_s[0]) < 0.6 * (c_s[1] + c_s[2]), name
    ppc0 = mf.results(0).posterior_predictive(thin=8)
    assert ppc0.ndata == WAVE.size - 1 and np.isnan(ppc0.band_p[3])
    path = str(tmp_path / "src3.h5")
    res.writeToHDF5(path)
    back = SEDResults(h5file=path, model=MODEL, device="cpu")
    np.testing.assert_allclose(back.par_cen("T_cold"), res.par_cen("T_cold"))
    with pytest.raises(IndexError, match="out of range"):
        mf.results(99)


@pytest.fixture(scope="module")
def shared(batch_fit, tmp_path_factory):
    """(port fitter, JAX fitter) on one chain: the port's sed-batch file
    read by the JAX package."""
    truths, mf = batch_fit
    path = str(tmp_path_factory.mktemp("sedbatch") / "shared.h5")
    mf.writeToHDF5(path)
    return mf, jsedmulti.SEDMultiFitter.from_h5(path, J_MODEL), path


def test_derived_match_jax_on_a_shared_chain(shared):
    """compute_lir (rtol 1e-4), compute_peaklambda (rtol 2e-3, the
    packages' fp32 golden-section plateau) and sed_percentiles (rtol 1e-5)
    against the JAX SEDMultiFitter's on the same chain."""
    mf, jmf, _ = shared
    np.testing.assert_allclose(mf.compute_lir(thin=16),
                               jmf.compute_lir(thin=16), rtol=1e-4)
    np.testing.assert_allclose(mf.compute_peaklambda(thin=16),
                               jmf.compute_peaklambda(thin=16), rtol=2e-3)
    grid = np.geomspace(50.0, 2000.0, 12)
    np.testing.assert_allclose(mf.sed_percentiles(grid, thin=16),
                               jmf.sed_percentiles(grid, thin=16), rtol=1e-5)
    assert mf.lir_cen().shape == (4, 3)
    assert mf.peaklambda_cen().shape == (4, 3)


def test_ppc_and_loo_match_jax_on_a_shared_chain(shared):
    """The batch PPC's observed chi-square (rtol 1e-4; the replicated side
    draws from each package's own generator) and PSIS-LOO's pointwise
    elpd (rtol 1e-4) against the JAX package's on the same chain; the
    missing band is excluded on both."""
    mf, jmf, _ = shared
    ppc, jppc = (f.posterior_predictive(thin=6) for f in (mf, jmf))
    np.testing.assert_allclose(ppc.chi2_obs, jppc.chi2_obs, rtol=1e-4)
    np.testing.assert_array_equal(ppc.excluded, jppc.excluded)
    assert np.isnan(ppc.band_p[0, 3]) and ppc.ndata[0] == WAVE.size - 1
    loo, jloo = mf.compute_loo(thin=6), jmf.compute_loo(thin=6)
    np.testing.assert_allclose(loo.elpd_loo, jloo.elpd_loo, rtol=1e-4)


def test_reweight_batch_matches_jax_on_a_shared_chain(shared):
    """reweight_prior_batch resolves the model's own parameter names and
    folds a per-source prior into the old prior as the JAX package does:
    weights, ESS and reweighted summaries on the same chain (rtol 1e-9,
    both host fp64)."""
    from mbb_emcee_tpu.reweight import reweight_prior_batch as j_rw
    from mbb_emcee_tpu_torch.reweight import reweight_prior_batch
    mf, jmf, _ = shared
    for fit in (mf, jmf):
        fit.set_gaussian_prior("T_warm", np.array([40.0, 45.0, 50.0, 42.0]),
                               np.array([5.0, 5.0, np.inf, 5.0]))
    try:
        got = reweight_prior_batch(mf, "T_warm", 44.0, 6.0, thin=4)
        want = j_rw(jmf, "T_warm", 44.0, 6.0, thin=4)
    finally:
        for fit in (mf, jmf):
            fit.set_gaussian_prior("T_warm", np.zeros(4),
                                   np.full(4, np.inf))
    np.testing.assert_allclose(got.logw, want.logw, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.ess, want.ess, rtol=1e-9)
    for name in ("T_warm", "fnorm_cold"):
        np.testing.assert_allclose(got.par_cen(name), want.par_cen(name),
                                   rtol=1e-9)


def test_sedbatch_files_cross_between_the_packages(shared, tmp_path):
    """The port's sed-batch file loads in the JAX package (chains,
    summaries, redshifts, the L_IR chain; the JAX package will not continue
    the port's Philox streams) and the JAX package's file loads here
    (chains, per-source priors, band correlation, the LOO group; extend()
    refuses the JAX generator by name); a port file reloaded here extends
    bitwise as the fitter that wrote it."""
    mf, jmf, path = shared
    np.testing.assert_array_equal(np.asarray(jmf.chain_free),
                                  mf.chain_free.numpy())
    # the JAX package interpolates its percentiles in fp32
    np.testing.assert_allclose(jmf.par_cen("T_warm"), mf.par_cen("T_warm"),
                               rtol=1e-5)
    assert jmf.redshifts is not None and jmf.prng_impl == "philox4x32_10"
    with pytest.raises(RuntimeError, match="prior run"):
        jmf.extend(4)
    # the JAX package's file, with per-source priors, a band correlation
    # and a LOO group
    truths, flux, unc = _mock_batch(S=2, seed=17)
    j2 = _j_fitter(flux, unc, nwalkers=16)
    j2.set_gaussian_prior("T_warm", np.array([44.0, 0.0]),
                          np.array([2.0, np.inf]))
    j2.set_band_correlation(_random_corr(WAVE.size, strength=0.2))
    j2.run(nburn=10, nsteps=20)
    j2.compute_loo(thin=2)
    jpath = str(tmp_path / "jax.h5")
    j2.writeToHDF5(jpath)
    back = SEDMultiFitter.from_h5(jpath, MODEL, device="cpu")
    np.testing.assert_array_equal(back.chain_free.numpy(),
                                  np.asarray(j2.chain_free))
    np.testing.assert_allclose(back._ps_prior["t_warm"][1],
                               j2._ps_prior["t_warm"][1])
    np.testing.assert_allclose(back._band_corr, j2._band_corr)
    np.testing.assert_allclose(back.loo_result.elpd_loo,
                               j2.loo_result.elpd_loo)
    np.testing.assert_allclose(back.par_cen("T_cold"), j2.par_cen("T_cold"),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="threefry2x32"):
        back.extend(4)
    # a port file reloaded here continues exactly
    p2 = SEDMultiFitter.from_h5(path, MODEL, device="cpu")
    p2.extend(12)
    again = SEDMultiFitter.from_h5(path, MODEL, device="cpu")
    again.extend(12)
    assert torch.equal(p2.chain_free, again.chain_free)
    assert p2.chain_free.shape[1] == 252
    other = SEDModel(fnu=_two_mbb, param_names=("a",) + NAMES[1:],
                     lower=LOWER, upper=UPPER, name="two-temp")
    with pytest.raises(ValueError, match="parameters"):
        SEDMultiFitter.from_h5(path, other, device="cpu")


# -- continuation, checkpoints, MAP ---------------------------------------------

@pytest.mark.parametrize("extra", ["plain", "correlated+ps-prior"])
def test_extend_is_the_longer_run(extra):
    """run(n1) + extend(n2) equals run(n1 + n2) bitwise (the Philox streams
    continue), also with a band correlation and per-source priors."""
    truths, flux, unc = _mock_batch(S=3, seed=11)

    def fresh():
        mf = _fitter(flux, unc, seed=13, nwalkers=24)
        if extra != "plain":
            mf.set_band_correlation(_random_corr(WAVE.size, strength=0.3))
            mf.set_gaussian_prior("T_warm", np.array([50.0, 0.0, 0.0]),
                                  np.array([0.5, np.inf, np.inf]))
        return mf

    whole = fresh().run(nburn=20, nsteps=50)
    split = fresh().run(nburn=20, nsteps=30).extend(20)
    assert torch.equal(whole.chain_free, split.chain_free)
    assert torch.equal(whole.lnprobability, split.lnprobability)
    np.testing.assert_array_equal(whole.acceptance_fraction,
                                  split.acceptance_fraction)


def test_extend_guards():
    truths, flux, unc = _mock_batch(S=2, seed=11)
    mf = _fitter(flux, unc, seed=13, nwalkers=16)
    with pytest.raises(RuntimeError, match="prior stretch-move run"):
        mf.extend(10)
    mf.run(nburn=4, nsteps=8)
    mf.set_gaussian_prior("T_cold", 18.0, 0.1)
    with pytest.raises(RuntimeError, match="changed after run"):
        mf.extend(4)
    mf.set_gaussian_prior("T_cold", 18.0, 0.1)
    mf.run(nburn=4, nsteps=8)
    mf.set_data(WAVE, flux * 1.01, unc)
    with pytest.raises(RuntimeError, match="set_data"):
        mf.extend(4)


def test_checkpoint_resume_bitwise(tmp_path):
    """A checkpointed batch run stopped after its first segment resumes,
    in a fresh fitter, to a chain bitwise the uninterrupted run's; a
    mismatched geometry or posterior is refused."""
    truths, flux, unc = _mock_batch(S=3, seed=71)
    path = str(tmp_path / "ck.h5")
    ref = _fitter(flux, unc, seed=19, nwalkers=24).run(nburn=10, nsteps=40)
    part = _fitter(flux, unc, seed=19, nwalkers=24)
    part.run(nburn=10, nsteps=20, checkpoint=path, checkpoint_interval=10)
    assert part.chain_free.shape[1] == 20
    res = _fitter(flux, unc, seed=19, nwalkers=24)
    res.run(nburn=10, nsteps=40, checkpoint=path, checkpoint_interval=10,
            resume=True)
    assert torch.equal(res.chain_free, ref.chain_free)
    assert torch.equal(res.lnprobability, ref.lnprobability)
    bad = _fitter(flux, unc, seed=19, nwalkers=16)
    with pytest.raises(ValueError, match="geometry"):
        bad.run(nburn=10, nsteps=40, checkpoint=path, resume=True)
    bad2 = _fitter(flux, unc, seed=19, nwalkers=24)
    bad2.set_gaussian_prior("T_cold", 18.0, 0.1)
    with pytest.raises(ValueError, match="spec_fingerprint"):
        bad2.run(nburn=10, nsteps=40, checkpoint=path, resume=True)
    with pytest.raises(ValueError, match="requires checkpoint"):
        bad2.run(nburn=2, nsteps=4, resume=True)


def test_run_map_and_init_map():
    """run_map lands near the cold component's truth, map_importance gives
    weighted summaries, run(init="map") seeds the MCMC there; a changed
    posterior or a missing run_map is refused (twin of
    tests/test_sedmulti.py::test_run_map_and_importance)."""
    truths, flux, unc = _mock_batch(S=2, seed=41)
    mf = _fitter(flux, unc, seed=43, nwalkers=16)
    mf.run_map(nstarts=4, n_adam=80, n_newton=8)
    assert mf.map_params.shape == (2, 5)
    assert np.all(np.abs(mf.map_params[:, 0] - truths[:, 0]) < 3.0)
    ess = mf.map_importance(nsamples=128)
    assert ess.shape == (2,) and np.all(ess >= 0)
    assert mf.map_par_cen("T_cold").shape == (2, 3)
    assert mf.map_cen("T_warm").shape == (2, 2)
    mf.run(nburn=10, nsteps=20, init="map")
    assert mf.chain_free.shape[1] == 20
    cen = mf.par_cen("T_cold")
    assert np.all(np.abs(cen[:, 0] - truths[:, 0])
                  < 6 * np.maximum(cen[:, 1] + cen[:, 2], 0.3))
    mf.set_gaussian_prior("T_cold", 18.0, 0.5)
    with pytest.raises(RuntimeError, match="re-run run_map"):
        mf.run(nburn=2, nsteps=2, init="map")
    with pytest.raises(RuntimeError, match="re-run run_map"):
        mf.map_importance(nsamples=16)
    with pytest.raises(RuntimeError, match="run_map"):
        _fitter(flux, unc, nwalkers=16).run(nburn=2, nsteps=2, init="map")


# -- the inference tiers -----------------------------------------------------------

def test_tiers_run_small():
    """run_pt, run_hmc and compute_evidence through the engine on a ragged,
    correlated catalog with per-source priors, small: finite, with run()'s
    shapes; PT / HMC chains are not continuable; the per-source views
    carry the evidence."""
    truths, flux, unc = _mock_batch(S=2, seed=41)
    flux[1, 5] = np.nan

    def fresh():
        mf = _fitter(flux, unc, seed=19, nwalkers=16)
        mf.set_band_correlation(_random_corr(WAVE.size, strength=0.3))
        mf.set_gaussian_prior("T_warm", np.array([44.0, 0.0]),
                              np.array([3.0, np.inf]))
        return mf

    pt = fresh().run_pt(nrungs=4, nburn=8, nsteps=12)
    assert pt.chain.shape == (2, 16, 12, 5)
    assert np.all(np.isfinite(pt.logz_pt[0]))
    with pytest.raises(RuntimeError, match="prior stretch-move run"):
        pt.extend(4)
    hmc = fresh().run_hmc(nwarmup=8, nsteps=8, n_leapfrog=4)
    assert hmc.chain.shape == (2, 16, 8, 5)
    assert np.all(np.isfinite(hmc.lnprobability.numpy()))
    ev = fresh().compute_evidence(nlive=32, nbatch=8, nsteps=4, max_iter=60)
    assert ev.logz.shape == (2,) and np.all(np.isfinite(ev.logz))
    assert ev.samples.shape[-1] == 5


@pytest.mark.slow
def test_batch_evidence_matches_jax():
    """Per-source lnZ of the batch evidence against the JAX
    SEDMultiFitter's same call (nested sampling draws other streams):
    within 4 combined sigma + 0.5 (tests/test_sedmulti.py's bound), on the
    thin greybody's well-identified posterior (the two-temperature model's
    lnZ scatters by several nats from seed to seed in both packages at this
    depth)."""
    tm, jm = _thin_models()
    wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0, 850.0])
    rng = np.random.default_rng(81)
    truths = np.column_stack([rng.uniform(20, 40, 3), np.full(3, 1.8),
                              rng.uniform(20, 60, 3)])
    f = torch.func.vmap(tm.fnu, in_dims=(0, None))(
        torch.as_tensor(truths, dtype=torch.float32),
        torch.as_tensor(wave, dtype=torch.float32)).double().numpy()
    unc = 0.06 * f
    flux = f + unc * rng.standard_normal(f.shape)
    evs = []
    for mf in (SEDMultiFitter(tm, nwalkers=16, seed=3, device="cpu"),
               jsedmulti.SEDMultiFitter(jm, nwalkers=16, seed=3)):
        mf.set_data(wave, flux, unc)
        mf.set_gaussian_prior("beta", 1.8, 0.3)
        evs.append(mf.compute_evidence(nlive=96, nbatch=8, nsteps=10,
                                       max_iter=800, seed=11))
    ev, jev = evs
    tol = 4.0 * np.hypot(ev.logz_err, jev.logz_err) + 0.5
    assert np.all(np.abs(ev.logz - jev.logz) < tol), (ev.logz, jev.logz)


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["pt", "hmc"])
def test_tier_posteriors_match_jax(tier):
    """run_pt's cold chain and run_hmc against the JAX SEDMultiFitter's same
    call: per-source medians within 0.9 of the 68% width
    (tests/test_sedmulti.py's bound between tiers)."""
    truths, flux, unc = _mock_batch(S=3, seed=95)
    kw = (dict(nrungs=8, nburn=200, nsteps=500) if tier == "pt"
          else dict(nwarmup=200, nsteps=300))
    name = "run_pt" if tier == "pt" else "run_hmc"
    a = getattr(_fitter(flux, unc, seed=31, nwalkers=32), name)(**kw)
    b = getattr(_j_fitter(flux, unc, seed=31, nwalkers=32), name)(**kw)
    for p in ("T_cold", "T_warm", "fnorm_cold"):
        ca, cb = a.par_cen(p), b.par_cen(p)
        width = cb[:, 1] + cb[:, 2]
        assert np.all(np.abs(ca[:, 0] - cb[:, 0]) < 0.9 * width), p


# -- the photo-z catalog ---------------------------------------------------------

def test_photoz_catalog_matches_jax(tmp_path):
    """A 3-source photo-z catalog (photoz_mbb with a T prior): the
    z-marginalized compute_lir(z_param="z") and compute_dustmass_batch
    against the JAX package's on the same chain (rtol 1e-4), the
    redshifts= / lumdists= conflicts, and an N(z) population over the
    sampled z through HierarchicalFitter.fit_population."""
    from mbb_emcee_tpu import photoz as jphotoz
    from mbb_emcee_tpu_torch.hierarchy import fit_population
    from mbb_emcee_tpu_torch.photoz import (
        compute_dustmass_batch, photoz_mbb)
    model = photoz_mbb(cmb=True, z_upper=8.0)
    zs = np.array([2.0, 3.5, 5.0])
    rng = np.random.default_rng(12)
    wave = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
    flux = np.empty((3, wave.size))
    for s, z0 in enumerate(zs):
        t = torch.tensor([38.0, 1.9, 80.0, 3.0, 10.0, z0])
        flux[s] = model.fnu(t, torch.tensor(wave, dtype=torch.float32)
                            ).double().numpy() * (
            1.0 + 0.05 * rng.standard_normal(wave.size))
    mf = SEDMultiFitter(model, nwalkers=16, seed=12, device="cpu")
    mf.set_data(wave, flux, 0.07 * flux)
    mf.set_gaussian_prior("T", 38.0, 6.0)
    mf.fix_param("alpha", 3.0)
    for nm, v in zip(model.param_names, [38.0, 1.9, 80.0, 3.0, 10.0, 3.0]):
        mf.set_param_init(nm, v, 0.1 * abs(v))
    mf.run(nburn=15, nsteps=30)
    lir = mf.compute_lir(z_param="z", thin=2)
    dm = compute_dustmass_batch(mf, thin=2)
    assert lir.shape == dm.shape == (3, 240)
    assert np.all(lir > 0) and np.all(dm > 0)
    with pytest.raises(ValueError, match="z_param"):
        mf.compute_lir(z_param="z", redshifts=zs)
    with pytest.raises(ValueError, match="z_param"):
        mf.compute_lir(z_param="z", lumdists=np.ones(3))
    path = str(tmp_path / "pz.h5")
    mf.writeToHDF5(path)
    jmf = jsedmulti.SEDMultiFitter.from_h5(
        path, jphotoz.photoz_mbb(cmb=True, z_upper=8.0))
    np.testing.assert_allclose(lir, jmf.compute_lir(z_param="z", thin=2),
                               rtol=1e-4)
    np.testing.assert_allclose(dm, jphotoz.compute_dustmass_batch(
        jmf, thin=2), rtol=1e-4)
    hf = fit_population(mf, params=("z",), nburn=10, nsteps=20, nwalkers=8,
                        max_samples=64)
    assert hf.chain_free.shape[-1] == 2
    assert np.isfinite(hf.reweight_ess()).all()


# -- twins of tests/test_sedmulti.py's guards -------------------------------------

def test_constructor_and_set_data_validation():
    with pytest.raises(TypeError, match="SEDModel"):
        SEDMultiFitter(object(), device="cpu")
    with pytest.raises(ValueError, match="even"):
        SEDMultiFitter(MODEL, nwalkers=15, device="cpu")
    with pytest.raises(TypeError, match="walker_mesh"):
        SEDMultiFitter(MODEL, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="prng_impl=.*Philox"):
        SEDMultiFitter(MODEL, prng_impl="rbg", device="cpu")
    SEDMultiFitter(MODEL, prng_impl="threefry2x32", device="cpu")
    mf = SEDMultiFitter(MODEL, nwalkers=16, device="cpu")
    with pytest.raises(RuntimeError, match="no data"):
        mf.run(nburn=2, nsteps=2)
    truths, flux, unc = _mock_batch(S=2)
    with pytest.raises(ValueError, match="must be"):
        mf.set_data(WAVE, flux[:, :3], unc)
    bad = flux.copy()
    bad[1, :] = np.nan
    with pytest.raises(ValueError, match="no bands at all"):
        mf.set_data(WAVE, bad, unc)
    u = unc.copy()
    u[0, 0] = 0.0
    with pytest.raises(ValueError, match="positive"):
        mf.set_data(WAVE, flux, u)
    with pytest.raises(ValueError, match="one redshift"):
        mf.set_data(WAVE, flux, unc, redshifts=[1.0])
    with pytest.raises(ValueError, match="nwalkers=4 < 2\\*nfree"):
        _fitter(flux, unc, nwalkers=4).run(nburn=2, nsteps=2)


def test_uplim_masks_and_refusals():
    """Shared and per-source upper-limit masks ride the 1/sigma sign; upper
    limits and a band correlation refuse each other in both orders."""
    truths, flux, unc = _mock_batch(S=4, seed=9)
    mf = _fitter(flux, unc, seed=3, nwalkers=16)
    m = np.zeros((4, WAVE.size), bool)
    m[2, -1] = True
    mf.set_phot_upperlimits(m)
    iunc = mf._iunc_operand()
    assert iunc[2, -1] < 0 and np.all(iunc[[0, 1, 3], -1] > 0)
    mf.set_phot_upperlimits(np.zeros(WAVE.size, bool))
    assert np.all(mf._iunc_operand() > 0)
    with pytest.raises(ValueError, match="upper-limit mask"):
        mf.set_phot_upperlimits(np.zeros(3, bool))
    mf.set_phot_upperlimits([True] + [False] * (WAVE.size - 1))
    with pytest.raises(ValueError, match="upper limits"):
        mf.set_band_correlation(_random_corr(WAVE.size))
    mf2 = _fitter(flux, unc, nwalkers=16)
    mf2.set_band_correlation(_random_corr(WAVE.size))
    with pytest.raises(ValueError, match="correlated"):
        mf2.set_phot_upperlimits([True] + [False] * (WAVE.size - 1))


def test_ps_prior_validation_and_clearing():
    truths, flux, unc = _mock_batch(S=3)
    with pytest.raises(RuntimeError, match="set_data"):
        SEDMultiFitter(MODEL, nwalkers=24, device="cpu").set_gaussian_prior(
            "T_warm", np.zeros(3), np.ones(3))
    mf = _fitter(flux, unc, nwalkers=24)
    mf.set_gaussian_prior("T_warm", np.full(3, 44.0), np.full(3, 5.0))
    mf.fix_param("T_warm", 44.0)
    with pytest.raises(ValueError, match="fixed"):
        mf.run(nburn=2, nsteps=4)
    mf2 = _fitter(flux, unc, nwalkers=24)
    mf2.set_gaussian_prior("T_warm", np.full(3, 44.0), np.full(3, 5.0))
    assert "t_warm" in mf2._ps_prior
    mf2.set_gaussian_prior(NAMES.index("T_warm"), 44.0, 5.0)
    assert "t_warm" not in mf2._ps_prior
    mf3 = _fitter(flux, unc, nwalkers=24)
    mf3.set_gaussian_prior("T_warm", np.full(3, 44.0), np.full(3, 5.0))
    t4, f4, u4 = _mock_batch(S=4)
    mf3.set_data(WAVE, f4, u4)
    with pytest.raises(ValueError, match="sized for"):
        mf3.run(nburn=2, nsteps=4)
    with pytest.raises(ValueError, match="finite"):
        _fitter(flux, unc, nwalkers=24).set_gaussian_prior(
            "T_warm", np.array([np.nan, 1.0, 1.0]), np.full(3, 5.0))


def test_ps_prior_view_folds_the_prior():
    """The per-source SEDResults view reports the posterior its source was
    sampled under: a shared and a per-source Gaussian prior on one
    parameter combine (inverse variances add, means precision-weight)."""
    truths, flux, unc = _mock_batch(S=2, seed=11)
    mf = _fitter(flux, unc, nwalkers=16)
    mf.set_gaussian_prior("T_warm", 40.0, 4.0)
    mf.set_gaussian_prior("beta", np.array([2.0, 0.0]),
                          np.array([0.3, np.inf]))
    mf.run(nburn=4, nsteps=8)
    spec0, spec1 = mf.results(0).param_spec, mf.results(1).param_spec
    ib = NAMES.index("beta")
    v = 0.4 ** -2 + 0.3 ** -2
    np.testing.assert_allclose(spec0.prior_isigma[ib], np.sqrt(v))
    np.testing.assert_allclose(spec0.prior_mean[ib],
                               (1.8 * 0.4 ** -2 + 2.0 * 0.3 ** -2) / v)
    np.testing.assert_allclose(spec1.prior_isigma[ib], 1.0 / 0.4)
    assert spec0.prior_mean[NAMES.index("T_warm")] == 40.0


def _guess_two_mbb(wave, flux, unc):
    w = np.asarray(wave)
    f = np.where(np.isfinite(unc), flux, 0.0)
    t_cold = np.clip(2898.0 / w[np.argmax(f)] * 1.5, 6.0, 24.0)
    f250 = f[np.argmin(np.abs(w - 250.0))]
    return np.array([t_cold, 45.0, np.nan, max(f250, 1e-2),
                     max(0.02 * f250, 1e-3)])


def test_model_guess_matches_jax_and_respects_user_init():
    """SEDModel.guess seeds each source's ball (the JAX package's centers
    and scatters on the same data); an explicit set_param_init wins and a
    NaN guess keeps the default."""
    truths, flux, unc = _mock_batch(S=3, seed=73)
    kw = dict(param_names=NAMES, lower=LOWER, upper=UPPER,
              name="two-temp-guess", guess=_guess_two_mbb)
    mf = SEDMultiFitter(SEDModel(fnu=_two_mbb, **kw), nwalkers=16,
                        device="cpu")
    jmf = jsedmulti.SEDMultiFitter(jsed.SEDModel(fnu=_j_two_mbb, **kw),
                                   nwalkers=16)
    for f in (mf, jmf):
        f.set_data(WAVE, flux, unc)
        f.set_param_init("T_cold", 19.5, 0.5)
    cen, sca = mf._init_centers()
    fs = jsed.build_sed_lnprob_data(jmf.model, jmf._effective_spec())[1]
    jcen, jsca = jmf._engine_init_centers("auto", fs)
    np.testing.assert_allclose(cen[:, fs.free_idx], jcen)
    np.testing.assert_allclose(sca[:, fs.free_idx], jsca)
    np.testing.assert_allclose(cen[:, 0], 19.5)
    np.testing.assert_allclose(cen[:, 2], 0.5 * (0.5 + 4.0))


def test_response_mode_batch_runs():
    """Named bands and response curves flow through the batch likelihood
    and the PPC's band integration; without band names the responses are
    refused."""
    truths, flux, unc = _mock_batch(S=2, seed=31)
    names = [f"b{i}" for i in range(WAVE.size)]
    rs = ResponseSet()
    for n, w in zip(names, WAVE):
        rs.add(n, f"box:{w}:{0.2 * w}:17")
    mf = _fitter(flux, unc, seed=3, nwalkers=16, band_names=names)
    mf.set_responses(rs).run(nburn=4, nsteps=8)
    assert np.isfinite(mf.lnprobability.numpy()).all()
    assert mf.posterior_predictive(thin=4).p_value.shape == (2,)
    bare = _fitter(flux, unc, nwalkers=16).set_responses(rs)
    with pytest.raises(ValueError, match="named photometry bands"):
        bare.run(nburn=2, nsteps=2)


def test_write_persists_run_spec_not_current(batch_fit, tmp_path):
    """writeToHDF5 stores the spec the RUN sampled under: a fix_param()
    between run() and the write must not re-label the reloaded columns."""
    truths, mf = batch_fit
    before = mf.par_cen("T_warm").copy()
    saved = dataclasses.replace(mf._spec)
    mf.fix_param("T_warm", 40.0)
    try:
        path = str(tmp_path / "spec.h5")
        mf.writeToHDF5(path)
        back = SEDMultiFitter.from_h5(path, MODEL, device="cpu")
        assert back.free_space.nfree == mf.free_space.nfree
        np.testing.assert_allclose(back.par_cen("T_warm"), before)
    finally:
        mf._spec = saved
