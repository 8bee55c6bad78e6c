"""BatchEngine hook contract of mbb_emcee_tpu_torch: the twin of
tests/test_batchengine_contract.py.

MultiFitter and SEDMultiFitter are the two shipping adapters over the
port's `batchengine.BatchEngine`; this file writes a THIRD, minimal one --
a 2-parameter straight line with diagonal Gaussian errors on the plain
batch step -- against ONLY the hook surface that batchengine.py's module
docstring documents (_lnprob_operands, _build_sampler, _init_centers,
_band_flux_eval, _model_token, _spec_fingerprint, _response_pack,
_param_names / _param_index), and runs it through the tiers: run, bitwise
extend and its refusal after an edit, segmented checkpoint resume, PT with
a tier checkpoint, HMC, MAP and nested evidence, at the JAX test's seeds,
depths and tolerances. A change to the engine that a third model family
would feel fails here.

The linear-Gaussian toy has an ANALYTIC evidence, so PT's stepping stones
and nested sampling are checked against truth, and against the JAX
package's own LineFitter on the same data.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch.batchengine import (  # noqa: E402
    BatchEngine, PlainBatchOperands)
from mbb_emcee_tpu_torch.checkpoint import data_fingerprint  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    FreeSpace, LikelihoodSpec, LNPROB_FLOOR)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin  # noqa: E402
from mbb_emcee_tpu_torch.sampler import MultiEnsembleSampler  # noqa: E402

X = np.linspace(1.0, 5.0, 8)          # "wavelengths" of the toy bands
TRUE_M, TRUE_B = 2.0, 1.0
LOWER = np.array([-10.0, -20.0])
UPPER = np.array([10.0, 20.0])


class LineFitter(BatchEngine, ParamSpaceMixin):
    """Minimal third adapter: y = m*x + b per source, diagonal Gaussian
    errors, on the CPU. It implements the documented hook surface and
    nothing else: every line here is what a new model family owes the
    engine."""

    _param_names = ("m", "b")

    def __init__(self, nwalkers=16, seed=9, a=2.0):
        self.nwalkers = int(nwalkers)
        self.seed = int(seed)
        self.a = float(a)
        self.device = torch.device("cpu")
        self._spec = LikelihoodSpec.for_box(LOWER, UPPER)
        self._init = np.array([0.0, 0.0])
        self._scatter = np.array([0.5, 1.0])
        self._user_init = np.zeros(2, bool)
        self._user_scatter = np.zeros(2, bool)
        self.wave = self.flux = self.unc = None
        self._band_corr = None
        self.band_names = self.source_names = self.redshifts = None
        self.chain_free = self.lnprobability = None
        self.acceptance_fraction = self.free_space = None
        self.thin = 1
        self.final_state = self._sampler = None
        self.map_params = self.evidence = self.loo_result = None
        self.logz_pt = self.logz_ti = None
        self.swap_fraction = self.pt_betas = None
        self.hmc_step_size = self.hmc_mass = None

    # -- ParamSpaceMixin hooks ------------------------------------------
    def _param_index(self, param):
        if isinstance(param, (int, np.integer)):
            return int(param)
        return self._param_names.index(str(param).lower())

    def _effective_spec(self):
        return self._spec

    # -- engine hooks (the documented contract) -------------------------
    def _engine_label(self):
        return "line"

    def _lnprob_operands(self, spec):
        fs = FreeSpace.from_spec(spec)

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        template, scatter = t32(fs.template), t32(fs.scatter_matrix())
        lo, hi = t32(fs.lower), t32(fs.upper)
        pm, pis = t32(spec.prior_mean), t32(spec.prior_isigma)

        def lnprob(theta_free, wave, flux, iunc):
            theta = template + theta_free @ scatter.T     # (S, n, 2)
            inbox = torch.all((theta_free >= lo) & (theta_free <= hi), -1)
            r = ((theta[..., :1] * wave + theta[..., 1:] - flux[:, None])
                 * iunc[:, None])
            dp = (theta - pm) * pis
            lnp = -0.5 * torch.sum(r * r, -1) - 0.5 * torch.sum(dp * dp, -1)
            return torch.where(inbox, lnp,
                               torch.full_like(lnp, LNPROB_FLOOR))

        return PlainBatchOperands(
            wave=t32(self.wave), data=(t32(self.flux),
                                       t32(self._iunc_operand())),
            fn=lnprob, free_space=fs)

    def _build_sampler(self, spec):
        ops = self._lnprob_operands(spec)
        self._sampler = MultiEnsembleSampler(
            self.nsources, self.nwalkers, ops.free_space.nfree, ops.plain,
            self.a, ops.free_space, self._source0)
        self._backend_used = "torch"
        return self._sampler

    def _init_centers(self, init="auto"):
        if init == "map":
            return self._map_centers()
        S = self.nsources
        return (np.broadcast_to(self._init, (S, 2)).copy(),
                np.broadcast_to(self._scatter, (S, 2)).copy())

    def _band_flux_eval(self):
        wave = torch.as_tensor(self.wave, dtype=torch.float32)

        def fluxes(theta):
            return theta[..., :1] * wave.to(theta.device) + theta[..., 1:]

        return fluxes

    def _model_token(self, spec):
        return ("line", self.wave.tobytes(), self._spec_fingerprint(spec))

    def _spec_fingerprint(self, spec=None):
        spec = self._spec if spec is None else spec
        return data_fingerprint(spec.lower, spec.upper, spec.fixed,
                                spec.fixed_values, spec.prior_mean,
                                spec.prior_isigma, np.asarray([self.a]))

    def _response_pack(self):
        return None


def _make(S=3, seed=0, **kw):
    rng = np.random.default_rng(seed)
    m = TRUE_M + 0.2 * rng.standard_normal(S)
    b = TRUE_B + 0.5 * rng.standard_normal(S)
    y = m[:, None] * X[None, :] + b[:, None]
    unc = 0.1 * np.ones((S, X.size))
    flux = y + unc * rng.standard_normal(y.shape)
    lf = LineFitter(**kw)
    lf.set_data(X, flux, unc)
    return lf, m, b, flux, unc


def _wls(flux_s, unc_s):
    """Exact weighted least squares for one source: (mean, cov)."""
    A = np.stack([X, np.ones_like(X)], axis=1)
    W = np.diag(1.0 / unc_s ** 2)
    cov = np.linalg.inv(A.T @ W @ A)
    mean = cov @ A.T @ W @ flux_s
    return mean, cov


def _analytic_logz(flux_s, unc_s):
    """ln Z of the linear-Gaussian toy against the uniform box prior
    (posterior mass far inside the box -> Laplace is exact)."""
    mean, cov = _wls(flux_s, unc_s)
    r = (mean[0] * X + mean[1] - flux_s) / unc_s
    chi2_min = float(r @ r)
    vol = float(np.prod(UPPER - LOWER))
    return (-0.5 * chi2_min + 0.5 * np.log(np.linalg.det(2 * np.pi * cov))
            - np.log(vol))


def test_run_recovers_wls_posterior():
    lf, m, b, flux, unc = _make()
    lf.run(nburn=150, nsteps=600)
    assert lf.chain_free.shape == (3, 600, 16, 2)
    for s in range(3):
        mean, cov = _wls(flux[s], unc[s])
        flat = lf.chain_free[s].reshape(-1, 2).double().numpy()
        np.testing.assert_allclose(flat.mean(axis=0), mean,
                                   atol=4 * np.sqrt(np.diag(cov)).max())
        np.testing.assert_allclose(flat.std(axis=0), np.sqrt(np.diag(cov)),
                                   rtol=0.25)
    # summary surfaces run off the toy chains too
    cen = lf.par_cen("m")
    assert cen.shape == (3, 3)
    assert np.isfinite(lf.gelman_rubin()).all()


def test_extend_is_bitwise_continuation():
    full, *_ = _make(seed=1)
    full.run(nburn=40, nsteps=40)
    split, *_ = _make(seed=1)
    split.run(nburn=40, nsteps=20)
    split.extend(20)
    assert torch.equal(split.chain_free, full.chain_free)
    # hook contract: posterior edits after run() must refuse extend()
    split.set_uplim("m", 9.0)
    with pytest.raises(RuntimeError, match="changed after run"):
        split.extend(10)


def test_segmented_checkpoint_resume_bitwise(tmp_path):
    ck = str(tmp_path / "line.ck.h5")
    full, *_ = _make(seed=2)
    full.run(nburn=30, nsteps=40)
    part, *_ = _make(seed=2)
    part.run(nburn=30, nsteps=20, checkpoint=ck, checkpoint_interval=10)
    res, *_ = _make(seed=2)
    res.run(nburn=30, nsteps=40, checkpoint=ck, checkpoint_interval=10,
            resume=True)
    assert torch.equal(res.chain_free, full.chain_free)


@functools.lru_cache(maxsize=None)
def _tier_run(tier):
    """The PT (seed 3) and nested (seed 6) runs of the JAX test, made once
    for the analytic check and the comparison with the JAX LineFitter."""
    if tier == "pt":
        lf, m, b, flux, unc = _make(seed=3)
        lf.run_pt(nrungs=10, nburn=150, nsteps=400)
        logz, err = lf.logz_pt
    else:
        lf, m, b, flux, unc = _make(seed=6)
        ev = lf.compute_evidence(nlive=256, nbatch=32, nsteps=24)
        logz, err = ev.logz, ev.logz_err
    return np.asarray(logz, np.float64), np.asarray(err, np.float64), \
        flux, unc


def test_pt_tier_with_checkpoint_resume(tmp_path):
    logz, logz_err, flux, unc = _tier_run("pt")
    for s in range(3):
        want = _analytic_logz(flux[s], unc[s])
        assert abs(float(logz[s]) - want) < max(0.5, 4 * float(
            logz_err[s])), f"source {s}: {float(logz[s])} vs {want}"
    # tier checkpoint: interrupted-and-resumed == uninterrupted, chains
    # AND evidence
    ck = str(tmp_path / "pt.ck.h5")
    a, *_ = _make(seed=3)
    a.run_pt(nrungs=4, nburn=20, nsteps=20, checkpoint=ck,
             checkpoint_interval=20)
    fullpt, *_ = _make(seed=3)
    fullpt.run_pt(nrungs=4, nburn=20, nsteps=40)
    respt, *_ = _make(seed=3)
    respt.run_pt(nrungs=4, nburn=20, nsteps=40, checkpoint=ck,
                 checkpoint_interval=20, resume=True)
    assert torch.equal(respt.chain_free, fullpt.chain_free)
    np.testing.assert_array_equal(np.asarray(respt.logz_pt[0]),
                                  np.asarray(fullpt.logz_pt[0]))


def test_hmc_tier():
    lf, m, b, flux, unc = _make(seed=4)
    lf.run_hmc(nwarmup=100, nsteps=300, n_leapfrog=8)
    assert lf.chain_free.shape[0] == 3
    for s in range(3):
        mean, cov = _wls(flux[s], unc[s])
        flat = lf.chain_free[s].reshape(-1, 2).double().numpy()
        np.testing.assert_allclose(flat.mean(axis=0), mean,
                                   atol=4 * np.sqrt(np.diag(cov)).max())
    # PT/HMC tiers are not extend()-continuable; the engine must have
    # cleared the stretch-move continuation state
    with pytest.raises(RuntimeError):
        lf.extend(10)


def test_map_tier_matches_wls():
    lf, m, b, flux, unc = _make(seed=5)
    lf.run_map(nstarts=4, n_adam=60, n_newton=8)
    for s in range(3):
        mean, cov = _wls(flux[s], unc[s])
        np.testing.assert_allclose(lf.map_params[s], mean, atol=1e-2)
        np.testing.assert_allclose(
            lf.map_sigma[s], np.sqrt(np.diag(cov)), rtol=0.05)
    # and init='map' seeds a run through the same hook surface
    lf.run(nburn=20, nsteps=40, init="map")
    assert lf.chain_free.shape[1] == 40


def test_evidence_tier_matches_analytic():
    logz, logz_err, flux, unc = _tier_run("nested")
    for s in range(3):
        want = _analytic_logz(flux[s], unc[s])
        tol = max(0.5, 4 * float(logz_err[s]))
        assert abs(float(logz[s]) - want) < tol, \
            f"source {s}: {float(logz[s])} vs {want}"


@pytest.mark.parametrize("tier", ["pt", "nested"])
def test_evidence_agrees_with_the_jax_line_fitter(tier):
    """The port's PT and nested lnZ against the JAX test's LineFitter on
    the same data and settings (the JAX test's seeds 3 and 6): within 3x
    the combined reported errors, floored at the JAX test's 0.5 nat."""
    from tests import test_batchengine_contract as jt
    got, gerr, flux, unc = _tier_run(tier)
    jlf, *_, jflux, junc = jt._make(seed=3 if tier == "pt" else 6)
    np.testing.assert_array_equal(jflux, flux)
    if tier == "pt":
        jlf.run_pt(nrungs=10, nburn=150, nsteps=400)
        want, werr = jlf.logz_pt
    else:
        jev = jlf.compute_evidence(nlive=256, nbatch=32, nsteps=24)
        want, werr = jev.logz, jev.logz_err
    want, werr = np.asarray(want, np.float64), np.asarray(werr, np.float64)
    assert np.all(np.abs(got - want)
                  < np.maximum(0.5, 3 * np.hypot(gerr, werr))), (got, want)
