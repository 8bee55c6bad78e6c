"""Fisher-matrix observing forecasts: predicted parameter errors for a
PROPOSED observation, before any data exist.

Torch twin of mbb_emcee_tpu/forecast.py. The Gaussian-likelihood Fisher
matrix

    F_ij = sum_b  (dm_b/dth_i)(dm_b/dth_j) / sigma_b^2   +  P_ij

with m_b the model fluxes (point or response-integrated) at a fiducial
theta and P the Gaussian-prior precision; the forecast covariance is F^-1
over the FREE parameters (the Cramer-Rao floor). The flux Jacobian dm/dtheta
is one torch.func.jacfwd, in fp32, of the SAME model code every sampler tier
runs (a sed.SEDModel's fnu: opacity pivot, Wien merge root-solve, CMB
corrections, filter quadrature and all); the rest runs on the host in fp64.

Correlated band errors: pass `cov=` and the Jacobian is whitened by the
Cholesky inverse, F = J^T C^-1 J. The forecast assumes a Gaussian posterior
at the fiducial point: degeneracies that bend (the T-z ridge with weak
priors, the T-lambda0 bimodality) make it optimistic -- compare
ForecastResult.corr() against 1 and run a mock MCMC when correlations
exceed ~0.97.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch.fitter import resolve_device

__all__ = ["ForecastResult", "forecast", "forecast_mbb"]


@dataclasses.dataclass
class ForecastResult:
    """Fisher forecast at a fiducial theta: free-parameter errors."""
    param_names: tuple          # free parameter names, Fisher order
    theta0: np.ndarray          # (npar,) fiducial full-space vector
    fisher: np.ndarray          # (nfree, nfree)
    cov: np.ndarray             # (nfree, nfree) = fisher^-1
    fluxes: np.ndarray          # (nb,) model fluxes at theta0
    snr: np.ndarray             # (nb,) per-band S/N of the fiducial

    def _k(self, param):
        key = str(param).lower()
        names = [n.lower() for n in self.param_names]
        if key not in names:
            raise ValueError(
                f"{param!r} is not a free forecast parameter; "
                f"free: {list(self.param_names)}")
        return names.index(key)

    def sigma(self, param):
        """Forecast 1-sigma marginal error (Cramer-Rao floor)."""
        return float(np.sqrt(self.cov[self._k(param), self._k(param)]))

    def sigmas(self):
        return {n: float(np.sqrt(self.cov[k, k]))
                for k, n in enumerate(self.param_names)}

    def corr(self):
        """(nfree, nfree) forecast correlation matrix."""
        s = np.sqrt(np.diag(self.cov))
        return self.cov / np.outer(s, s)

    def __repr__(self):
        lines = ["ForecastResult:"]
        for n, s in self.sigmas().items():
            lines.append(f"  sigma({n}) = {s:.4g}")
        c = np.abs(self.corr() - np.eye(len(self.param_names))).max()
        lines.append(f"  max |corr| = {c:.3f}"
                     + ("  [near-degenerate: verify with a mock MCMC]"
                        if c > 0.97 else ""))
        return "\n".join(lines)


def _whiten_from(unc, cov, nb):
    """(whiten, band_sigma): the Cholesky-inverse whitening matrix (None
    for the diagonal path) and the per-band 1-sigma depths."""
    if cov is None and unc is None:
        raise ValueError(
            "a forecast needs the expected noise: pass unc= (per-band "
            "1-sigma depths) or cov= (full band covariance)")
    if cov is not None and unc is not None:
        # a depth scan that updates unc but keeps a stale cov would
        # silently use the wrong noise model
        raise ValueError(
            "pass unc= OR cov=, not both (ambiguous noise model; fold "
            "the depths into the covariance diagonal if you mean both)")
    if cov is not None:
        cov = np.asarray(cov, np.float64)
        if cov.shape != (nb, nb):
            raise ValueError(f"cov must be ({nb}, {nb}); got {cov.shape}")
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            raise ValueError(
                "cov= must be a symmetric positive-definite band "
                "covariance") from None
        return np.linalg.inv(chol), np.sqrt(np.diag(cov))
    unc = np.atleast_1d(np.asarray(unc, np.float64))
    if unc.shape != (nb,):
        raise ValueError(f"unc must be ({nb},); got {unc.shape}")
    if np.any(~np.isfinite(unc) | (unc <= 0)):
        raise ValueError("forecast uncertainties must be positive and "
                         "finite (drop bands you will not observe)")
    return None, unc


def forecast(model, theta0, wave, unc=None, cov=None, responses=None,
             priors=None, fixed=(), device=None):
    """Fisher forecast for a generic sed.SEDModel at fiducial `theta0`.

    wave/unc describe the PROPOSED bands (observed um, expected 1-sigma
    mJy); `cov=` replaces unc with a full band covariance. `responses=` is a
    (nodes, weights) pack over named bands exactly as in fitting
    (ResponseSet.pack), or None for point evaluation.
    `priors={"T": (mu, sigma), ...}` adds Gaussian-prior precision (only
    sigma enters the Fisher matrix). `fixed` names parameters held fixed
    (excluded from the forecast space). The model and its Jacobian run on
    `device` ("cuda", the default, raises without a card; or "cpu").

    Returns a ForecastResult over the remaining free parameters.
    """
    from mbb_emcee_tpu_torch.likelihood import FreeSpace

    device = resolve_device(device)
    theta0 = np.asarray(theta0, np.float64)
    if theta0.shape != (model.npar,):
        raise ValueError(
            f"theta0 must be ({model.npar},) for model {model.name!r}")
    wave = np.atleast_1d(np.asarray(wave, np.float64))
    nb = wave.size
    whiten, band_sigma = _whiten_from(unc, cov, nb)

    fixed_idx = sorted({model.param_index(p) for p in fixed})
    free_idx = np.array([i for i in range(model.npar)
                         if i not in fixed_idx], int)
    if free_idx.size == 0:
        raise ValueError("every parameter is fixed; nothing to forecast")
    names = tuple(model.param_names[i] for i in free_idx)
    # the reduced-space embedding every lnprob builder uses, with the
    # FIDUCIAL at the fixed slots
    template = theta0.copy()
    template[free_idx] = 0.0
    fs = FreeSpace(free_idx=free_idx, template=template,
                   lower=np.asarray(model.lower)[free_idx].copy(),
                   upper=np.asarray(model.upper)[free_idx].copy())

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    t_j, s_j, w_j = dev(template), dev(fs.scatter_matrix()), dev(wave)
    if responses is not None:
        rw_np = np.asarray(responses[0])
        if rw_np.shape[0] != nb:
            raise ValueError(
                f"the response pack covers {rw_np.shape[0]} bands but "
                f"wave/unc describe {nb}; pack the same band list you "
                "are forecasting")
        rw, rwt = dev(rw_np), dev(responses[1])

    def fluxes_free(th_free):
        # template + scatter @ th_free, written out (no matmul, so no TF32
        # question; the 0/1 scatter makes it exact)
        th = t_j + torch.sum(s_j * th_free, dim=-1)
        if responses is None:
            return model.fnu(th, w_j)
        return torch.sum(rwt * model.fnu(th, rw), dim=-1)

    th_free0 = dev(theta0[free_idx])
    m0 = fluxes_free(th_free0).double().cpu().numpy()
    jac = torch.func.jacfwd(fluxes_free)(th_free0).double().cpu().numpy()
    if not np.isfinite(jac).all():
        raise ValueError(
            "non-finite flux derivatives at theta0 -- move the fiducial "
            "off the box edge / merge discontinuity")
    snr = m0 / band_sigma
    jw = (jac / band_sigma[:, None]) if whiten is None else whiten @ jac
    F = jw.T @ jw
    if priors:
        lnames = [n.lower() for n in names]
        for p, (_, sig) in priors.items():
            key = str(p).lower()
            if key not in lnames:
                raise ValueError(
                    f"prior on {p!r}: not a free forecast parameter")
            sig = float(sig)
            if not (np.isfinite(sig) and sig > 0):
                raise ValueError(f"prior sigma on {p!r} must be positive")
            k = lnames.index(key)
            F[k, k] += 1.0 / sig ** 2
    # A singular Fisher matrix (an exact degeneracy, e.g. photo-z with no
    # prior) is reported, not inverted. The test runs on the
    # correlation-normalized matrix: raw cond(F) is not invariant under
    # parameter units, so a benign scale disparity must not read as a
    # degeneracy.
    d = np.diag(F)
    if np.any(d <= 0) or not np.isfinite(d).all():
        raise ValueError(
            "a forecast parameter carries no information at this "
            "configuration (zero Fisher diagonal) -- fix it or add a "
            "prior")
    dn = np.sqrt(d)
    cond = np.linalg.cond(F / np.outer(dn, dn))
    if not np.isfinite(cond) or cond > 1e10:
        raise ValueError(
            "the Fisher matrix is singular at this configuration "
            f"(normalized condition number {cond:.2e}): an exact "
            "degeneracy survives -- add a prior (photo-z: the T prior) "
            "or fix a parameter")
    return ForecastResult(param_names=names, theta0=theta0, fisher=F,
                          cov=np.linalg.inv(F), fluxes=m0, snr=snr)


def forecast_mbb(theta0, wave, unc=None, cov=None, opthin=False,
                 noalpha=False, wavenorm=500.0, priors=None, fixed=(),
                 device=None):
    """Fisher forecast for the core observer-frame MBB (the reference's
    5-parameter model): an SEDModel over the same log-space model every
    sampler uses, handed to `forecast`. lambda0 under opthin and alpha under
    noalpha are inert and are always excluded."""
    from mbb_emcee_tpu_torch.sed import SEDModel
    from mbb_emcee_tpu_torch.likelihood import DEFAULT_LOWER, DEFAULT_UPPER
    from mbb_emcee_tpu_torch.models.modified_blackbody import (
        log_mbb_fnu, MBBShape)

    shape = MBBShape(opthin=bool(opthin), noalpha=bool(noalpha),
                     wavenorm=float(wavenorm))

    def fnu(th, w):
        return torch.exp(log_mbb_fnu(th, w, shape))

    model = SEDModel(fnu=fnu,
                     param_names=("T", "beta", "lambda0", "alpha", "fnorm"),
                     lower=DEFAULT_LOWER.copy(), upper=DEFAULT_UPPER.copy(),
                     name="mbb-forecast")
    # indices, so integer-addressed entries work as in forecast() itself
    fixed_idx = {model.param_index(p) for p in fixed}
    if opthin:
        fixed_idx.add(model.param_index("lambda0"))
    if noalpha:
        fixed_idx.add(model.param_index("alpha"))
    return forecast(model, theta0, wave, unc=unc, cov=cov, priors=priors,
                    fixed=sorted(fixed_idx), device=device)
