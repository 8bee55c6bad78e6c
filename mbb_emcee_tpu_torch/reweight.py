"""Post-hoc prior replacement by PSIS-smoothed importance reweighting.

Torch-package twin of mbb_emcee_tpu/reweight.py, a numpy copy on this
package's MBBResults and SEDResults (reweight_prior) and MultiFitter and
SEDMultiFitter (reweight_prior_batch).

A finished chain sampled under
prior pi_old can answer "what would the posterior look like under
pi_new?" WITHOUT refitting -- reweight each stored sample by
w_n = pi_new(theta_n) / pi_old(theta_n) (the likelihood cancels).
Classic uses: swapping the temperature prior of a photo-z fit for a
different calibration sample, prior-sensitivity checks for a referee,
removing an over-tight prior after the fact.

Importance weights from prior swaps are exactly the situation PSIS was
built for (Vehtari+ 2017): a new prior WIDER than the sampled posterior
in some direction puts huge weight on a few tail samples. The weights
are therefore Pareto-smoothed (the same `modelcheck.psis_smooth` /
`gpd_fit` machinery as LOO) and every result carries the k-hat
reliability diagnostic and the effective sample size: k-hat > 0.7 or a
small ESS means the stored chain does not cover the new posterior --
refit instead of trusting the reweighting.

Only GAUSSIAN (and flat) priors participate, mirroring the package's
prior surface: the old prior is read from the result's recorded spec
(and, for batch fits, any per-source priors), so the ratio is exact.
Hard box limits are unchanged by construction (samples outside the box
were never stored).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mbb_emcee_tpu_torch.likelihood import param_index
from mbb_emcee_tpu_torch.modelcheck import psis_smooth, _logsumexp

__all__ = ["ReweightResult", "ReweightBatchResult", "reweight_prior",
           "reweight_prior_batch"]

K_HAT_WARN = 0.7


def _weighted_percentiles(x, w, qs):
    """Percentiles (0-100) of samples x under normalized weights w by
    linear interpolation of the weighted ECDF (midpoint convention)."""
    order = np.argsort(x)
    xs, ws = x[order], w[order]
    cdf = np.cumsum(ws) - 0.5 * ws
    cdf /= ws.sum()
    return np.interp(np.asarray(qs, np.float64) / 100.0, cdf, xs)


def _index_closure(res):
    """Name->index resolver for a Reweight*Result that pins only the
    (small, frozen) model or a snapshot of the name list -- never `res`
    itself: reweight results outlive their parent fits, whose chains and
    device buffers can be large, and a closure over the fitter would keep
    all of it alive. MBB fits resolve the package-wide parameter names."""
    model = getattr(res, "model", None)
    if model is not None:
        return model.param_index                 # frozen dataclass
    names = getattr(res, "_stored_param_names", None)
    if names is not None:
        lowered = [str(n).lower() for n in names]

        def idx(p, _names=lowered):
            if isinstance(p, (int, np.integer)):
                return int(p)
            try:
                return _names.index(str(p).lower())
            except ValueError:
                raise ValueError(f"unknown parameter {p!r}") from None

        return idx
    return param_index


def _host(samples):
    """Thinned samples as a host fp64 array (a tensor on any device, or
    numpy)."""
    if hasattr(samples, "detach"):
        samples = samples.detach().double().cpu().numpy()
    return np.asarray(samples, np.float64)


@dataclasses.dataclass
class ReweightResult:
    """A reweighted posterior: thinned samples + normalized PSIS weights.

    `par_cen(param)` gives the weighted (median, +err, -err); `ess` and
    `pareto_k` say whether to trust it (see module docstring)."""
    samples: np.ndarray        # (N, npar) thinned full-space samples
    logw: np.ndarray           # (N,) normalized smoothed log weights
    ess: float
    pareto_k: float
    param: str
    new_prior: tuple           # (mean, sigma) -- sigma None = flat
    old_prior: tuple
    _index: object             # param name/idx -> column index

    @property
    def weights(self):
        return np.exp(self.logw)

    @property
    def nsamples(self):
        return self.samples.shape[0]

    @property
    def reliable(self):
        # Two necessary conditions: a healthy tail fit AND a healthy
        # effective sample size. k-hat alone is not enough for prior
        # swaps -- a far-off new prior can leave a perfectly fittable
        # tail (k ~ 0.6) on weights carried by a handful of samples.
        # k-hat = inf (tail too short, or a FAILED GPD fit on raw
        # unsmoothed weights) reads as not-assessable = unreliable;
        # degenerate-spread identity swaps get k = 0 upstream and pass.
        n = self.nsamples
        k_ok = bool(np.isfinite(self.pareto_k)
                    and self.pareto_k <= K_HAT_WARN)
        return bool(k_ok and self.ess >= max(100.0, 0.02 * n))

    def parameter_chain(self, param):
        return self.samples[:, self._index(param)]

    def par_cen(self, param, percentile=68.3):
        q = (100.0 - percentile) / 2.0
        lo, med, hi = _weighted_percentiles(
            self.parameter_chain(param), self.weights,
            [q, 50.0, 100.0 - q])
        return np.array([med, hi - med, med - lo])

    def mean(self, param):
        w = self.weights
        return float(np.sum(w * self.parameter_chain(param)) / w.sum())

    def __repr__(self):
        m, s = self.new_prior
        tag = "flat" if s is None else f"N({m:g}, {s:g})"
        note = "" if self.reliable else \
            "  [UNRELIABLE: k-hat > 0.7 -- refit under the new prior]"
        return (f"ReweightResult[{self.param} -> {tag}]: "
                f"ESS {self.ess:.1f}/{self.nsamples}, "
                f"k-hat {self.pareto_k:.2f}{note}")


def _log_ratio(th, old_m, old_isig, new_m, new_isig):
    logw = np.zeros_like(th)
    if new_isig > 0:
        d = (th - new_m) * new_isig
        logw += np.log(new_isig) - 0.5 * d * d
    if old_isig > 0:
        d = (th - old_m) * old_isig
        logw += 0.5 * d * d - np.log(old_isig)
    return logw


def _smooth_normalize(logw):
    # Degenerate spread (e.g. an identity swap, where the ratio is
    # constant up to fp ulps): uniform weights, nothing to smooth --
    # without this, the GPD tail fit runs on pure rounding noise and
    # can report an arbitrary k-hat.
    if float(logw.max() - logw.min()) < 1e-8:
        n = logw.size
        return np.full(n, -np.log(n)), 0.0, float(n)
    lw, k = psis_smooth(logw)
    lw = lw - _logsumexp(lw)
    w = np.exp(lw)
    ess = float(1.0 / np.sum(w * w))
    return lw, float(k), ess


def _new_prior_arrays(mean, sigma):
    if sigma is None:
        return 0.0, 0.0
    if mean is None:
        raise ValueError(
            "a new prior needs BOTH mean and sigma (sigma=None removes "
            "the prior)")
    sigma = float(sigma)
    if not (np.isfinite(sigma) and sigma > 0):
        raise ValueError("new prior sigma must be positive and finite "
                         "(or None to remove the prior)")
    m = float(mean)
    if not np.isfinite(m):
        raise ValueError("new prior mean must be finite")
    return m, 1.0 / sigma


def reweight_prior(res, param, mean=None, sigma=None, thin=1):
    """Reweight a finished fit's posterior under a replaced Gaussian
    prior on `param` (sigma=None removes the prior).

    `res` is an MBBResults or SEDResults; the OLD prior is the one its
    recorded spec carries for that parameter (isigma 0 = flat). Returns
    a ReweightResult; check `.reliable` / `.ess` before using the
    summaries."""
    i = res._param_index(param)
    spec = res.param_spec
    if bool(spec.fixed[i]):
        raise ValueError(
            f"parameter {param!r} was FIXED in the fit; its chain is "
            "constant and a prior swap cannot move it -- refit instead")
    samples = _host(res._thinned(thin))
    new_m, new_i = _new_prior_arrays(mean, sigma)
    old_m = float(spec.prior_mean[i])
    old_i = float(spec.prior_isigma[i])
    if new_i == 0.0 and old_i == 0.0:
        raise ValueError(
            f"parameter {param!r} had no prior and none was given: "
            "nothing to reweight")
    logw = _log_ratio(samples[:, i], old_m, old_i, new_m, new_i)
    lw, k, ess = _smooth_normalize(logw)
    name = str(param)
    return ReweightResult(
        samples=samples, logw=lw, ess=ess, pareto_k=k, param=name,
        new_prior=(None if sigma is None else float(mean),
                   None if sigma is None else float(sigma)),
        old_prior=(old_m, (1.0 / old_i) if old_i > 0 else None),
        _index=_index_closure(res))


@dataclasses.dataclass
class ReweightBatchResult:
    """Per-source reweighted posteriors for a whole catalog."""
    samples: np.ndarray        # (S, N, npar)
    logw: np.ndarray           # (S, N) normalized smoothed log weights
    ess: np.ndarray            # (S,)
    pareto_k: np.ndarray       # (S,)
    param: str
    _index: object

    @property
    def nsources(self):
        return self.samples.shape[0]

    @property
    def reliable(self):
        # same two-condition rule as ReweightResult.reliable
        n = self.samples.shape[1]
        k_ok = np.isfinite(self.pareto_k) & (self.pareto_k <= K_HAT_WARN)
        return k_ok & (self.ess >= max(100.0, 0.02 * n))

    def par_cen(self, param, percentile=68.3):
        j = self._index(param)
        q = (100.0 - percentile) / 2.0
        out = np.empty((self.nsources, 3))
        for s in range(self.nsources):
            lo, med, hi = _weighted_percentiles(
                self.samples[s, :, j], np.exp(self.logw[s]),
                [q, 50.0, 100.0 - q])
            out[s] = (med, hi - med, med - lo)
        return out

    def __repr__(self):
        bad = int(np.sum(~self.reliable))
        return (f"ReweightBatchResult[{self.param}]: {self.nsources} "
                f"sources, median ESS {np.median(self.ess):.1f}, "
                f"{bad} with k-hat > {K_HAT_WARN}")


def reweight_prior_batch(mf, param, mean=None, sigma=None, thin=1):
    """Batch form of reweight_prior for MultiFitter / SEDMultiFitter:
    per-source weights in one pass. `mean`/`sigma` may be scalars or (S,)
    arrays (a different new prior per source). The OLD prior is the
    shared spec's, combined with any per-source prior the fit carried for
    that parameter (sedmulti.set_gaussian_prior with arrays)."""
    i = mf._param_index(param)
    spec = mf._effective_spec()
    if bool(spec.fixed[i]):
        raise ValueError(
            f"parameter {param!r} was FIXED in the fit; refit instead")
    samples = _host(mf._thinned(thin))                   # (S, N, npar)
    S = samples.shape[0]
    if sigma is not None and mean is None:
        raise ValueError(
            "a new prior needs BOTH mean and sigma (sigma=None removes "
            "the prior)")
    new_m = np.broadcast_to(np.asarray(
        0.0 if mean is None else mean, np.float64), (S,))
    if sigma is None:
        new_i = np.zeros(S)
    else:
        sig = np.broadcast_to(np.asarray(sigma, np.float64), (S,))
        on = np.isfinite(sig) & (sig > 0)
        if not np.isfinite(new_m[on]).all():
            raise ValueError("new prior means must be finite wherever "
                             "sigma is finite and positive")
        new_i = np.where(on, 1.0 / np.where(on, sig, 1.0), 0.0)
    old_m = np.full(S, float(spec.prior_mean[i]))
    old_i = np.full(S, float(spec.prior_isigma[i]))
    ps = getattr(mf, "_ps_prior", None) or {}
    # the model's canonical lower-case name for this parameter
    names = getattr(getattr(mf, "model", None), "param_names", None)
    key = names[i].lower() if names is not None else str(param).lower()
    if key in ps:
        m_s, i_s = ps[key]
        # product of Gaussians: precisions add, means precision-weight
        v = old_i ** 2 + np.asarray(i_s, np.float64) ** 2
        with np.errstate(invalid="ignore", divide="ignore"):
            comb_m = np.where(v > 0,
                              (old_m * old_i ** 2 + m_s * i_s ** 2)
                              / np.where(v > 0, v, 1.0), 0.0)
        old_m, old_i = comb_m, np.sqrt(v)
    if not (np.any(new_i > 0) or np.any(old_i > 0)):
        raise ValueError(
            f"parameter {param!r} had no prior anywhere and none was "
            "given: nothing to reweight")
    logw_s = np.empty((S, samples.shape[1]))
    ess = np.empty(S)
    k_hat = np.empty(S)
    for s in range(S):
        logw = _log_ratio(samples[s, :, i], old_m[s], old_i[s],
                          new_m[s], new_i[s])
        logw_s[s], k_hat[s], ess[s] = _smooth_normalize(logw)
    return ReweightBatchResult(samples=samples, logw=logw_s, ess=ess,
                               pareto_k=k_hat, param=str(param),
                               _index=_index_closure(mf))
