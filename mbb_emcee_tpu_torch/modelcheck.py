"""Predictive model assessment: WAIC and PSIS-LOO cross-validation.

Torch-package twin of mbb_emcee_tpu/modelcheck.py: the estimators, result
classes and HDF5 groups are a numpy copy of the JAX package's (that module
imports no jax, but this package imports nothing of it); only the pointwise
log-likelihood matrix is torch, on the fit's device.

Each model's out-of-sample predictive accuracy is estimated from the same
stored chains every other derived quantity uses, so "does adding alpha
actually predict better?" costs one batched device pass instead of a refit
per left-out band.

    elpd_loo = sum_i ln p(y_i | y_-i)        (leave-one-out predictive)
    elpd_waic = sum_i [ lpd_i - var_n ln p(y_i | theta_n) ]

estimated by importance sampling over posterior draws theta_n, with the
raw 1/p(y_i|theta_n) ratios stabilized by PARETO-SMOOTHED importance
sampling (Vehtari, Gelman & Gabry 2017; Vehtari et al. 2021): the top
~20% of each point's ratios are replaced by expected order statistics of
a generalized Pareto distribution fitted to the tail (Zhang & Stephens
2009 posterior-mean estimator), and the fitted shape k-hat is the
published per-point reliability diagnostic (k > 0.7: the estimate for
that band cannot be trusted; refit without the band instead).

Division of labor, matching the rest of the package: the (nsamples x
npoints) pointwise log-likelihood matrix is one batched torch
computation on the chain's device (callers in results.py and
batchengine.py); the
PSIS tail surgery -- sorting-heavy, O(npoints * tail) on a few-KB
matrix -- runs host-side in fp64 where a vector unit buys nothing.

Pointwise factors: with independent band errors ln p(y_i|theta) is the
per-band Gaussian density. With a full error covariance the pointwise
factor is the CONDITIONAL predictive density p(y_i | y_-i, theta) --
N(mu_c, 1/Lambda_ii) with Lambda = C^-1 and mu_c = y_i - g_i/Lambda_ii,
g = Lambda (y - m) -- evaluated at y_i as

    ln p(y_i | y_-i, theta) = 1/2 ln(Lambda_ii / 2 pi) - g_i^2 / (2 Lambda_ii)

so correlated-calibration fits assess leave-one-band-out prediction
CONDITIONAL on the other bands (the exact LOO factorization for a
multivariate normal), needing only the precision matrix the whitening
already implies. Censored (upper-limit) and missing bands carry no
proper pointwise density and are excluded from the assessment.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LooResult", "LooBatchResult", "LooComparison",
           "ExactLooResult", "gpd_fit", "psis_smooth", "loo_from_loglik",
           "loo_batch_from_loglik", "compare_loo",
           "gaussian_pointwise_constants", "PARETO_K_WARN"]

# Published reliability threshold for the Pareto shape diagnostic
# (Vehtari et al. 2021 recommend 0.7 for moderate sample sizes).
PARETO_K_WARN = 0.7

# Minimum tail length for a meaningful generalized-Pareto fit; below it
# the raw (truncated) importance weights are used and k-hat is reported
# as inf ("not assessable"), following the PSIS reference implementation.
_MIN_TAIL = 5


@dataclasses.dataclass
class LooResult:
    """WAIC + PSIS-LOO summaries over the assessed data points.

    Pointwise arrays are aligned with `point_index` (indices into the
    fit's band axis; censored/missing bands are absent). For the batched
    serving surface, see MultiFitter.compute_loo which returns per-source
    stacked summaries instead.
    """
    elpd_loo: float            # sum_i elpd_loo_i
    se_elpd_loo: float         # sqrt(n * var(elpd_loo_i))
    p_loo: float               # effective number of parameters, LOO
    elpd_waic: float
    se_elpd_waic: float
    p_waic: float
    pointwise_loo: np.ndarray   # (npoints,)
    pointwise_waic: np.ndarray  # (npoints,)
    pointwise_lpd: np.ndarray   # (npoints,) ln (1/n sum_n p(y_i|theta_n))
    pareto_k: np.ndarray        # (npoints,) tail-shape diagnostic
    point_index: np.ndarray     # (npoints,) band indices assessed
    nsamples: int
    band_names: list | None = None

    @property
    def n_bad_k(self):
        """Points whose PSIS tail fit is unreliable (k > 0.7)."""
        return int(np.sum(self.pareto_k > PARETO_K_WARN))

    def __repr__(self):
        n = self.pointwise_loo.size
        s = (f"LooResult(elpd_loo={self.elpd_loo:.3f} "
             f"+- {self.se_elpd_loo:.3f}, p_loo={self.p_loo:.2f}, "
             f"elpd_waic={self.elpd_waic:.3f} "
             f"+- {self.se_elpd_waic:.3f}, n={n}, "
             f"max k-hat={np.max(self.pareto_k):.2f}")
        if self.n_bad_k:
            s += f", {self.n_bad_k} point(s) with k>{PARETO_K_WARN}"
        return s + ")"


def gpd_fit(x):
    """Generalized-Pareto (k, sigma) for exceedances x (ascending, > 0).

    Zhang & Stephens (2009) quasi-Bayes posterior-mean estimator with the
    weak prior regularization on k of Vehtari et al. (2021) appendix --
    the standard PSIS tail fit. Profile likelihood in b = k/sigma over a
    deterministic grid; no optimizer, no data-dependent control flow.
    """
    x = np.asarray(x, np.float64)
    n = x.size
    prior_bs, prior_k = 3.0, 10.0
    m = 30 + int(np.sqrt(n))
    b = 1.0 - np.sqrt(m / (np.arange(1.0, m + 1.0) - 0.5))
    b /= prior_bs * x[int(n / 4.0 + 0.5) - 1]
    b += 1.0 / x[-1]
    k = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    logl = n * (np.log(-b / k) - k - 1.0)          # profile log-likelihood
    w = np.exp(logl - logl.max())                  # posterior grid weights
    w /= w.sum()
    b_post = float(np.sum(b * w))
    k_post = float(np.mean(np.log1p(-b_post * x)))
    sigma = -k_post / b_post
    k_hat = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return k_hat, sigma


def _gpd_quantile(p, k, sigma):
    """Inverse CDF of the generalized Pareto (location 0)."""
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psis_smooth(logw):
    """Pareto-smooth one point's raw log importance ratios.

    Returns (lw, k_hat) where lw is normalized (logsumexp(lw) = 0) with
    the largest ~20% of ratios replaced by GPD expected order statistics
    and truncated at the raw maximum. k_hat = inf when the tail is too
    short to fit (weights are then just normalized raw ratios).
    """
    logw = np.asarray(logw, np.float64).copy()
    n = logw.size
    shift = logw.max()
    logw -= shift
    tail = int(np.ceil(min(0.2 * n, 3.0 * np.sqrt(n))))
    k_hat = np.inf
    if tail >= _MIN_TAIL and n - tail >= 1:
        order = np.argsort(logw)
        tail_ids = order[-tail:]
        cutoff = np.exp(logw[order[-tail - 1]])
        exceed = np.exp(logw[tail_ids]) - cutoff
        if exceed[-1] > 0.0:
            # Guard exact ties with the cutoff (zero exceedances break
            # the profile grid): nudge onto the smallest positive value.
            tiny = np.max(exceed) * 1e-12
            k_hat, sigma = gpd_fit(np.maximum(np.sort(exceed), tiny))
            if np.isfinite(k_hat) and np.isfinite(sigma):
                p = (np.arange(1.0, tail + 1.0) - 0.5) / tail
                q = _gpd_quantile(p, k_hat, sigma) + cutoff
                # tail_ids is already ascending in logw (slice of argsort)
                logw[tail_ids] = np.minimum(np.log(q), 0.0)
            else:
                # A FAILED tail fit must read as "not assessable" (inf),
                # never as NaN: NaN > 0.7 is False everywhere downstream,
                # which would report the one band whose diagnostic broke
                # as the trustworthy one.
                k_hat = np.inf
    return logw - _logsumexp(logw), k_hat


def _logsumexp(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - m), axis=axis)) + np.squeeze(m, axis)
    return out if axis is not None else float(out)


def loo_from_loglik(loglik, point_index=None, band_names=None):
    """WAIC + PSIS-LOO from a pointwise log-likelihood matrix.

    loglik: (nsamples, npoints) fp64 host array, ln p(y_i | theta_n) for
    posterior draws theta_n (one batched device computation).
    """
    loglik = np.asarray(loglik, np.float64)
    if loglik.ndim != 2:
        raise ValueError("loglik must be (nsamples, npoints)")
    n, npts = loglik.shape
    if n < 2:
        raise ValueError("need at least 2 posterior draws")
    lpd = _logsumexp(loglik, axis=0) - np.log(n)          # (npts,)

    # WAIC: functional variance penalty per point.
    p_waic_i = np.var(loglik, axis=0, ddof=1)
    elpd_waic_i = lpd - p_waic_i

    # PSIS-LOO: smooth each point's raw ratios r_n = 1/p(y_i|theta_n).
    elpd_loo_i = np.empty(npts)
    k_hat = np.empty(npts)
    for i in range(npts):
        lw, k = psis_smooth(-loglik[:, i])
        elpd_loo_i[i] = _logsumexp(lw + loglik[:, i])
        k_hat[i] = k

    def _tot(x):
        return float(np.sum(x)), float(np.sqrt(npts * np.var(x, ddof=1))
                                       if npts > 1 else np.nan)
    elpd_loo, se_loo = _tot(elpd_loo_i)
    elpd_waic, se_waic = _tot(elpd_waic_i)
    return LooResult(
        elpd_loo=elpd_loo, se_elpd_loo=se_loo,
        p_loo=float(np.sum(lpd - elpd_loo_i)),
        elpd_waic=elpd_waic, se_elpd_waic=se_waic,
        p_waic=float(np.sum(p_waic_i)),
        pointwise_loo=elpd_loo_i, pointwise_waic=elpd_waic_i,
        pointwise_lpd=lpd, pareto_k=k_hat,
        point_index=(np.arange(npts) if point_index is None
                     else np.asarray(point_index, np.int64)),
        nsamples=n, band_names=band_names)


@dataclasses.dataclass
class LooBatchResult:
    """Per-source WAIC + PSIS-LOO over a catalog (MultiFitter.compute_loo).

    Pointwise (S, nb) arrays are NaN at excluded (missing/upper-limit)
    slots. Compare two model variants fit on the same catalog by
    differencing their elpd_loo vectors source by source."""
    elpd_loo: np.ndarray       # (S,)
    se_elpd_loo: np.ndarray    # (S,)
    p_loo: np.ndarray          # (S,)
    elpd_waic: np.ndarray      # (S,)
    se_elpd_waic: np.ndarray   # (S,)
    p_waic: np.ndarray         # (S,)
    pointwise_loo: np.ndarray  # (S, nb), NaN at excluded slots
    pareto_k: np.ndarray       # (S, nb), NaN at excluded slots
    n_points: np.ndarray       # (S,) bands assessed per source
    nsamples: int
    excluded: np.ndarray       # (S, nb) bool

    @property
    def n_bad_k(self):
        """(S,) count of unreliable tail fits (k > 0.7) per source."""
        with np.errstate(invalid="ignore"):
            return np.sum(np.nan_to_num(self.pareto_k, nan=0.0)
                          > PARETO_K_WARN, axis=1)

    def __repr__(self):
        S = self.elpd_loo.size
        return (f"LooBatchResult(S={S}, nsamples={self.nsamples}, "
                f"total elpd_loo={np.sum(self.elpd_loo):.2f}, "
                f"sources with bad k-hat: {int((self.n_bad_k > 0).sum())})")


def loo_batch_from_loglik(loglik, include):
    """Per-source LOO/WAIC from a batched pointwise log-likelihood.

    loglik: (S, nsamples, nb) host fp64; include: (S, nb) bool marking
    the slots that carry proper pointwise densities (detected bands).
    Runs loo_from_loglik per source on its observed columns and stacks
    the summaries, NaN-padding pointwise arrays back to the band axis.
    """
    loglik = np.asarray(loglik, np.float64)
    include = np.asarray(include, bool)
    S, n, nb = loglik.shape
    scalars = np.full((6, S), np.nan)
    pw_loo = np.full((S, nb), np.nan)
    k_hat = np.full((S, nb), np.nan)
    npts = include.sum(axis=1)
    for s in range(S):
        idx = np.where(include[s])[0]
        if idx.size == 0:
            # a source with no assessable band (all upper limits /
            # missing) must report NaN, not a plausible-looking
            # elpd_loo of exactly 0.0 that np.sum totals silently
            continue
        r = loo_from_loglik(loglik[s][:, idx], point_index=idx)
        scalars[:, s] = (r.elpd_loo, r.se_elpd_loo, r.p_loo,
                         r.elpd_waic, r.se_elpd_waic, r.p_waic)
        pw_loo[s, idx] = r.pointwise_loo
        k_hat[s, idx] = r.pareto_k
    return LooBatchResult(
        elpd_loo=scalars[0], se_elpd_loo=scalars[1], p_loo=scalars[2],
        elpd_waic=scalars[3], se_elpd_waic=scalars[4], p_waic=scalars[5],
        pointwise_loo=pw_loo, pareto_k=k_hat,
        n_points=npts.astype(np.int64), nsamples=n, excluded=~include)


@dataclasses.dataclass
class ExactLooResult:
    """Brute-force leave-one-band-out elpd (MBBFitter.compute_loo_exact).

    Each pointwise value is ln(1/N sum_n p(y_i | theta_n^{-i})) over a
    chain REFIT without band i -- the estimand PSIS-LOO approximates,
    with no importance-sampling step to go wrong. Use it to settle
    bands the k-hat diagnostic flagged. se_mc is the naive delta-method
    Monte-Carlo error (an underestimate on autocorrelated chains; thin
    first or treat as a lower bound)."""
    pointwise_loo: np.ndarray    # (K,)
    se_mc: np.ndarray            # (K,)
    point_index: np.ndarray      # (K,) band indices refit-assessed
    nsamples: int                # posterior draws per refit
    band_names: list | None = None

    @property
    def elpd_loo(self):
        """Sum over the assessed points (only comparable to a PSIS
        elpd_loo computed over the SAME point set)."""
        return float(np.sum(self.pointwise_loo))

    def __repr__(self):
        return (f"ExactLooResult({self.pointwise_loo.size} refit bands, "
                f"elpd={self.elpd_loo:.3f}, n={self.nsamples})")


@dataclasses.dataclass
class LooComparison:
    """Paired elpd difference between two models on the SAME data.

    elpd_diff > 0 favors model A. The standard error is the PAIRED one
    (sqrt(n var(diff_i)) over shared points -- pointwise differences
    cancel shared noise, so this is much tighter than differencing the
    two models' own se_elpd_loo); |elpd_diff| < ~2 se_diff means the
    data cannot distinguish the models' predictive accuracy."""
    elpd_diff: float
    se_diff: float
    pointwise_diff: np.ndarray     # (npoints,) elpd_a_i - elpd_b_i
    point_index: np.ndarray
    n_points: int

    @property
    def favored(self):
        """'A', 'B', or 'neither' at the 2-sigma paired level."""
        if not np.isfinite(self.se_diff) or (abs(self.elpd_diff)
                                             <= 2.0 * self.se_diff):
            return "neither"
        return "A" if self.elpd_diff > 0 else "B"

    def __repr__(self):
        return (f"LooComparison(elpd_diff={self.elpd_diff:.3f} "
                f"+- {self.se_diff:.3f} over {self.n_points} points; "
                f"favored: {self.favored})")


def compare_loo(loo_a, loo_b):
    """Paired LOO comparison of two models fit to the SAME data.

    Both arguments are LooResults whose point_index sets must agree
    (the same bands assessed -- elpd is only comparable on identical
    held-out data). Returns a LooComparison; elpd_diff > 0 means model
    A predicts held-out bands better (Vehtari, Gelman & Gabry 2017
    section 5.1: report the paired difference and its SE, never the
    difference of the separate SEs)."""
    ia = np.asarray(loo_a.point_index)
    ib = np.asarray(loo_b.point_index)
    if ia.shape != ib.shape or np.any(ia != ib):
        raise ValueError(
            f"the two assessments cover different data points "
            f"({ia.tolist()} vs {ib.tolist()}); elpd differences are "
            f"only meaningful on identical held-out data")
    diff = (np.asarray(loo_a.pointwise_loo, np.float64)
            - np.asarray(loo_b.pointwise_loo, np.float64))
    n = diff.size
    se = float(np.sqrt(n * np.var(diff, ddof=1))) if n > 1 else np.nan
    return LooComparison(elpd_diff=float(diff.sum()), se_diff=se,
                         pointwise_diff=diff, point_index=ia.copy(),
                         n_points=n)


def write_loo_group(parent, loo, name="LOO"):
    """Persist a LooResult as an HDF5 group (shared by hdf5io.py's MBB
    schema and sed.py's generic schema)."""
    g = parent.create_group(name)
    for k in ("elpd_loo", "se_elpd_loo", "p_loo", "elpd_waic",
              "se_elpd_waic", "p_waic", "nsamples"):
        g.attrs[k] = getattr(loo, k)
    g.create_dataset("PointwiseLoo", data=loo.pointwise_loo)
    g.create_dataset("PointwiseWaic", data=loo.pointwise_waic)
    g.create_dataset("PointwiseLpd", data=loo.pointwise_lpd)
    g.create_dataset("ParetoK", data=loo.pareto_k)
    g.create_dataset("PointIndex", data=loo.point_index)
    if loo.band_names is not None:
        g.create_dataset("BandNames", data=np.array(
            [n.encode() for n in loo.band_names]))


def read_loo_group(g):
    """Inverse of write_loo_group."""
    names = None
    if "BandNames" in g:
        names = [n.decode() if isinstance(n, bytes) else str(n)
                 for n in np.asarray(g["BandNames"])]
    return LooResult(
        elpd_loo=float(g.attrs["elpd_loo"]),
        se_elpd_loo=float(g.attrs["se_elpd_loo"]),
        p_loo=float(g.attrs["p_loo"]),
        elpd_waic=float(g.attrs["elpd_waic"]),
        se_elpd_waic=float(g.attrs["se_elpd_waic"]),
        p_waic=float(g.attrs["p_waic"]),
        pointwise_loo=np.asarray(g["PointwiseLoo"]),
        pointwise_waic=np.asarray(g["PointwiseWaic"]),
        pointwise_lpd=np.asarray(g["PointwiseLpd"]),
        pareto_k=np.asarray(g["ParetoK"]),
        point_index=np.asarray(g["PointIndex"]),
        nsamples=int(g.attrs["nsamples"]), band_names=names)


def write_loo_batch_group(parent, loo, name="LOO"):
    """Persist a LooBatchResult as an HDF5 group (MultiFitter /
    SEDMultiFitter writers)."""
    g = parent.create_group(name)
    g.attrs["nsamples"] = loo.nsamples
    g.create_dataset("ElpdLoo", data=loo.elpd_loo)
    g.create_dataset("SeElpdLoo", data=loo.se_elpd_loo)
    g.create_dataset("PLoo", data=loo.p_loo)
    g.create_dataset("ElpdWaic", data=loo.elpd_waic)
    g.create_dataset("SeElpdWaic", data=loo.se_elpd_waic)
    g.create_dataset("PWaic", data=loo.p_waic)
    g.create_dataset("PointwiseLoo", data=loo.pointwise_loo)
    g.create_dataset("ParetoK", data=loo.pareto_k)
    g.create_dataset("NPoints", data=loo.n_points)
    g.create_dataset("Excluded", data=loo.excluded.astype(np.uint8))


def read_loo_batch_group(g):
    """Inverse of write_loo_batch_group."""
    return LooBatchResult(
        elpd_loo=np.asarray(g["ElpdLoo"]),
        se_elpd_loo=np.asarray(g["SeElpdLoo"]),
        p_loo=np.asarray(g["PLoo"]),
        elpd_waic=np.asarray(g["ElpdWaic"]),
        se_elpd_waic=np.asarray(g["SeElpdWaic"]),
        p_waic=np.asarray(g["PWaic"]),
        pointwise_loo=np.asarray(g["PointwiseLoo"]),
        pareto_k=np.asarray(g["ParetoK"]),
        n_points=np.asarray(g["NPoints"]),
        nsamples=int(g.attrs["nsamples"]),
        excluded=np.asarray(g["Excluded"]).astype(bool))


def pointwise_loglik_matrix(fluxes_fn, samples, y, det_idx,
                            unc_det=None, cov_det=None):
    """(nsamples, ndet) pointwise log-likelihoods, one batched torch
    computation over the posterior draws on their device -- the shared
    front half of compute_loo (results.MBBResults).

    fluxes_fn: theta (n, 5) -> (n, nb) model band fluxes (the evaluation
    mode the fitted likelihood used); samples: (n, 5) fp32 tensor; y /
    det_idx: observed fluxes and the detected-band indices; unc_det /
    cov_det select the diagonal or the conditional factors
    (gaussian_pointwise_constants). Host fp64 result.
    """
    import torch
    from mbb_emcee_tpu_torch.derived import batched

    isig32, lam32, invd32, lnnorm32 = gaussian_pointwise_constants(
        unc_det=unc_det, cov_det=cov_det)
    dev = samples.device

    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    y_det = t(np.asarray(np.asarray(y)[det_idx], np.float32))
    det_j = t(np.asarray(det_idx, np.int64))
    isig, lam, invd, lnnorm = (t(a) for a in (isig32, lam32, invd32,
                                              lnnorm32))

    def one(theta):
        d = fluxes_fn(theta)[:, det_j] - y_det
        if lam is not None:
            # g = Lambda d per draw, written out (no matmul: no TF32)
            g = torch.sum(lam * d[:, None, :], dim=-1)
            return lnnorm - 0.5 * g * g * invd
        r = d * isig
        return lnnorm - 0.5 * r * r

    return batched(one, samples).double().cpu().numpy()


def gaussian_pointwise_constants(unc_det=None, cov_det=None):
    """Host fp64 -> fp32 constants for the pointwise device closures.

    Diagonal errors (unc_det): ln p(y_i|theta) = lnnorm_i - r_i^2/2 with
    r_i = (m_i - y_i)/sigma_i. Full covariance (cov_det): the conditional
    factors of the module docstring, via the precision matrix.

    Returns (isig32, lam32, inv_lam_diag32, lnnorm32):
      diagonal mode: (isig, None, None, lnnorm)
      covariance mode: (None, Lambda, 1/diag(Lambda), lnnorm)
    """
    ln2pi = np.log(2.0 * np.pi)
    if (unc_det is None) == (cov_det is None):
        raise ValueError("give exactly one of unc_det / cov_det")
    if unc_det is not None:
        sig = np.asarray(unc_det, np.float64)
        lnnorm = -np.log(sig) - 0.5 * ln2pi
        return (np.asarray(1.0 / sig, np.float32), None, None,
                np.asarray(lnnorm, np.float32))
    lam = np.linalg.inv(np.asarray(cov_det, np.float64))
    dlam = np.diag(lam)
    lnnorm = 0.5 * (np.log(dlam) - ln2pi)
    return (None, np.asarray(lam, np.float32),
            np.asarray(1.0 / dlam, np.float32),
            np.asarray(lnnorm, np.float32))
