"""Batch-tier data handling and device-side summaries.

Torch twin of the parts of mbb_emcee_tpu/batchengine.py that the
stretch-move batch path uses (BatchEngine's data setters :183-353, the
summaries :704-843 and the derived-quantity plumbing :846-897). The JAX
engine's program cache, mesh sharding and traced-program plumbing have no
counterpart: torch runs eagerly, and the multi-source kernel takes the
whole batch in one launch.

Chains stay on the fitter's device as (S, nrec, nwalkers, nfree) tensors;
par_cen, best_fit, split-R-hat and the autocorrelation time are batched
reductions over all sources there, so a multi-GB catalog chain never has to
cross to the host for a summary.
"""

from __future__ import annotations

import numpy as np
import torch

from mbb_emcee_tpu_torch.likelihood import param_index, signed_iunc
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch.paramspace import _replace


def batched_split_rhat(chain):
    """(S, nrec, nw, nfree) chain tensor -> (S, nfree) split-R-hat, fp64:
    the batched twin of sampler.split_rhat (same formula and variance
    floor; a frozen coordinate gives NaN, never 0)."""
    c = chain.double()
    half = c.shape[1] // 2
    sp = torch.cat([c[:, :half], c[:, half:2 * half]], dim=2)
    sp = sp.transpose(1, 2)                     # (S, m, n, nfree)
    n = sp.shape[2]
    means = sp.mean(dim=2)
    w = sp.var(dim=2).mean(dim=1)
    b = n * means.var(dim=1)
    var_post = (n - 1) / n * w + b / n
    rhat = torch.sqrt(var_post / torch.clamp(w, min=1e-30))
    return torch.where(var_post <= 1e-30, torch.nan, rhat)


def batched_tau(chain, c=5.0):
    """(S, nrec, nw, nfree) chain tensor -> (S, nfree) integrated
    autocorrelation times, fp64: the batched twin of
    sampler.autocorrelation_time (FFT autocorrelation averaged over
    walkers, Sokal's adaptive window; NaN for a frozen series)."""
    nsteps = chain.shape[1]
    nfft = 1
    while nfft < 2 * nsteps:
        nfft <<= 1
    steps = torch.arange(nsteps, device=chain.device)
    out = []
    for d in range(chain.shape[3]):
        x = chain[..., d].double()
        xd = x - x.mean(dim=1, keepdim=True)
        f = torch.fft.rfft(xd, n=nfft, dim=1)
        acf = torch.fft.irfft(f * torch.conj(f), n=nfft,
                              dim=1)[:, :nsteps].mean(dim=2)   # (S, nrec)
        a0 = acf[:, :1]
        rho = acf / torch.where(a0 > 0, a0, torch.ones_like(a0))
        tau_run = 2.0 * torch.cumsum(rho, dim=1) - 1.0
        window = steps[None, :] < c * tau_run
        # the first step outside the window (argmin of the first False)
        idx = torch.where(window.all(dim=1), nsteps - 1,
                          torch.argmin(window.to(torch.int32), dim=1))
        tau = torch.gather(tau_run, 1, idx[:, None])[:, 0]
        out.append(torch.where(a0[:, 0] > 0, tau, torch.nan))
    return torch.stack(out, dim=1)


class BatchEngine:
    """Batch-tier surface shared by MultiFitter: data, upper limits, band
    correlation, and the batched summaries. Host classes carry wave/flux/
    unc, band_names/source_names/redshifts, free_space, chain_free,
    lnprobability, acceptance_fraction and _spec (ParamSpaceMixin)."""

    # -- data ------------------------------------------------------------------
    def set_data(self, wave, flux, unc, band_names=None, source_names=None,
                 redshifts=None):
        """wave: (nb,) shared wavelengths (um); flux/unc: (S, nb) mJy.

        MISSING bands are flagged with a NaN flux or a non-finite
        uncertainty in that slot: the band is carried as (flux=0, unc=inf),
        so its inverse uncertainty is exactly 0 and it contributes nothing
        to that source's likelihood, while the batch keeps one (S, nb)
        shape.

        `source_names` ((S,) catalog identifiers) and `redshifts` ((S,)
        per-source z) are optional metadata: names label the summary and
        HDF5 output, and a stored redshift vector is the default for
        compute_lir and compute_dustmass."""
        wave = np.atleast_1d(np.asarray(wave, np.float64))
        flux = np.atleast_2d(np.asarray(flux, np.float64))
        unc = np.atleast_2d(np.asarray(unc, np.float64))
        if flux.shape != unc.shape or flux.shape[1] != wave.size:
            raise ValueError(
                f"flux {flux.shape} / unc {unc.shape} must be "
                f"(S, {wave.size})")
        missing = ~np.isfinite(flux) | ~np.isfinite(unc)
        if missing.any():
            flux = np.where(missing, 0.0, flux)
            unc = np.where(missing, np.inf, unc)
            if missing.all(axis=1).any():
                bad = int(np.argwhere(missing.all(axis=1))[0, 0])
                raise ValueError(
                    f"source index {bad} has no bands at all (every "
                    f"flux/unc pair is missing)")
        if np.any(unc[~missing] <= 0):
            raise ValueError("uncertainties must be positive")
        ub = self._spec.uplim_bands
        if ub is not None and ub.ndim == 2 and self.flux is not None:
            # A per-source mask binds to source identities, not to the
            # batch geometry: a new same-shape catalog must not inherit it.
            raise ValueError(
                "a per-source upper-limit mask is set; it cannot carry "
                "over to a new batch -- call set_phot_upperlimits again "
                "after set_data")
        if ub is not None and ub.ndim == 1 and ub.size != wave.size:
            raise ValueError(
                f"existing upper-limit mask ({ub.size},) does not fit "
                f"the new data (nb={wave.size}); call "
                f"set_phot_upperlimits again")
        corr = self._band_corr
        if corr is not None and corr.shape != (wave.size, wave.size):
            raise ValueError(
                f"existing band correlation {corr.shape} does not fit "
                f"the new data (nb={wave.size}); call "
                f"set_band_correlation again")
        self.wave, self.flux, self.unc = wave, flux, unc
        self.band_names = band_names
        if source_names is not None:
            source_names = [str(n) for n in source_names]
            if len(source_names) != flux.shape[0]:
                raise ValueError("need one source name per source")
        self.source_names = source_names
        if redshifts is not None:
            redshifts = np.asarray(redshifts, np.float64).ravel()
            if redshifts.size != flux.shape[0]:
                raise ValueError("need one redshift per source")
        self.redshifts = redshifts
        return self

    def set_phot_upperlimits(self, mask):
        """Flag bands whose flux column is an UPPER LIMIT (one-sided
        Gaussian penalty above it): a shared (nb,) mask or a per-source
        (S, nb) one. The mask rides the SIGN of the inverse-uncertainty
        operand (likelihood.signed_iunc)."""
        if self.wave is None:
            raise RuntimeError("no data; call set_data first")
        mask = np.asarray(mask, bool)
        nb = self.wave.size
        if mask.shape not in ((nb,), (self.nsources, nb)):
            raise ValueError(
                f"upper-limit mask must be ({nb},) or "
                f"({self.nsources}, {nb}); got {mask.shape}")
        if mask.any() and self._band_corr is not None:
            raise ValueError(
                "a band correlation is set; one-sided upper limits do "
                "not compose with correlated band errors")
        self._spec = _replace(self._spec, uplim_bands=mask)
        return self

    def set_band_correlation(self, corr):
        """Correlated band errors for the whole batch: a shared (nb, nb)
        CORRELATION matrix R (unit diagonal, positive definite), each
        source's covariance C_s = D_s R D_s with D_s = diag(unc_s). Missing
        bands are marginalized exactly (_whiten_operand). Not composable
        with photometric upper limits. None clears."""
        if corr is None:
            self._band_corr = None
            return self
        if self.wave is None:
            raise RuntimeError("no data; call set_data first")
        corr = np.asarray(corr, np.float64)
        nb = self.wave.size
        if corr.shape != (nb, nb):
            raise ValueError(
                f"correlation matrix must be ({nb}, {nb}); got {corr.shape}")
        if not np.allclose(corr, corr.T, atol=1e-10):
            raise ValueError("correlation matrix must be symmetric")
        if not np.allclose(np.diag(corr), 1.0, atol=1e-8):
            raise ValueError(
                "correlation matrix needs a unit diagonal (per-source "
                "error scales come from the catalog's unc columns); "
                "normalize a covariance with cov / sqrt(outer(d, d)), "
                "d = diag(cov)")
        try:
            np.linalg.cholesky(corr)
        except np.linalg.LinAlgError:
            raise ValueError("correlation matrix is not positive definite")
        if (self._spec.uplim_bands is not None
                and np.any(self._spec.uplim_bands)):
            raise ValueError(
                "photometric upper limits are set; one-sided likelihoods "
                "do not compose with correlated band errors")
        self._band_corr = corr.copy()
        return self

    def _iunc_operand(self):
        """(S, nb) float64 SIGNED inverse uncertainties: negative marks
        upper-limit slots, 0 marks missing bands (signed_iunc)."""
        return signed_iunc(self.unc, self._spec.uplim_bands)

    def _whiten_operand(self):
        """(S, nb, nb) float64 per-source whitening matrices W_s with
        r_s = W_s (model - flux_s): rows/cols of missing bands are zero and
        the observed block is chol(R_pp)^-1 diag(iunc_p), the exact
        marginal likelihood of each source's observed bands under
        C_s = D_s R D_s. One Cholesky per unique missing-band pattern."""
        S, nb = self.unc.shape
        iunc = signed_iunc(self.unc)                    # >= 0, 0 = missing
        present = iunc > 0
        out = np.zeros((S, nb, nb), np.float64)
        linv_cache = {}
        for s in range(S):
            p = present[s]
            key = p.tobytes()
            linv = linv_cache.get(key)
            if linv is None:
                sub = self._band_corr[np.ix_(p, p)]
                linv = np.linalg.inv(np.linalg.cholesky(sub))
                linv_cache[key] = linv
            out[s][np.ix_(p, p)] = linv * iunc[s, p][None, :]
        return out

    @property
    def nsources(self):
        if self.flux is None:
            raise RuntimeError("no data; call set_data")
        return self.flux.shape[0]

    # -- summaries -------------------------------------------------------------
    def _require_run(self):
        if self.chain_free is None:
            raise RuntimeError("run() has not been called")

    @property
    def chain(self):
        """(S, nwalkers, nrec, 5) full-parameter chains (reference layout
        per source), host numpy."""
        self._require_run()
        full = self.free_space.expand(self.chain_free.double().cpu().numpy())
        return np.transpose(full, (0, 2, 1, 3))

    def flatchain(self):
        """(S, nrec * nwalkers, 5), host numpy."""
        self._require_run()
        free = self.chain_free.double().cpu().numpy()
        return self.free_space.expand(
            free.reshape(free.shape[0], -1, self.free_space.nfree))

    @property
    def free_param_names(self):
        """Free-parameter names in chain-column order."""
        if self.free_space is None:
            raise RuntimeError("no fit yet (run() sets the free-parameter "
                               "space)")
        from mbb_emcee_tpu_torch.constants import PARAM_NAMES
        return [PARAM_NAMES[i] for i in self.free_space.free_idx]

    def par_cen(self, param, percentile=68.3):
        """(S, 3): per-source (median, +err, -err), computed on the chain's
        device and interpreted under the spec the run sampled (a parameter
        fixed at run time reports its fixed value with zero errors)."""
        self._require_run()
        i = param_index(param)
        fs = self.free_space
        hit = np.nonzero(fs.free_idx == i)[0]
        if hit.size == 0:
            v = float(fs.template[i])
            return np.tile([v, 0.0, 0.0], (self.nsources, 1))
        data = self.chain_free[..., int(hit[0])].reshape(self.nsources, -1)
        srt = torch.sort(data, dim=1).values
        n = srt.shape[1]
        p = float(percentile)
        out = []
        for q in (50.0 - p / 2, 50.0, 50.0 + p / 2):
            # numpy's default (linear) percentile
            pos = q / 100.0 * (n - 1)
            lo = int(np.floor(pos))
            hi = min(lo + 1, n - 1)
            vals = srt[:, [lo, hi]].double().cpu().numpy()
            out.append(vals[:, 0] + (vals[:, 1] - vals[:, 0]) * (pos - lo))
        lo, mid, hi = out
        return np.stack([mid, hi - mid, mid - lo], axis=1)

    def best_fit(self):
        """(params (S, 5), lnprob (S,)) at each source's max-lnp sample."""
        self._require_run()
        S = self.nsources
        lnp = self.lnprobability.reshape(S, -1)
        idx = torch.argmax(lnp, dim=1)
        free = self.chain_free.reshape(S, -1, self.free_space.nfree)
        best_free = free[torch.arange(S, device=free.device), idx]
        best_lnp = lnp[torch.arange(S, device=lnp.device), idx]
        return (self.free_space.expand(best_free.double().cpu().numpy()),
                best_lnp.double().cpu().numpy())

    def gelman_rubin(self, window=None, stride=None):
        """(S, nfree) split-R-hat per source, one batched reduction on the
        chain's device. `stride` subsamples every stride-th record first;
        `window` keeps the last `window` records (the serving loop's
        fixed-shape predicate, cli_batch --extend-until)."""
        self._require_run()
        ch = self.chain_free
        if stride is not None:
            ch = ch[:, ::max(int(stride), 1)]
        if window is not None:
            ch = ch[:, -int(window):]
        if int(ch.shape[1]) // 2 < 2:
            raise ValueError("need at least 4 recorded steps")
        return batched_split_rhat(ch).cpu().numpy()

    def autocorrelation_time(self, window=None):
        """(S, nfree) integrated autocorrelation times, one batched FFT
        reduction; `window` restricts to the last `window` records."""
        self._require_run()
        ch = self.chain_free
        if window is not None:
            ch = ch[:, -int(window):]
        return batched_tau(ch).cpu().numpy()

    def converged(self, rhat_max=1.1, window=None, tau_mult=None,
                  stride=None):
        """(S,) boolean mask: every free parameter's split-R-hat below
        `rhat_max`; with `tau_mult`, also a recorded chain at least
        tau_mult x each source's largest autocorrelation time (the length
        is the whole recorded chain; only the tau estimate uses the
        window)."""
        ok = np.all(self.gelman_rubin(window=window, stride=stride)
                    < float(rhat_max), axis=1)
        if tau_mult is not None:
            tau = self.autocorrelation_time(window=window)
            nrec = int(self.chain_free.shape[1])
            ok = ok & (nrec >= float(tau_mult)
                       * np.nanmax(np.nan_to_num(tau, nan=1.0), axis=1))
        return ok

    # -- derived-quantity plumbing ---------------------------------------------
    def _source_redshifts(self, redshifts):
        """The per-source redshift vector: the argument, else the one
        stored by set_data()."""
        if redshifts is None:
            redshifts = self.redshifts
        if redshifts is None:
            raise ValueError(
                "no redshifts: pass redshifts= or store them via "
                "set_data(..., redshifts=...)")
        z = np.asarray(redshifts, np.float64).ravel()
        if z.size != self.nsources:
            raise ValueError("need one redshift per source")
        return z

    def _dl_mpc(self, redshifts, lumdists=None, cosmology="WMAP9"):
        if lumdists is not None:
            return np.asarray(lumdists, np.float64)
        cosmo = (Cosmology.named(cosmology)
                 if isinstance(cosmology, str) else cosmology)
        return np.array([luminosity_distance(float(z), cosmo)
                         for z in np.asarray(redshifts).ravel()])

    def _thinned(self, thin):
        """(S, nsamp, 5) fp32 thinned full-parameter samples on the chain's
        device."""
        self._require_run()
        fs = self.free_space
        free = self.chain_free.reshape(self.nsources, -1, fs.nfree)
        free = free[:, ::max(int(thin), 1)]
        full = torch.as_tensor(np.asarray(fs.template, np.float32),
                               device=free.device).expand(
            free.shape[:2] + (len(fs.template),)).clone()
        full[..., torch.as_tensor(fs.free_idx, device=free.device)] = \
            free.to(torch.float32)
        return full

    @staticmethod
    def _chunked_samples(fn, samples, inner_elems):
        """fn over (S, N, 5) samples in sample-axis chunks (about 64M
        elements of intermediates each, `inner_elems` = per-sample fan-out
        such as quadrature nodes), as (S, N, ...) host fp64."""
        S, N = samples.shape[:2]
        chunk = max(1, (64 << 20) // max(S * inner_elems, 1))
        out = [fn(samples[:, i:i + chunk]).double().cpu().numpy()
               for i in range(0, N, chunk)]
        return np.concatenate(out, axis=1)
