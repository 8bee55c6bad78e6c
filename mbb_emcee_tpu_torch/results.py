"""Posterior analysis and derived physical quantities.

Torch twin of mbb_emcee_tpu/results.py (the reference's mbb_results): every
derived quantity is one batched torch computation over the whole (thinned)
chain, on the chain's device:

  * L_IR(8-1000 um rest): fixed-node Gauss-Legendre in ln-lambda of
    f_nu c/lambda^2 over observed lambda in [wmin, wmax]*(1+z),
    L = 4 pi D_L^2 F_obs.
  * Dust mass: M = D_L^2 S_obs(lambda_kappa (1+z)) /
    ((1+z) kappa B_nu(nu_rest, T (1+z))), kappa = 2.64 m^2/kg at 125 um.
  * Peak wavelength: fixed-iteration golden-section maximization of f_nu in
    ln-lambda.

Large cosmological prefactors overflow fp32, so each formula is an fp32
device part per sample times an fp64 host prefactor. On a CUDA device the
device part is one launch of the derived kernel (ops/derived_kernel.py);
on the CPU it is derived.py's plain path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import PARAM_NAMES
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch import hdf5io
from mbb_emcee_tpu_torch.derived import (
    DevicePart, _percentile_summary, derived_summary)
from mbb_emcee_tpu_torch.fitter import resolve_device
from mbb_emcee_tpu_torch.likelihood import param_index
from mbb_emcee_tpu_torch.ops.derived_kernel import (
    device_part, dustmass_operands, lir_operands, peak_operands)
from mbb_emcee_tpu_torch.sampler import (
    autocorrelation_time, effective_sample_size, split_rhat,
    split_rhat_rank_normalized)
from mbb_emcee_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass
class PPCResult:
    """Posterior-predictive check (MBBResults.posterior_predictive).

    `p_value` is ~uniform on (0,1) when the model describes the data;
    values below ~0.01 flag misfit, values above ~0.99 overestimated
    errors. `band_p` localizes which band misfits (entries near 0 or 1)."""
    p_value: float          # P[T_rep >= T_obs] over the thinned chain
    band_p: np.ndarray      # (nb,) tail prob per band; NaN when excluded
    chi2_obs: np.ndarray    # (nsamples,) whitened chi-sq of the observed data
    chi2_rep: np.ndarray    # (nsamples,) chi-sq of replicated data
    ndata: int              # detected bands entering the statistic
    nfree: int              # free parameters (dof reference: ndata - nfree)
    nsamples: int           # thinned chain samples used
    uplim_bands: np.ndarray  # (nb,) bool; True bands excluded from chi-sq
    band_names: list | None = None

    def __repr__(self):
        labels = (self.band_names if self.band_names is not None
                  else [f"band{i}" for i in range(self.band_p.size)])
        flagged = [f"{n}={p:.3f}" for n, p in zip(labels, self.band_p)
                   if np.isfinite(p) and (p < 0.01 or p > 0.99)]
        extra = ("; suspect bands: " + ", ".join(flagged)) if flagged else ""
        return (f"PPCResult(p_value={self.p_value:.3f}, "
                f"ndata={self.ndata}, nfree={self.nfree}, "
                f"nsamples={self.nsamples}{extra})")


class ChainResults:
    """What MBBResults and the generic sed.SEDResults share: summaries of a
    stored chain (nwalkers, nsteps, npar), the convergence diagnostics,
    and the model checks over it on the results' device. A subclass sets
    chain, lnprobability, phot, param_spec, response_pack, redshift,
    lumdist, _cosmo and device, and provides param_names, _param_index and
    _band_fluxes (the model's band fluxes, as the fitted likelihood saw
    them)."""

    def _setup(self, fit, h5file, redshift, cosmology, lumdist, device):
        """The dual constructor's common part: exactly one source, the
        device (the fit's by default, else the card), redshift, cosmology
        and lumdist as given, and no derived chains yet."""
        if (fit is None) == (h5file is None):
            raise ValueError("give exactly one of fit= or h5file=")
        self.device = (fit.device if fit is not None and device is None
                       else resolve_device(device))
        self.redshift = None if redshift is None else float(redshift)
        # None means "not specified": WMAP9 unless a file carries its own;
        # an explicit argument always wins over stored metadata.
        self._cosmology_explicit = cosmology is not None
        if cosmology is None:
            cosmology = "WMAP9"
        self.cosmology_name = cosmology if isinstance(cosmology, str) else None
        self._cosmo = (Cosmology.named(cosmology)
                       if isinstance(cosmology, str) else cosmology)
        self.lumdist = None if lumdist is None else float(lumdist)
        self.response_pack = None
        self.lir_chain = None
        self.lir_meta = None
        self.dustmass_chain = None
        self.dustmass_meta = None
        self.peaklambda_chain = None
        self._device_parts = {}     # quantity -> derived.DevicePart
        self.loo_result = None

    @property
    def flatchain(self):
        return self.chain.reshape(-1, self.chain.shape[-1])

    @property
    def nsteps(self):
        return self.chain.shape[1]

    @property
    def data_wave(self):
        """Photometry wavelengths (um) the fit used (ref: mbb_results data
        accessors)."""
        return self.phot.wave

    @property
    def data_flux(self):
        return self.phot.flux

    @property
    def data_flux_unc(self):
        return self.phot.unc

    def parameter_chain(self, param):
        return self.flatchain[:, self._param_index(param)]

    def par_cen(self, param, percentile=68.3):
        """(median, +err, -err) of a parameter (ref: mbb_results.par_cen)."""
        with span("mbb.results.percentiles", param=param):
            return _percentile_summary(self.parameter_chain(param),
                                       percentile)

    def par_uplim(self, param, conf=0.683):
        """One-sided upper limit at confidence conf."""
        return float(np.percentile(self.parameter_chain(param),
                                   100.0 * conf))

    def par_lowlim(self, param, conf=0.683):
        return float(np.percentile(self.parameter_chain(param),
                                   100.0 * (1.0 - conf)))

    @property
    def best_fit(self):
        """(params, lnprob) at the maximum-probability sample."""
        idx = np.unravel_index(np.argmax(self.lnprobability),
                               self.lnprobability.shape)
        return self.chain[idx[0], idx[1]], float(self.lnprobability[idx])

    def par_cov(self):
        """(names, cov): covariance of the FREE parameters over the
        flattened chain."""
        idx = self.param_spec.free_indices
        names = [self.param_names[i] for i in idx]
        cov = np.atleast_2d(np.cov(self.flatchain[:, idx].T))
        return names, cov

    @property
    def free_param_names(self):
        return [self.param_names[i] for i in self.param_spec.free_indices]

    def _thinned(self, thin):
        return self.flatchain[::max(int(thin), 1)]

    def _samples(self, thin):
        """Thinned flat chain as an fp32 tensor on the results' device."""
        return torch.as_tensor(np.asarray(self._thinned(thin), np.float32),
                               device=self.device)

    def _free_chain(self):
        """(nsteps, nwalkers, nfree): the sampler's layout."""
        idx = self.param_spec.free_indices
        return np.transpose(self.chain[:, :, idx], (1, 0, 2))

    def autocorrelation_time(self):
        """Per-free-parameter integrated autocorrelation time in steps."""
        return autocorrelation_time(self._free_chain())

    # -- goodness of fit -------------------------------------------------------------
    def _detected(self, what):
        """Indices of the bands with a proper pointwise density: present
        (finite flux and uncertainty; a batch source view carries missing
        bands as an infinite uncertainty) and not an upper limit."""
        spec = self.param_spec
        y = np.asarray(self.phot.flux, np.float64)
        unc = np.asarray(self.phot.unc, np.float64)
        uplim = (np.zeros(y.size, bool) if spec.uplim_bands is None
                 else np.asarray(spec.uplim_bands, bool))
        present = np.isfinite(y) & np.isfinite(unc) & (unc > 0)
        det_idx = np.where(present & ~uplim)[0]
        if det_idx.size == 0:
            raise RuntimeError(f"{what} needs at least one detected "
                               "(non-upper-limit) band")
        return det_idx, uplim

    def posterior_predictive(self, thin=1, seed=0):
        """Posterior-predictive goodness-of-fit check (chi-square
        discrepancy). For each thinned chain sample theta_t, with model band
        fluxes m_t (band-integrated in response mode, as the fitted
        likelihood saw them):

            T_obs(t) = |W (m_t - y_obs)|^2
            y_rep(t) = m_t + L eps_t,  eps_t ~ N(0, I)
            T_rep(t) = |eps_t|^2

        with L the Cholesky factor of the fit's error model restricted to
        the detected bands and W = L^-1 the likelihood's whitening. p_value
        = P[T_rep >= T_obs] is ~uniform under a well-specified model;
        band_p[b] = P[y_rep,b >= y_obs,b] localizes a misfit band.
        Upper-limit and missing bands are excluded (band_p NaN). One
        batched torch call over the thinned chain on the results' device;
        the normal draws come from a torch.Generator there seeded with
        `seed`. Returns a PPCResult."""
        fluxes = self._band_fluxes()
        det_idx, uplim = self._detected("posterior_predictive")
        ndet = int(det_idx.size)
        y = np.asarray(self.phot.flux, np.float64)
        dev = self.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        if self.phot.cov is not None:
            chol = np.linalg.cholesky(np.asarray(self.phot.cov, np.float64)
                                      [np.ix_(det_idx, det_idx)])
            whiten, lmat = t32(np.linalg.inv(chol)), t32(chol)

            def white(d):
                return torch.sum(whiten * d[:, None, :], dim=-1)

            def color(e):
                return torch.sum(lmat * e[:, None, :], dim=-1)
        else:
            sig = np.asarray(self.phot.unc, np.float64)[det_idx]
            isig, sig32 = t32(1.0 / sig), t32(sig)

            def white(d):
                return d * isig

            def color(e):
                return sig32 * e

        det_t = torch.as_tensor(det_idx, device=dev)
        y_det = t32(y[det_idx])
        samples = self._samples(thin)
        n = int(samples.shape[0])
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        co, cr, yr = [], [], []
        for i in range(0, n, derived.CHUNK):
            m = fluxes(samples[i:i + derived.CHUNK])[:, det_t]
            r = white(m - y_det)
            eps = torch.randn(m.shape, generator=gen, device=dev)
            co.append(torch.sum(r * r, dim=-1))
            cr.append(torch.sum(eps * eps, dim=-1))
            yr.append(m + color(eps))
        chi2_obs, chi2_rep, y_rep = (torch.cat(c).double().cpu().numpy()
                                     for c in (co, cr, yr))
        band_p = np.full(y.size, np.nan)
        band_p[det_idx] = np.mean(y_rep >= y[det_idx][None, :], axis=0)
        return PPCResult(
            p_value=float(np.mean(chi2_rep >= chi2_obs)),
            band_p=band_p, chi2_obs=chi2_obs, chi2_rep=chi2_rep,
            ndata=ndet, nfree=len(self.param_spec.free_indices),
            nsamples=n, uplim_bands=uplim,
            band_names=(list(self.phot.band_names)
                        if self.phot.band_names is not None else None))

    def compute_loo(self, thin=1):
        """WAIC + PSIS-LOO predictive assessment over the stored chain
        (modelcheck.py): elpd_loo, its WAIC twin and the per-band Pareto
        k-hat reliability diagnostic. The (nsamples x nbands) pointwise
        log-likelihood matrix is one batched torch computation over the
        thinned chain (band-integrated in response mode); the PSIS tail
        smoothing runs host-side in fp64. With a full error covariance the
        pointwise factors are the exact conditional predictive densities
        p(y_i | y_-i, theta). Upper-limit and missing bands are excluded.
        Returns (and stores as .loo_result) a modelcheck.LooResult."""
        from mbb_emcee_tpu_torch import modelcheck
        fluxes = self._band_fluxes()
        det_idx, _ = self._detected("compute_loo")
        unc = np.asarray(self.phot.unc, np.float64)
        cov_det = (None if self.phot.cov is None
                   else np.asarray(self.phot.cov, np.float64)[
                       np.ix_(det_idx, det_idx)])
        loglik = modelcheck.pointwise_loglik_matrix(
            fluxes, self._samples(thin), self.phot.flux, det_idx,
            unc_det=None if cov_det is not None else unc[det_idx],
            cov_det=cov_det)
        names = (None if self.phot.band_names is None
                 else [self.phot.band_names[i] for i in det_idx])
        self.loo_result = modelcheck.loo_from_loglik(
            loglik, point_index=det_idx, band_names=names)
        return self.loo_result

    # -- plotting --------------------------------------------------------------------
    def plot_sed(self, **kw):
        """Photometry + posterior-predictive SED band (see
        plotting.plot_sed; batched evaluation of the chain on the results'
        device)."""
        from mbb_emcee_tpu_torch import plotting
        return plotting.plot_sed(self, **kw)

    def plot_corner(self, **kw):
        """Corner plot of the free-parameter posteriors
        (see plotting.plot_corner)."""
        from mbb_emcee_tpu_torch import plotting
        return plotting.plot_corner(self, **kw)

    def plot_chain(self, **kw):
        """Per-walker trace plots (see plotting.plot_chain)."""
        from mbb_emcee_tpu_torch import plotting
        return plotting.plot_chain(self, **kw)

    def plot_ppc(self, **kw):
        """Posterior-predictive check figure: replicated vs observed
        chi-square with the p-value annotated (see plotting.plot_ppc)."""
        from mbb_emcee_tpu_torch import plotting
        return plotting.plot_ppc(self, **kw)

    # -- cosmology helpers -----------------------------------------------------------
    def _dl_mpc(self):
        if self.lumdist is not None:
            return self.lumdist
        if self.redshift is None:
            raise RuntimeError(
                "redshift (or explicit lumdist) required for derived "
                "physical quantities")
        with span("mbb.derived.distance"):
            return luminosity_distance(self.redshift, self._cosmo)

    def _opz(self):
        if self.redshift is None:
            raise RuntimeError("redshift required")
        return 1.0 + self.redshift

    def lir_cen(self, percentile=68.3):
        if self.lir_chain is None:
            self.compute_lir()
        return derived_summary(self.lir_chain, self._device_parts.get("lir"),
                               percentile)

    @property
    def lir(self):
        return self.lir_cen()

    def peaklambda_cen(self, percentile=68.3):
        if self.peaklambda_chain is None:
            self.compute_peaklambda()
        return derived_summary(self.peaklambda_chain,
                               self._device_parts.get("peaklambda"),
                               percentile)

    @property
    def peaklambda(self):
        return self.peaklambda_cen()


class MBBResults(ChainResults):
    """Analysis of a finished fit (fit=...) or a reload of a persisted one
    (h5file=...), mirroring the reference's dual constructor. Derived
    quantities, posterior-predictive checks and LOO are computed on
    `device`: by default the fit's device, and the card for a file (with no
    CUDA device a reload raises unless device="cpu" is named)."""

    param_names = PARAM_NAMES

    def __init__(self, fit=None, h5file=None, redshift=None,
                 cosmology=None, lumdist=None, device=None):
        self._setup(fit, h5file, redshift, cosmology, lumdist, device)
        self.logz_pt = None   # (lnZ, err) stepping stone, from run_pt()
        self.logz_ti = None   # (lnZ, err) thermodynamic-integration check
        self.evidence = None  # NestedResult (compute_evidence on the fitter)

        if fit is not None:
            with span("mbb.results.load"):
                self._from_fit(fit)
        else:
            self._from_h5(h5file)

    def _from_fit(self, fit):
        if fit.chain_free is None:
            raise RuntimeError("fitter has not been run")
        if self.redshift is None and fit.redshift is not None:
            self.redshift = float(fit.redshift)
        self.chain = fit.chain                    # (nwalkers, nsteps, 5)
        lnp = fit.lnprobability.double().cpu().numpy()
        count("d2h_bytes", lnp.nbytes)
        self.lnprobability = np.transpose(lnp, (1, 0))
        self.acceptance_fraction = np.asarray(fit.acceptance_fraction)
        self.shape = fit.shape
        self.phot = fit.phot
        self.param_spec = fit.spec
        self.param_init = fit._init.copy()
        self.thin = fit.thin
        self.nwalkers = int(self.chain.shape[0])
        self.response_pack = fit._response_pack()
        self.logz_pt = getattr(fit, "logz_pt", None)
        self.logz_ti = getattr(fit, "logz_ti", None)
        self.evidence = getattr(fit, "evidence", None)

    def _from_h5(self, h5file):
        explicit_z, explicit_dl = self.redshift, self.lumdist
        chosen_cosmo, chosen_name = self._cosmo, self.cosmology_name
        if hdf5io.is_sed_results_file(h5file):
            raise ValueError(f"{h5file} is an SEDResults file (a generic "
                             "model's fit): load it with sed.SEDResults")
        if hdf5io.is_native_results_file(h5file):
            payload = hdf5io.read_results(h5file)
        else:
            # A migrating user's file from upstream mbb_emcee: the
            # tolerant reconstructed-schema reader maps it into the same
            # payload, warning about every guessed name.
            from mbb_emcee_tpu_torch.legacy_h5 import read_upstream_results
            payload = read_upstream_results(h5file)
        for k, v in payload.items():
            setattr(self, k, v)
        # Constructor arguments win over stored metadata.
        if explicit_z is not None:
            self.redshift = explicit_z
        if explicit_dl is not None:
            self.lumdist = explicit_dl
        if payload.get("cosmology_name") and not self._cosmology_explicit:
            self._cosmo = Cosmology.named(payload["cosmology_name"])
            self.cosmology_name = payload["cosmology_name"]
        elif (payload.get("cosmology_params")
                and not self._cosmology_explicit):
            h0, om0, ol0 = payload["cosmology_params"]
            self._cosmo = Cosmology(H0=h0, Om0=om0, Ol0=ol0)
            self.cosmology_name = None
        else:
            self._cosmo, self.cosmology_name = chosen_cosmo, chosen_name

    def _param_index(self, param):
        return param_index(param)

    def _band_fluxes(self):
        return derived.band_flux_eval(self.shape, self.phot.wave,
                                      self.response_pack)

    def best_fit_model(self):
        """ModifiedBlackbody at the maximum-probability sample; evaluate it
        at any wavelength for a best-fit SED curve."""
        from mbb_emcee_tpu_torch.models.modified_blackbody import (
            ModifiedBlackbody)
        theta, _ = self.best_fit
        return ModifiedBlackbody(
            *[float(v) for v in theta], wavenorm=self.shape.wavenorm,
            noalpha=self.shape.noalpha, opthin=self.shape.opthin)

    def sed_percentiles(self, waves, percentile=68.3, thin=1):
        """(3, nwave) [median, upper, lower] of f_nu in mJy at the observed
        wavelengths `waves` (micron) over the (thinned) chain."""
        w = torch.as_tensor(np.atleast_1d(np.asarray(waves, np.float32)),
                            device=self.device)
        sed = derived.sed_eval(self.shape, w)
        fluxes = derived.batched(sed, self._samples(thin))
        return derived.sed_band(fluxes.double().cpu().numpy(), percentile,
                                sample_axis=0)

    def gelman_rubin(self, rank_normalized=False):
        """Split-R-hat per free parameter (rank_normalized=True: the
        Vehtari et al. 2021 bulk/tail estimator)."""
        if rank_normalized:
            return split_rhat_rank_normalized(self._free_chain())
        return split_rhat(self._free_chain())

    def effective_samples(self, kind="bulk"):
        """Per-free-parameter effective sample size of the stored chain
        (Vehtari et al. 2021 rank-normalized ESS; kind="bulk" for location
        summaries, "tail" for the 5%/95% interval endpoints)."""
        return effective_sample_size(self._free_chain(), kind=kind)

    # -- L_IR -----------------------------------------------------------------------
    def compute_lir(self, wavemin=8.0, wavemax=1000.0, thin=1):
        """Posterior of L_IR(wavemin-wavemax um REST) in L_sun."""
        with span("mbb.derived.lir"):
            integ, values = device_part(self._samples(thin)[None],
                                        lir_operands(self.shape, self._opz(),
                                                     wavemin, wavemax))
            prefac = derived.lir_prefactor(self._dl_mpc())
            self.lir_chain = prefac * integ[0]
            self._device_parts["lir"] = DevicePart(values, prefac,
                                                   self.lir_chain)
        self.lir_meta = {"wavemin": float(wavemin), "wavemax": float(wavemax),
                         "thin": int(thin)}
        return self.lir_chain

    # -- dust mass ---------------------------------------------------------------------
    def compute_dustmass(self, kappa=2.64, kappa_wave=125.0, thin=1):
        """Posterior of dust mass in M_sun (kappa in m^2/kg at REST
        kappa_wave um)."""
        with span("mbb.derived.dustmass"):
            opz = self._opz()
            g, values = device_part(self._samples(thin)[None],
                                    dustmass_operands(self.shape, opz,
                                                      kappa_wave))
            prefac = derived.dustmass_prefactor(self._dl_mpc(), opz, kappa,
                                                kappa_wave)
            self.dustmass_chain = prefac * g[0]
            self._device_parts["dustmass"] = DevicePart(values, prefac,
                                                        self.dustmass_chain)
        self.dustmass_meta = {"kappa": float(kappa),
                              "kappa_wave": float(kappa_wave),
                              "thin": int(thin)}
        return self.dustmass_chain

    def dustmass_cen(self, percentile=68.3):
        if self.dustmass_chain is None:
            self.compute_dustmass()
        return derived_summary(self.dustmass_chain,
                               self._device_parts.get("dustmass"), percentile)

    @property
    def dustmass(self):
        return self.dustmass_cen()

    # -- peak wavelength ---------------------------------------------------------------
    def compute_peaklambda(self, thin=1, lo=derived.PEAK_RANGE[0],
                           hi=derived.PEAK_RANGE[1]):
        """Posterior of the OBSERVED f_nu peak wavelength in um."""
        with span("mbb.derived.peaklambda"):
            peak, values = device_part(self._samples(thin)[None],
                                       peak_operands(self.shape, lo, hi))
            self.peaklambda_chain = peak[0]
            self._device_parts["peaklambda"] = DevicePart(
                values, None, self.peaklambda_chain)
        return self.peaklambda_chain

    # -- persistence -------------------------------------------------------------------
    def writeToHDF5(self, filename):
        """Persist everything needed to resume analysis (the JAX package's
        schema, so either package reads the file)."""
        hdf5io.write_results(filename, self)
        return filename

    def __repr__(self):
        lines = ["MBBResults:"]
        fixed = self.param_spec.fixed
        for i, name in enumerate(PARAM_NAMES):
            if fixed[i]:
                lines.append(f"  {name:8s} fixed at "
                             f"{self.param_spec.fixed_values[i]:.5g}")
            else:
                c = self.par_cen(i)
                lines.append(f"  {name:8s} {c[0]:.5g} +{c[1]:.3g} -{c[2]:.3g}")
        if self.lir_chain is not None:
            c = self.lir_cen()
            lines.append(f"  L_IR    {c[0]:.5g} +{c[1]:.3g} -{c[2]:.3g} Lsun")
        if self.dustmass_chain is not None:
            c = self.dustmass_cen()
            lines.append(f"  M_dust  {c[0]:.5g} +{c[1]:.3g} -{c[2]:.3g} Msun")
        if self.peaklambda_chain is not None:
            c = self.peaklambda_cen()
            lines.append(f"  l_peak  {c[0]:.5g} +{c[1]:.3g} -{c[2]:.3g} um")
        return "\n".join(lines)
