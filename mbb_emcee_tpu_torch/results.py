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
device part per sample times an fp64 host prefactor.
"""

from __future__ import annotations

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import PARAM_NAMES, NPARAMS
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch import hdf5io
from mbb_emcee_tpu_torch.fitter import not_ported
from mbb_emcee_tpu_torch.likelihood import param_index
from mbb_emcee_tpu_torch.sampler import (
    autocorrelation_time, effective_sample_size, split_rhat,
    split_rhat_rank_normalized)


def _percentile_summary(samples, percentile=68.3):
    """(central, +err, -err): median and distance to the percentile bounds
    (ref: mbb_results.par_cen convention, 50 +- 34.15)."""
    p = float(percentile)
    lo, mid, hi = np.percentile(np.asarray(samples, np.float64),
                                [50.0 - p / 2, 50.0, 50.0 + p / 2])
    return np.array([mid, hi - mid, mid - lo])


class MBBResults:
    """Analysis of a finished fit (fit=...) or a reload of a persisted one
    (h5file=...), mirroring the reference's dual constructor. Derived
    quantities are computed on the fit's device (the CPU for a file)."""

    def __init__(self, fit=None, h5file=None, redshift=None,
                 cosmology=None, lumdist=None):
        if (fit is None) == (h5file is None):
            raise ValueError("give exactly one of fit= or h5file=")
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

        if fit is not None:
            self._from_fit(fit)
        else:
            self._from_h5(h5file)

    def _from_fit(self, fit):
        if fit.chain_free is None:
            raise RuntimeError("fitter has not been run")
        if self.redshift is None and fit.redshift is not None:
            self.redshift = float(fit.redshift)
        self.chain = fit.chain                    # (nwalkers, nsteps, 5)
        self.lnprobability = np.transpose(
            fit.lnprobability.double().cpu().numpy(), (1, 0))
        self.acceptance_fraction = np.asarray(fit.acceptance_fraction)
        self.shape = fit.shape
        self.phot = fit.phot
        self.param_spec = fit.spec
        self.param_init = fit._init.copy()
        self.thin = fit.thin
        self.nwalkers = int(self.chain.shape[0])
        self.response_pack = fit._response_pack()
        self.device = fit.device

    def _from_h5(self, h5file):
        explicit_z, explicit_dl = self.redshift, self.lumdist
        chosen_cosmo, chosen_name = self._cosmo, self.cosmology_name
        if not hdf5io.is_native_results_file(h5file):
            raise not_ported("reading upstream mbb_emcee HDF5 layouts",
                             "A8")
        payload = hdf5io.read_results(h5file)
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
        self.device = torch.device("cpu")

    # -- basic summaries -----------------------------------------------------------
    @property
    def flatchain(self):
        return self.chain.reshape(-1, NPARAMS)

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
        return self.flatchain[:, param_index(param)]

    def par_cen(self, param, percentile=68.3):
        """(median, +err, -err) of a parameter (ref: mbb_results.par_cen)."""
        return _percentile_summary(self.parameter_chain(param), percentile)

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

    def best_fit_model(self):
        """ModifiedBlackbody at the maximum-probability sample; evaluate it
        at any wavelength for a best-fit SED curve."""
        from mbb_emcee_tpu_torch.models.modified_blackbody import (
            ModifiedBlackbody)
        theta, _ = self.best_fit
        return ModifiedBlackbody(
            *[float(v) for v in theta], wavenorm=self.shape.wavenorm,
            noalpha=self.shape.noalpha, opthin=self.shape.opthin)

    def par_cov(self):
        """(names, cov): covariance of the FREE parameters over the
        flattened chain (observer frame)."""
        idx = self.param_spec.free_indices
        names = [PARAM_NAMES[i] for i in idx]
        cov = np.atleast_2d(np.cov(self.flatchain[:, idx].T))
        return names, cov

    def _samples(self, thin):
        """Thinned flat chain as an fp32 tensor on the results' device."""
        flat = self.flatchain[::max(int(thin), 1)]
        return torch.as_tensor(np.asarray(flat, np.float32),
                               device=self.device)

    def sed_percentiles(self, waves, percentile=68.3, thin=1):
        """(3, nwave) [median, upper, lower] of f_nu in mJy at the observed
        wavelengths `waves` (micron) over the (thinned) chain."""
        w = torch.as_tensor(np.atleast_1d(np.asarray(waves, np.float32)),
                            device=self.device)
        sed = derived.sed_eval(self.shape, w)
        fluxes = derived.batched(sed, self._samples(thin))
        return derived.sed_band(fluxes.double().cpu().numpy(), percentile,
                                sample_axis=0)

    @property
    def free_param_names(self):
        return [PARAM_NAMES[i] for i in self.param_spec.free_indices]

    def _free_chain(self):
        """(nsteps, nwalkers, nfree): the sampler's layout."""
        idx = self.param_spec.free_indices
        return np.transpose(self.chain[:, :, idx], (1, 0, 2))

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

    def autocorrelation_time(self):
        """Per-free-parameter integrated autocorrelation time in steps."""
        return autocorrelation_time(self._free_chain())

    def posterior_predictive(self, *args, **kwargs):
        raise not_ported("posterior_predictive (PPC)", "A9")

    def compute_loo(self, *args, **kwargs):
        raise not_ported("compute_loo (WAIC + PSIS-LOO)", "A9")

    def plot_sed(self, **kw):
        raise not_ported("plotting", "A10")

    plot_corner = plot_chain = plot_ppc = plot_sed

    # -- cosmology helpers -----------------------------------------------------------
    def _dl_mpc(self):
        if self.lumdist is not None:
            return self.lumdist
        if self.redshift is None:
            raise RuntimeError(
                "redshift (or explicit lumdist) required for derived "
                "physical quantities")
        return luminosity_distance(self.redshift, self._cosmo)

    def _opz(self):
        if self.redshift is None:
            raise RuntimeError("redshift required")
        return 1.0 + self.redshift

    # -- L_IR -----------------------------------------------------------------------
    def compute_lir(self, wavemin=8.0, wavemax=1000.0, thin=1):
        """Posterior of L_IR(wavemin-wavemax um REST) in L_sun."""
        lam, w = derived.lir_nodes_weights(self._opz(), wavemin, wavemax)
        lam_t = torch.as_tensor(lam.astype(np.float32), device=self.device)
        w_t = torch.as_tensor(w.astype(np.float32), device=self.device)
        one = derived.lir_integrand(self.shape)
        integ = derived.batched(lambda th: one(th, lam_t, w_t),
                                self._samples(thin))
        self.lir_chain = (derived.lir_prefactor(self._dl_mpc())
                          * integ.double().cpu().numpy())
        self.lir_meta = {"wavemin": float(wavemin), "wavemax": float(wavemax),
                         "thin": int(thin)}
        return self.lir_chain

    def lir_cen(self, percentile=68.3):
        if self.lir_chain is None:
            self.compute_lir()
        return _percentile_summary(self.lir_chain, percentile)

    @property
    def lir(self):
        return self.lir_cen()

    # -- dust mass ---------------------------------------------------------------------
    def compute_dustmass(self, kappa=2.64, kappa_wave=125.0, thin=1):
        """Posterior of dust mass in M_sun (kappa in m^2/kg at REST
        kappa_wave um)."""
        opz = self._opz()
        lam_obs = torch.tensor(kappa_wave * opz, dtype=torch.float32,
                               device=self.device)
        one = derived.dustmass_integrand(self.shape)
        g = derived.batched(lambda th: one(th, lam_obs), self._samples(thin))
        prefac = derived.dustmass_prefactor(self._dl_mpc(), opz, kappa,
                                            kappa_wave)
        self.dustmass_chain = prefac * g.double().cpu().numpy()
        self.dustmass_meta = {"kappa": float(kappa),
                              "kappa_wave": float(kappa_wave),
                              "thin": int(thin)}
        return self.dustmass_chain

    def dustmass_cen(self, percentile=68.3):
        if self.dustmass_chain is None:
            self.compute_dustmass()
        return _percentile_summary(self.dustmass_chain, percentile)

    @property
    def dustmass(self):
        return self.dustmass_cen()

    # -- peak wavelength ---------------------------------------------------------------
    def compute_peaklambda(self, thin=1, lo=derived.PEAK_RANGE[0],
                           hi=derived.PEAK_RANGE[1]):
        """Posterior of the OBSERVED f_nu peak wavelength in um."""
        peak = derived.peak_finder(self.shape, lo, hi)
        self.peaklambda_chain = derived.batched(
            peak, self._samples(thin)).double().cpu().numpy()
        return self.peaklambda_chain

    def peaklambda_cen(self, percentile=68.3):
        if self.peaklambda_chain is None:
            self.compute_peaklambda()
        return _percentile_summary(self.peaklambda_chain, percentile)

    @property
    def peaklambda(self):
        return self.peaklambda_cen()

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
