"""Batched catalog fitting for GENERIC models: SEDMultiFitter.

Torch twin of mbb_emcee_tpu/sedmulti.py, the generic-model analog of
multifit.MultiFitter: one user SEDModel (sed.py) fit to S independent
sources in lockstep. Every sampling phase is one call of the plain multi
run (sampler.multi_stretch_run_plain) on sed.build_sed_lnprob_data, the
model's fnu vmapped over sources x walkers on the fitter's device; source
s draws the Philox stream of source s, as MultiFitter's source s does. The
hand-written kernels are specialized to the 5-parameter MBB, so this path
launches none of them (the JAX package likewise runs only its XLA stretch
tier here).

The serving surface is MultiFitter's, through the shared engine
(batchengine.BatchEngine): ragged catalogs via NaN-flagged missing bands,
shared or per-source photometric upper limits riding the sign of the
inverse uncertainty, correlated calibration errors as per-source whitening
matrices (set_band_correlation), the run / extend / checkpoint protocol
(run(n1) + extend(n2) is run(n1 + n2) bit for bit), device-side summaries,
PT, HMC, MAP + Laplace, nested evidence, PPC and LOO. This module adds the
generic-model hooks: the SEDModel likelihood, PER-SOURCE Gaussian priors
riding extra operand columns (set_gaussian_prior with (S,) arrays, e.g.
spec-z anchors in a photo-z catalog), the data-driven initial guess
(SEDModel.guess), batched derived posteriors (L_IR with per-source or
sampled redshifts, peak wavelength, SED bands) and the JAX package's
sed-batch HDF5 schema (schema 1).

A photo-z catalog (photoz.photoz_mbb) needs a T prior: without CMB terms T
and z are exactly degenerate (photoz.py's module docstring).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.batchengine import BatchEngine, PlainBatchOperands
from mbb_emcee_tpu_torch.checkpoint import PRNG_IMPL, data_fingerprint
from mbb_emcee_tpu_torch.fitter import check_jax_keywords, resolve_device
from mbb_emcee_tpu_torch.likelihood import (
    FreeSpace, LikelihoodSpec, Photometry)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin
from mbb_emcee_tpu_torch.sampler import (
    MultiEnsembleSampler, MultiSamplerState)
from mbb_emcee_tpu_torch.sed import (
    SEDModel, apply_model_guess, batched_fnu, build_sed_lnprob_data,
    sed_band_flux_eval)

_SEDBATCH_SCHEMA_VERSION = 1


class SEDMultiFitter(BatchEngine, ParamSpaceMixin):
    """Fit a user SEDModel to a whole catalog, every source in lockstep.

    Usage:
        model = SEDModel(fnu=my_fnu, param_names=(...), lower=..., upper=...)
        mf = SEDMultiFitter(model, nwalkers=128, seed=3)
        mf.set_data(wave, flux_SxNb, unc_SxNb, redshifts=z)
        for name, v in zip(model.param_names, guess):
            mf.set_param_init(name, v, 0.1 * abs(v))
        mf.run(nburn=200, nsteps=600)
        while not mf.converged(window=64).all():
            mf.extend(200)
        cen = mf.par_cen("T_cold")            # (S, 3)
        lir = mf.compute_lir()                # (S, nsamples)

    device: "cuda" (the default; raises without a card) or "cpu".
    prng_impl: the JAX constructor's keyword; the port draws from
    Philox-4x32-10 and refuses another generator by name
    (fitter.check_jax_keywords). mesh: a parallel.walker_mesh over the
    source axis (batchengine.py); the fitter's device is its first, and a
    sharded run is the unsharded run bit for bit.
    With photoz.photoz_mbb, set a Gaussian prior on T: without CMB terms T
    and z are exactly degenerate.
    """

    def __init__(self, model: SEDModel, nwalkers=250, seed=207, a=2.0,
                 mesh=None, prng_impl=None, device=None):
        if not isinstance(model, SEDModel):
            raise TypeError("model must be an SEDModel")
        check_jax_keywords(prng_impl=prng_impl, jax_prng="threefry2x32")
        if mesh is not None:
            from mbb_emcee_tpu_torch.parallel.mesh import mesh_device
            device = mesh_device(mesh, device)
        self.mesh = mesh
        self.device = resolve_device(device)
        model.validate(device=self.device)
        self.model = model
        self.nwalkers = int(nwalkers)
        if self.nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self.seed = int(seed)
        self.a = float(a)
        self.prng_impl = PRNG_IMPL
        self.responses = None
        # the quadrature pack a reloaded file carries (from_h5)
        self._restored_pack = None

        self._spec = LikelihoodSpec.for_box(model.lower, model.upper)
        center = 0.5 * (model.lower + model.upper)
        self._init = center.copy()
        self._scatter = np.where(np.abs(center) > 0,
                                 0.05 * np.abs(center),
                                 0.05 * (model.upper - model.lower))
        self._user_init = np.zeros(model.npar, bool)
        self._user_scatter = np.zeros(model.npar, bool)

        self.wave = self.flux = self.unc = None
        self._band_corr = None      # (nb, nb) shared band correlation
        self.band_names = None
        self.source_names = None
        self.redshifts = None
        self.chain_free = None      # (S, nrec, nw, nfree) tensor
        self.lnprobability = None   # (S, nrec, nw) tensor
        self.acceptance_fraction = None
        self.free_space = None
        self.thin = 1
        self.final_state = None
        self._sampler = None
        self._foreign_generator = None
        self.lir_chain = self.dustmass_chain = self.peaklambda_chain = None
        self.dustmass_meta = None
        self.loo_result = None
        self.map_params = None
        self.logz_pt = self.logz_ti = None
        self.swap_fraction = self.pt_betas = None
        self.hmc_step_size = self.hmc_mass = None
        self.evidence = None
        # Per-source Gaussian priors {param name, lower case: (mean (S,),
        # isigma (S,))}, riding extra operand columns on every tier
        # (_data_operands).
        self._ps_prior = {}

    # -- ParamSpaceMixin and engine hooks ---------------------------------------------
    @property
    def _param_names(self):
        return self.model.param_names

    def _param_index(self, param):
        return self.model.param_index(param)

    def _effective_spec(self):
        return self._spec

    def _engine_label(self):
        return f"SEDMultiFitter[{self.model.name}]"

    # -- data --------------------------------------------------------------------------
    def set_responses(self, response_set):
        """Instrument response curves; requires named photometry bands."""
        self.responses = response_set
        return self

    def _response_pack(self):
        if self.responses is None:
            return self._restored_pack
        if self.band_names is None:
            raise ValueError("response mode requires named photometry bands")
        return self.responses.pack(self.band_names)

    # -- per-source Gaussian priors ------------------------------------------------------
    def set_gaussian_prior(self, param, mean, sigma):
        """Gaussian prior on a parameter. Scalars set the SHARED prior (all
        sources, ParamSpaceMixin's semantics). (S,)-shaped mean and/or
        sigma set a PER-SOURCE prior instead -- spec-z anchors inside a
        photo-z catalog, say (`set_gaussian_prior("z", z_spec, z_err)`,
        a NaN / inf / non-positive sigma disabling the prior for a source
        without one). A scalar call on the same parameter replaces its
        per-source entry (the last call wins). The prior applies to FREE
        parameters; fixing the parameter later raises at run time."""
        if np.ndim(mean) == 0 and np.ndim(sigma) == 0:
            # the canonical name: the per-source entry clears however the
            # parameter is addressed
            name = self.model.param_names[self._param_index(param)]
            self._ps_prior.pop(name.lower(), None)
            return super().set_gaussian_prior(param, mean, sigma)
        if self.flux is None:
            raise RuntimeError(
                "per-source priors need the catalog size; call set_data "
                "first")
        S = self.nsources
        name = self.model.param_names[self._param_index(param)].lower()
        mean = np.broadcast_to(np.asarray(mean, np.float64), (S,)).copy()
        sigma = np.broadcast_to(np.asarray(sigma, np.float64), (S,)).copy()
        on = np.isfinite(sigma) & (sigma > 0)
        if not np.isfinite(mean[on]).all():
            raise ValueError(
                f"per-source prior means for {param!r} must be finite "
                "wherever sigma is finite and positive")
        isig = np.where(on, 1.0 / np.where(on, sigma, 1.0), 0.0)
        # an inert mean is zeroed, for a stable fingerprint
        self._ps_prior[name] = (np.where(on, mean, 0.0), isig)
        return self

    def _ps_prior_free(self, free_space):
        """(pmean, pisig) as (S, nfree) fp64 arrays in free-space column
        order, or None without per-source priors."""
        if not self._ps_prior:
            return None
        S = self.nsources
        free_names = [self.model.param_names[i].lower()
                      for i in free_space.free_idx]
        pm = np.zeros((S, free_space.nfree), np.float64)
        pi = np.zeros((S, free_space.nfree), np.float64)
        for name, (mean, isig) in self._ps_prior.items():
            if name not in free_names:
                raise ValueError(
                    f"per-source prior on {name!r} needs that parameter "
                    "free, but it is fixed")
            if mean.shape[0] != S:
                raise ValueError(
                    f"per-source prior on {name!r} is sized for "
                    f"{mean.shape[0]} sources; the catalog has {S} -- "
                    "call set_gaussian_prior again after set_data")
            j = free_names.index(name)
            pm[:, j] = mean
            pi[:, j] = isig
        return pm, pi

    def _per_source_priors(self):
        return dict(self._ps_prior)

    def _shard_view(self, lo, hi, device):
        v = super()._shard_view(lo, hi, device)
        v._ps_prior = {k: (m[lo:hi], i[lo:hi])
                       for k, (m, i) in self._ps_prior.items()}
        return v

    def _ps_token(self):
        """Fingerprint-ready tuple of the per-source priors; () unused."""
        return tuple(x for name in sorted(self._ps_prior)
                     for x in (np.frombuffer(name.encode(), np.uint8),
                               *self._ps_prior[name]))

    # -- the likelihood -----------------------------------------------------------------
    def _build_lnprob_data(self, spec):
        """(fn, free_space): build_sed_lnprob_data with the per-source
        prior term. fn(theta (S, n, nfree), wave, flux, errs[, pisig]) ->
        (S, n). Without a band correlation `errs` is the signed 1/sigma; with
        one, the per-source whitening matrices. Per-source priors ride as
        trailing nfree columns: (prior mean) on the flux operand, (prior
        1/sigma) on the 1/sigma operand, or as a separate pisig operand
        beside the whitening matrices."""
        correlated = self._band_corr is not None
        fn, free_space = build_sed_lnprob_data(
            self.model, spec, response_pack=self._response_pack(),
            correlated=correlated, device=self.device)
        if not self._ps_prior:
            return fn, free_space
        self._ps_prior_free(free_space)     # validate (free, sized) early
        nb = int(self.wave.size)

        def prior(theta, pmean, pisig):
            dp = (theta - pmean[:, None, :]) * pisig[:, None, :]
            return 0.5 * torch.sum(dp * dp, dim=-1)

        if correlated:
            def lnprob(theta, wave, flux_ext, whiten, pisig):
                return (fn(theta, wave, flux_ext[:, :nb], whiten)
                        - prior(theta, flux_ext[:, nb:], pisig))
        else:
            def lnprob(theta, wave, flux_ext, iunc_ext):
                return (fn(theta, wave, flux_ext[:, :nb], iunc_ext[:, :nb])
                        - prior(theta, flux_ext[:, nb:], iunc_ext[:, nb:]))
        return lnprob, free_space

    def _data_operands(self, free_space):
        """The per-source fp32 operands on the fitter's device: (flux,
        signed 1/sigma) or (flux, whitening), extended with the per-source
        prior columns when configured."""
        def t32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=self.device)

        flux = np.asarray(self.flux, np.float64)
        ps = self._ps_prior_free(free_space)
        if ps is not None:
            flux = np.concatenate([flux, ps[0]], axis=1)
        if self._band_corr is None:
            iunc = self._iunc_operand()
            if ps is not None:
                iunc = np.concatenate([iunc, ps[1]], axis=1)
            return t32(flux), t32(iunc)
        whiten = t32(self._whiten_operand())
        if ps is None:
            return t32(flux), whiten
        return t32(flux), whiten, t32(ps[1])

    def _lnprob_operands(self, spec):
        fn, free_space = self._build_lnprob_data(spec)
        return PlainBatchOperands(
            wave=torch.as_tensor(np.asarray(self.wave, np.float32),
                                 device=self.device),
            data=self._data_operands(free_space), fn=fn,
            free_space=free_space)

    def _build_sampler(self, spec):
        """The plain multi run on this catalog's likelihood."""
        ops = self._lnprob_operands(spec)
        nfree = ops.free_space.nfree
        if self.nwalkers < 2 * nfree:
            raise ValueError(
                f"nwalkers={self.nwalkers} < 2*nfree={2 * nfree}: the "
                f"stretch move needs at least twice the dimension (prefer "
                f"many more)")
        ops.label = repr(self.model.name)       # sampler._label
        self._sampler = MultiEnsembleSampler(
            self.nsources, self.nwalkers, nfree, ops.plain, self.a,
            ops.free_space, self._source0)
        self._backend_used = "torch"
        return self._sampler

    def _band_flux_eval(self):
        fluxes = sed_band_flux_eval(self.model.fnu, self.wave,
                                    self._response_pack(), self.device)

        def batch(theta):
            return fluxes(theta.reshape(-1, theta.shape[-1])).reshape(
                theta.shape[:-1] + (-1,))
        return batch

    def _init_centers(self, init="auto"):
        """(S, npar) walker-ball centers and scatters: the configured
        initial values, or per source the model's data-driven guess
        (SEDModel.guess, through sed.apply_model_guess; explicit
        set_param_init calls and NaN guesses keep the configured values);
        init="map" is BatchEngine._map_centers."""
        if init not in ("auto", "map"):
            raise ValueError(f"init must be 'auto' or 'map'; got {init!r}")
        if init == "map":
            return self._map_centers()
        S = self.nsources
        cen = np.broadcast_to(self._init, (S, self.model.npar)).copy()
        sca = np.broadcast_to(self._scatter, (S, self.model.npar)).copy()
        if self.model.guess is not None:
            for s in range(S):
                apply_model_guess(self.model, self.wave, self.flux[s],
                                  self.unc[s], cen[s], sca[s],
                                  self._user_init, self._user_scatter)
        return cen, sca

    def _model_token(self, spec):
        """Everything the likelihood is built from besides the per-source
        data: the model, wavelengths, parameter space, response pack and
        per-source priors."""
        pack = self._response_pack()
        return (self.model.name, self.model.param_names, self.wave.tobytes(),
                data_fingerprint(spec.lower, spec.upper, spec.fixed,
                                 spec.fixed_values, spec.prior_mean,
                                 spec.prior_isigma, *self._ps_token(),
                                 *(() if pack is None else pack)))

    def _spec_fingerprint(self, spec=None):
        spec = self._spec if spec is None else spec
        uplim = (None if spec.uplim_bands is None
                 else np.asarray(spec.uplim_bands))
        return data_fingerprint(
            spec.lower, spec.upper, spec.fixed, spec.fixed_values,
            spec.prior_mean, spec.prior_isigma, uplim,
            np.asarray([self.a]), *self._ps_token(),
            np.asarray(self.model.param_names), np.asarray([self.model.name]))

    def run(self, nburn=50, nsteps=250, thin=1, recenter_burn=True,
            verbose=False, init="auto", checkpoint=None,
            checkpoint_interval=100, resume=False):
        """BatchEngine.run, with `init` in the place the JAX SEDMultiFitter
        gives it (before `checkpoint`; MultiFitter's comes last)."""
        return super().run(nburn, nsteps, thin, recenter_burn, verbose,
                           checkpoint=checkpoint,
                           checkpoint_interval=checkpoint_interval,
                           resume=resume, init=init)

    def extend(self, nsteps, verbose=False):
        """Continue every source's production run from the stored state
        (BatchEngine.extend; also after from_h5 of this package's file)."""
        if self._foreign_generator is not None:
            raise ValueError(
                f"this file's sampler state is a {self._foreign_generator!r}"
                f" generator's (another package's); mbb_emcee_tpu_torch "
                f"draws {PRNG_IMPL!r} and cannot continue its streams -- "
                f"run() afresh")
        return super().extend(nsteps, verbose)

    # -- batched derived quantities -------------------------------------------------------
    def compute_lir(self, redshifts=None, wavemin=8.0, wavemax=1000.0,
                    thin=1, lumdists=None, cosmology="WMAP9",
                    z_param=None):
        """(S, nsamples) L_IR posteriors in L_sun: per-source quadrature
        nodes (the redshifted band) through the vmapped model on the chain's
        device.

        z_param: name or index of a SAMPLED redshift parameter (photo-z
        catalogs, photoz.photoz_mbb): every sample of every source is then
        integrated over its own observed window with its own luminosity
        distance (one vectorized fp64 D_L pass); redshifts= / lumdists=
        contradict it and raise."""
        fnu = self.model.fnu
        samples = self._thinned(thin)                 # (S, N, npar)
        vmap = torch.func.vmap
        if z_param is None:
            z = self._source_redshifts(redshifts)
            lam, w = derived.lir_nodes_weights((1.0 + z)[:, None], wavemin,
                                               wavemax)
            lam_t, w_t = (torch.as_tensor(a.astype(np.float32),
                                          device=samples.device)
                          for a in (lam, w))

            def one(theta, lam_s, w_s):
                return torch.sum(w_s * fnu(theta, lam_s))

            batched = vmap(vmap(one, in_dims=(0, None, None)),
                           in_dims=(0, 0, 0))
            integ = derived._chunked_samples(
                lambda s: batched(s, lam_t, w_t), samples, lam.shape[-1])
            prefac = derived.lir_prefactor(
                self._dl_mpc(z, lumdists, cosmology))[:, None]
        else:
            if redshifts is not None or lumdists is not None:
                raise ValueError(
                    "z_param= cannot combine with redshifts=/lumdists=: "
                    "each sample carries its own redshift")
            zi = self.model.param_index(z_param)
            one_z = derived.lir_zparam_integrand(fnu, zi, wavemin, wavemax,
                                                 device=samples.device)
            integ = derived._chunked_samples(vmap(vmap(one_z)), samples,
                                             derived.LIR_NODES)
            from mbb_emcee_tpu_torch.models.cosmology import (
                luminosity_distance_batch)
            zmat = samples[..., zi].double().cpu().numpy()   # (S, N)
            prefac = derived.lir_prefactor(luminosity_distance_batch(
                zmat.ravel(), cosmology).reshape(zmat.shape))
        self.lir_chain = prefac * integ
        return self.lir_chain

    def lir_cen(self, percentile=68.3):
        if self.lir_chain is None:
            self.compute_lir()
        return derived._percentile_summary(self.lir_chain, percentile)

    def compute_peaklambda(self, thin=1, lo=derived.PEAK_RANGE[0],
                           hi=derived.PEAK_RANGE[1]):
        """(S, nsamples) observed f_nu peak wavelengths (um): golden-section
        in ln lambda on log f_nu, one vmapped row per sample."""
        from mbb_emcee_tpu_torch.ops.rootfind import golden_max
        fnu = self.model.fnu
        samples = self._thinned(thin)
        ulo, uhi = (torch.tensor(float(np.log(v)), dtype=torch.float32,
                                 device=samples.device) for v in (lo, hi))

        def peak(theta):
            def logf(u):
                lam = torch.exp(u)
                f = fnu(theta, lam[None] if lam.dim() == 0 else lam)
                return torch.log(torch.clamp(f, min=1e-30)).reshape(())
            um, _ = golden_max(logf, ulo, uhi, iters=derived.PEAK_ITERS)
            return torch.exp(um)

        vmap = torch.func.vmap
        self.peaklambda_chain = derived._chunked_samples(
            vmap(vmap(peak)), samples, 8)
        return self.peaklambda_chain

    def peaklambda_cen(self, percentile=68.3):
        if self.peaklambda_chain is None:
            self.compute_peaklambda()
        return derived._percentile_summary(self.peaklambda_chain, percentile)

    def sed_percentiles(self, waves, percentile=68.3, thin=1):
        """(S, 3, nwave) per-source posterior SED bands [median, upper,
        lower] in mJy at observed wavelengths `waves` (um)."""
        samples = self._thinned(thin)
        w = torch.as_tensor(np.atleast_1d(np.asarray(waves, np.float32)),
                            device=samples.device)
        fnu = batched_fnu(self.model.fnu)

        def fn(th):
            return fnu(th.reshape(-1, th.shape[-1]), w).reshape(
                th.shape[:2] + (w.numel(),))
        fluxes = derived._chunked_samples(fn, samples, w.numel())
        return derived.sed_band(fluxes, percentile, sample_axis=1)

    # -- persistence -----------------------------------------------------------------------
    def writeToHDF5(self, filename):
        """The whole batch in the JAX package's kind='sed-batch' schema
        (schema 1), readable by either package's SEDMultiFitter.from_h5.
        A stretch-move run also stores its continuation state (the Philox
        key and stream position with the accept counters; the last chain
        record is the positions), so a reload here can extend(); the JAX
        package reads the chains and refuses to continue another
        generator's streams, and so does this one."""
        import h5py
        from mbb_emcee_tpu_torch import hdf5io
        self._require_run()
        spec = getattr(self, "_run_spec", None) or self._spec
        with h5py.File(filename, "w") as f:
            f.attrs["schema_version"] = _SEDBATCH_SCHEMA_VERSION
            f.attrs["package"] = "mbb_emcee_tpu_torch"
            f.attrs["kind"] = "sed-batch"
            f.attrs["model_name"] = self.model.name.encode()
            f.attrs["param_names"] = np.array(
                [n.encode() for n in self.model.param_names])
            f.attrs["nwalkers"] = self.nwalkers
            f.attrs["thin"] = self.thin
            f.attrs["seed"] = self.seed
            f.attrs["a"] = self.a
            f.attrs["prng_impl"] = self.prng_impl.encode()
            f.attrs["mesh_token"] = self._mesh_token().encode()
            f.create_dataset("ChainFree", data=self.chain_free.cpu().numpy()
                             .astype(np.float32), compression="gzip")
            f.create_dataset("LnProbability",
                             data=self.lnprobability.cpu().numpy()
                             .astype(np.float32), compression="gzip")
            f.create_dataset("AcceptanceFraction", data=np.asarray(
                self.acceptance_fraction, np.float32))
            st = self.final_state
            if st is not None:
                # HMC / PT chains are not continuable and store none
                g = f.create_group("PhiloxState")
                g.attrs["prng_impl"] = PRNG_IMPL
                g.create_dataset("Key", data=np.uint64(st.seed
                                                       & (2 ** 64 - 1)))
                g.create_dataset("Step", data=np.int64(st.step))
                g.create_dataset("NAccept", data=st.naccept.cpu().numpy()
                                 .astype(np.int64))
                g.create_dataset("NSteps", data=np.int64(st.nsteps))
            f.create_dataset("Wave", data=self.wave)
            f.create_dataset("Flux", data=self.flux)
            f.create_dataset("Unc", data=self.unc)
            if self.band_names is not None:
                f.create_dataset("BandNames", data=np.array(
                    [str(n).encode() for n in self.band_names]))
            pack = self._response_pack()
            if pack is not None:
                g = f.create_group("ResponsePack")
                g.create_dataset("Nodes", data=pack[0])
                g.create_dataset("Weights", data=pack[1])
            if self.source_names is not None:
                f.create_dataset("SourceNames", data=np.array(
                    [n.encode() for n in self.source_names]))
            if self.redshifts is not None:
                f.create_dataset("Redshifts", data=self.redshifts)
            pc = f.create_group("ParamConfig")
            pc.create_dataset("Lower", data=spec.lower)
            pc.create_dataset("Upper", data=spec.upper)
            pc.create_dataset("Fixed", data=spec.fixed.astype(np.uint8))
            pc.create_dataset("FixedValues", data=spec.fixed_values)
            pc.create_dataset("PriorMean", data=spec.prior_mean)
            pc.create_dataset("PriorInvSigma", data=spec.prior_isigma)
            pc.create_dataset("Initial", data=self._init)
            pc.create_dataset("InitScatter", data=self._scatter)
            pc.create_dataset("UserInit",
                              data=self._user_init.astype(np.uint8))
            pc.create_dataset("UserScatter",
                              data=self._user_scatter.astype(np.uint8))
            if spec.uplim_bands is not None:
                pc.create_dataset("PhotUpperLimits", data=np.asarray(
                    spec.uplim_bands, np.uint8))
            if self._band_corr is not None:
                pc.create_dataset("BandCorrelation", data=self._band_corr)
            if self._ps_prior:
                names = sorted(self._ps_prior)
                pg = pc.create_group("PerSourcePriors")
                pg.attrs["params"] = np.array([n.encode() for n in names])
                pg.create_dataset("Mean", data=np.stack(
                    [self._ps_prior[n][0] for n in names]))
                pg.create_dataset("InvSigma", data=np.stack(
                    [self._ps_prior[n][1] for n in names]))
            if self.lir_chain is not None:
                f.create_dataset("LIRChain", data=self.lir_chain,
                                 compression="gzip")
            if self.dustmass_chain is not None:
                ds = f.create_dataset("DustMassChain",
                                      data=self.dustmass_chain,
                                      compression="gzip")
                for k, v in (self.dustmass_meta or {}).items():
                    ds.attrs[k] = v
            if self.peaklambda_chain is not None:
                f.create_dataset("PeakLambdaChain",
                                 data=self.peaklambda_chain,
                                 compression="gzip")
            if self.loo_result is not None:
                from mbb_emcee_tpu_torch.modelcheck import (
                    write_loo_batch_group)
                write_loo_batch_group(f, self.loo_result)
            if self.map_params is not None:
                hdf5io.write_map_group(
                    f, self.map_params, self.map_lnprob, self.map_cov,
                    self.map_sigma, self.map_interior, self.map_grad_norm)
        return filename

    @classmethod
    def from_h5(cls, filename, model: SEDModel, mesh=None, device=None):
        """Restore a batch fit of either package (summaries, derived
        quantities, PPC, LOO, per-source views); extend() continues this
        package's stretch-move runs and refuses another generator's. The
        model must match the stored parameter names and model name. A file
        written under any mesh reloads under any mesh= or none (its
        mesh_token is a record: the Philox streams do not depend on the
        partitioning)."""
        import h5py

        def text(v):
            return v.decode() if isinstance(v, bytes) else str(v)

        with h5py.File(filename, "r") as f:
            if text(f.attrs.get("kind", b"")) != "sed-batch":
                raise ValueError(f"{filename} is not an SEDMultiFitter "
                                 f"file")
            stored_names = tuple(text(n) for n in f.attrs["param_names"])
            stored_model = text(f.attrs["model_name"])
            if tuple(model.param_names) != stored_names:
                raise ValueError(
                    f"model {model.name!r} has parameters "
                    f"{model.param_names}; file stores {stored_names}")
            if model.name != stored_model:
                raise ValueError(
                    f"file was written by model {stored_model!r}, got "
                    f"{model.name!r}")
            mf = cls(model, nwalkers=int(f.attrs["nwalkers"]),
                     seed=int(f.attrs["seed"]), a=float(f.attrs["a"]),
                     mesh=mesh, device=device)
            pc = f["ParamConfig"]
            mf._spec = LikelihoodSpec(
                lower=np.asarray(pc["Lower"], np.float64),
                upper=np.asarray(pc["Upper"], np.float64),
                fixed=np.asarray(pc["Fixed"], bool),
                fixed_values=np.asarray(pc["FixedValues"], np.float64),
                prior_mean=np.asarray(pc["PriorMean"], np.float64),
                prior_isigma=np.asarray(pc["PriorInvSigma"], np.float64),
                uplim_bands=(np.asarray(pc["PhotUpperLimits"], bool)
                             if "PhotUpperLimits" in pc else None))
            mf._init = np.asarray(pc["Initial"], np.float64)
            mf._scatter = np.asarray(pc["InitScatter"], np.float64)
            if "UserInit" in pc:
                mf._user_init = np.asarray(pc["UserInit"], bool)
                mf._user_scatter = np.asarray(pc["UserScatter"], bool)
            if "BandCorrelation" in pc:
                mf._band_corr = np.asarray(pc["BandCorrelation"],
                                           np.float64)
            if "PerSourcePriors" in pc:
                pg = pc["PerSourcePriors"]
                pm = np.asarray(pg["Mean"], np.float64)
                pi = np.asarray(pg["InvSigma"], np.float64)
                mf._ps_prior = {text(n): (pm[k], pi[k])
                                for k, n in enumerate(pg.attrs["params"])}
            mf.wave = np.asarray(f["Wave"], np.float64)
            mf.flux = np.asarray(f["Flux"], np.float64)
            mf.unc = np.asarray(f["Unc"], np.float64)
            mf.band_names = ([text(n) for n in f["BandNames"][()]]
                             if "BandNames" in f else None)
            if "ResponsePack" in f:
                mf._restored_pack = (
                    np.asarray(f["ResponsePack"]["Nodes"]),
                    np.asarray(f["ResponsePack"]["Weights"]))
            mf.source_names = ([text(n) for n in f["SourceNames"][()]]
                               if "SourceNames" in f else None)
            mf.redshifts = (np.asarray(f["Redshifts"], np.float64)
                            if "Redshifts" in f else None)
            mf.thin = int(f.attrs["thin"])
            mf.chain_free = torch.as_tensor(
                np.asarray(f["ChainFree"], np.float32), device=mf.device)
            mf.lnprobability = torch.as_tensor(
                np.asarray(f["LnProbability"], np.float32),
                device=mf.device)
            mf.acceptance_fraction = np.asarray(f["AcceptanceFraction"],
                                                np.float64)
            state = None
            if "PhiloxState" in f:
                g = f["PhiloxState"]
                state = MultiSamplerState(
                    pos=mf.chain_free[:, -1].contiguous(),
                    lnp=mf.lnprobability[:, -1].contiguous(),
                    naccept=torch.as_tensor(
                        np.asarray(g["NAccept"]).astype(np.int32),
                        device=mf.device),
                    nsteps=int(np.asarray(g["NSteps"])),
                    seed=int(np.asarray(g["Key"])),
                    step=int(np.asarray(g["Step"])))
            elif "Keys" in f:
                # the JAX package's per-source PRNG keys
                mf._foreign_generator = text(f.attrs["prng_impl"])
            for ds, attr in (("LIRChain", "lir_chain"),
                             ("PeakLambdaChain", "peaklambda_chain")):
                if ds in f:
                    setattr(mf, attr, np.asarray(f[ds], np.float64))
            if "DustMassChain" in f:
                mf.dustmass_chain = np.asarray(f["DustMassChain"],
                                               np.float64)
                mf.dustmass_meta = {k: f["DustMassChain"].attrs[k]
                                    for k in f["DustMassChain"].attrs}
            if "LOO" in f:
                from mbb_emcee_tpu_torch.modelcheck import (
                    read_loo_batch_group)
                mf.loo_result = read_loo_batch_group(f["LOO"])
            if "MAPFit" in f:
                g = f["MAPFit"]
                mf.map_params = np.asarray(g["Params"], np.float64)
                mf.map_lnprob = np.asarray(g["LnProb"], np.float64)
                mf.map_cov = np.asarray(g["Cov"], np.float64)
                mf.map_sigma = np.asarray(g["Sigma"], np.float64)
                mf.map_interior = np.asarray(g["Interior"], bool)
                mf.map_grad_norm = np.asarray(g["GradNorm"], np.float64)
                mf._record_map(mf._effective_spec())
        spec = mf._effective_spec()
        mf._run_spec = spec
        mf.free_space = FreeSpace.from_spec(spec)
        if state is not None:
            mf._build_sampler(spec)
            mf.final_state = state
            mf._run_data = (mf.flux.copy(), mf.unc.copy(), mf.wave.copy())
            mf._post_token = mf._posterior_token(spec)
        return mf

    # -- single-source views -----------------------------------------------------------
    def results(self, i, redshift=None, cosmology="WMAP9", lumdist=None):
        """A full SEDResults for source i -- summaries, SED bands, L_IR and
        peak-lambda posteriors, PPC, LOO, writeToHDF5 -- on the chain's
        device. `redshift` defaults to the per-source vector stored by
        set_data()."""
        from mbb_emcee_tpu_torch.sed import SEDResults
        self._require_run()
        i = int(i)
        if not 0 <= i < self.nsources:
            raise IndexError(f"source index {i} out of range "
                             f"(nsources={self.nsources})")
        if redshift is None and self.redshifts is not None:
            redshift = float(self.redshifts[i])
        return SEDResults(fit=_SEDSourceView(self, i), redshift=redshift,
                          cosmology=cosmology, lumdist=lumdist)

    def __repr__(self):
        if self.flux is None:
            return f"SEDMultiFitter[{self.model.name}] (no data)"
        run = ("not run" if self.chain_free is None
               else f"{self.chain_free.shape[1]} recorded steps")
        return (f"SEDMultiFitter[{self.model.name}]: {self.nsources} "
                f"sources x {self.nwalkers} walkers, {run}")


class _SEDSourceView:
    """One source of an SEDMultiFitter presented as a finished SEDFitter
    (the attribute surface SEDResults._from_fit reads)."""

    def __init__(self, mf: SEDMultiFitter, i: int):
        self.model = mf.model
        self.device = mf.device
        self.redshift = (None if mf.redshifts is None
                         else float(mf.redshifts[i]))
        free = mf.chain_free[i].double().cpu().numpy()   # (nrec, nw, nfree)
        self.chain = np.transpose(mf.free_space.expand(free), (1, 0, 2))
        self.lnprobability = mf.lnprobability[i]
        self.acceptance_fraction = np.asarray(mf.acceptance_fraction[i])
        cov = None
        if mf._band_corr is not None:
            # this source's covariance C = D R D; a missing band is an
            # infinite-variance row and column without cross terms, the
            # limit the marginalized whitening implements
            d = mf.unc[i]
            cov = mf._band_corr * np.outer(d, d)
            miss = ~np.isfinite(d)
            if miss.any():
                cov[miss, :] = 0.0
                cov[:, miss] = 0.0
                cov[miss, miss] = np.inf
        # missing bands are (flux 0, unc inf): the analysis surface
        # excludes a band without a finite uncertainty
        self.phot = Photometry(mf.wave, mf.flux[i], mf.unc[i], cov=cov,
                               band_names=mf.band_names)
        spec = mf._effective_spec()
        ub = spec.uplim_bands
        if ub is not None and np.ndim(ub) == 2:
            spec = dataclasses.replace(spec,
                                       uplim_bands=np.asarray(ub[i], bool))
        if mf._ps_prior:
            # fold source i's per-source priors into the view's spec (a
            # product of Gaussians with any shared prior: the inverse
            # variances add, the means precision-weight), so the view
            # reports the posterior this source was sampled under
            pm = spec.prior_mean.copy()
            pi = spec.prior_isigma.copy()
            for name, (m_s, i_s) in mf._ps_prior.items():
                j = mf.model.param_index(name)
                v = pi[j] ** 2 + i_s[i] ** 2
                if v > 0:
                    pm[j] = (pm[j] * pi[j] ** 2 + m_s[i] * i_s[i] ** 2) / v
                    pi[j] = np.sqrt(v)
            spec = dataclasses.replace(spec, prior_mean=pm,
                                       prior_isigma=pi)
        self.spec = spec
        self._init = mf._init.copy()
        self.thin = mf.thin
        self.nwalkers = mf.nwalkers
        self._pack = mf._response_pack()

    def _require_run(self):
        pass

    def _response_pack(self):
        return self._pack
