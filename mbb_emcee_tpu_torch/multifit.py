"""Batched multi-source fitting: the batch tier that serves a catalog.

Torch twin of mbb_emcee_tpu/multifit.py. S independent photometry sets --
sharing the model shape, parameter box/priors/fixed parameters and band
geometry, each with its own fluxes, uncertainties, missing bands, upper
limits and redshift -- are fit at once:

  * on a CUDA device each sampling phase (burn, re-burn, production,
    extend) is ONE launch of the multi-source kernel K3
    (ops/multifit_kernel.py, csrc/multifit.cu), one thread block per
    source; sampler_backend="torch" runs the plain multi run
    (sampler.multi_stretch_run_plain) instead, on any device;
  * the run protocol (burn, per-source re-center on the best walker of
    that source's final burn state, re-burn, production, checkpoint,
    resume, extend) is batchengine.BatchEngine.run, shared with the
    generic-model batch tier (sedmulti.SEDMultiFitter);
  * summaries (par_cen, best_fit, split-R-hat, tau) are batched
    reductions over all sources on the chain's device (batchengine.py);
    the derived posteriors (L_IR, dust mass, peak wavelength) are one
    launch of the derived kernel a quantity on a CUDA device
    (ops/derived_kernel.py), derived.py's plain path in chunks on the CPU;
  * run_pt and run_hmc (batchengine.py; tempering.py, hmc.py) sample the
    same catalog by parallel tempering (with per-source evidence) and by
    HMC, and compute_evidence (nested.py) gives each source's nested-
    sampling evidence, on the batch likelihood's plain version on the
    fitter's device;
  * writeToHDF5/from_h5 use the JAX package's batch schema (schema 1), so
    either package reads the other's file; results(i) is a full
    MBBResults for one source;
  * with mesh= (parallel.walker_mesh) the source axis splits over the
    mesh's devices, each block on its own device with its global source
    indices (batchengine.py), so a sharded run is the unsharded run bit
    for bit.

Randomness: the walker balls come from a torch.Generator seeded with
`seed`, in source order; the proposals from the Philox stream keyed by
fitter.philox_key(seed), one stream per source (source 0's is the
single-fit stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived, hdf5io
from mbb_emcee_tpu_torch.batchengine import BatchEngine
from mbb_emcee_tpu_torch.constants import HCOK_UM_K, NPARAMS
from mbb_emcee_tpu_torch.fitter import (
    DEFAULT_INIT, DEFAULT_SCATTER, MBBFitter, check_jax_keywords,
    resolve_device)
from mbb_emcee_tpu_torch.likelihood import (
    FreeSpace, LikelihoodSpec, Photometry)
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
from mbb_emcee_tpu_torch.ops.derived_kernel import (
    device_part, dustmass_operands, lir_operands, peak_operands)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin, _replace
from mbb_emcee_tpu_torch.sampler import MultiEnsembleSampler
from mbb_emcee_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PPCBatchResult:
    """Batched posterior-predictive check (MultiFitter.posterior_predictive).

    Per-source p-values are ~uniform on (0,1) under a well-specified model;
    in a well-calibrated S-source catalog roughly S/100 sources show
    p < 0.01 by chance -- flag outliers in the p histogram, not every small
    value. `band_p` localizes which band misfits for a flagged source
    (entries near 0 or 1)."""
    p_value: np.ndarray     # (S,) P[T_rep >= T_obs] per source
    band_p: np.ndarray      # (S, nb) tail prob; NaN at excluded slots
    chi2_obs: np.ndarray    # (S, nsamples) whitened chi-sq of observed data
    chi2_rep: np.ndarray    # (S, nsamples) chi-sq of replicated data
    ndata: np.ndarray       # (S,) bands entering each source's statistic
    nfree: int              # free parameters (dof ref: ndata - nfree)
    nsamples: int           # thinned samples per source
    excluded: np.ndarray    # (S, nb) bool: missing or upper-limit slots

    def __repr__(self):
        p = self.p_value
        return (f"PPCBatchResult(S={p.size}, nsamples={self.nsamples}, "
                f"p<0.01: {int((p < 0.01).sum())}, "
                f"p>0.99: {int((p > 0.99).sum())}, "
                f"median p={np.median(p):.3f})")


class MultiFitter(BatchEngine, ParamSpaceMixin):
    """Fit many sources at once with a shared model configuration.

    Usage:
        mf = MultiFitter(nwalkers=250)
        mf.set_data(wave, flux_batch, unc_batch)   # (nb,), (S, nb), (S, nb)
        mf.set_uplim("T", 100.0)                   # shared across sources
        mf.run(nburn=100, nsteps=500)
        mf.par_cen("T")                            # (S, 3)
        mf.compute_lir(redshifts)                  # (S, nsamp)
        res3 = mf.results(3, redshift=z3)          # full MBBResults view

    device: "cuda" (the default) or "cpu"; with no device named and no
    CUDA device available the constructor raises (pass device="cpu").
    sampler_backend: "fused" (each phase one launch of the multi-source
    kernel; the plain multi run for CPU tensors), "torch" (the plain multi
    run) or "auto" = fused on CUDA, torch on the CPU, with or without a
    mesh.
    mesh: a parallel.walker_mesh over the source axis, whose size must
    divide the source count; the fitter's device is its first. Each shard
    runs its block of sources on its device: on CUDA one K3 launch per
    shard and phase with the block's global source offset, on the CPU the
    plain multi run.
    responses: a response.ResponseSet for band-integrated model fluxes
    (set_data with band_names).
    dtype=, prng_impl= and lnprob_backend=: as MBBFitter's
    (fitter.check_jax_keywords).
    """

    def __init__(self, nwalkers=250, wavenorm=500.0, noalpha=False,
                 opthin=False, responses=None, seed=1234, a=2.0,
                 prng_impl=None, mesh=None, sampler_backend="auto",
                 device=None, dtype=None, lnprob_backend=None):
        check_jax_keywords(dtype, prng_impl, lnprob_backend)
        if sampler_backend not in ("auto", "torch", "fused"):
            raise ValueError(
                "sampler_backend must be 'auto', 'torch' or 'fused'")
        if mesh is not None:
            from mbb_emcee_tpu_torch.parallel.mesh import mesh_device
            device = mesh_device(mesh, device)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.sampler_backend = sampler_backend
        self.nwalkers = int(nwalkers)
        self.shape = MBBShape(opthin=bool(opthin), noalpha=bool(noalpha),
                              wavenorm=float(wavenorm))
        self.a = float(a)
        self.seed = int(seed)
        self.responses = responses
        # the quadrature pack a reloaded file carries (from_h5)
        self._restored_pack = None
        self._spec = LikelihoodSpec.default()
        self._init = DEFAULT_INIT.copy()
        self._scatter = DEFAULT_SCATTER.copy()
        self._user_init = np.zeros(NPARAMS, bool)
        self._user_scatter = np.zeros(NPARAMS, bool)
        self.wave = None
        self.flux = None
        self.unc = None
        self._band_corr = None      # (nb, nb) shared band correlation
        self.band_names = None
        self.source_names = None    # (S,) catalog identifiers
        self.redshifts = None       # (S,) per-source z
        self.chain_free = None      # (S, nrec, nw, nfree) tensor
        self.lnprobability = None   # (S, nrec, nw) tensor
        self.acceptance_fraction = None
        self.free_space: FreeSpace | None = None
        self.thin = 1
        self.final_state = None
        self._sampler = None
        self.lir_chain = None       # (S, nsamp), compute_lir()
        self.dustmass_chain = None  # (S, nsamp), compute_dustmass()
        self.peaklambda_chain = None  # (S, nsamp), compute_peaklambda()
        self._device_parts = {}     # quantity -> derived.DevicePart
        self.loo_result = None      # LooBatchResult, compute_loo()
        self.map_params = None      # (S, 5), run_map()
        self.logz_pt = None         # ((S,), (S,)) stepping stone, run_pt()
        self.logz_ti = None         # ((S,), (S,)) TI cross-check, run_pt()
        self.swap_fraction = None   # (S, K-1), run_pt()
        self.pt_betas = None        # (S, K) ladders, run_pt()
        self.hmc_step_size = None   # (S,) adapted step sizes, run_hmc()
        self.hmc_mass = None        # (S, nfree) diagonal metric, run_hmc()
        self.evidence = None        # NestedBatchResult, compute_evidence()

    # -- likelihood operands ---------------------------------------------------
    def _response_pack(self):
        if self.responses is None:
            return self._restored_pack
        if self.band_names is None:
            raise ValueError("response mode requires band_names in set_data")
        return self.responses.pack(self.band_names)

    def _model_token(self, spec):
        """Content of everything the batch likelihood is built from besides
        the per-source data: shape, parameter space, wavelengths, response
        pack."""
        pack = self._response_pack()
        return (self.shape, self.wave.tobytes(),
                tuple(np.asarray(getattr(spec, k)).tobytes() for k in (
                    "lower", "upper", "fixed", "fixed_values", "prior_mean",
                    "prior_isigma")),
                None if pack is None else tuple(a.tobytes() for a in pack))

    def _init_centers(self, init="auto"):
        """Per-source initial centers and scatters (S, 5): fnorm from each
        source's flux nearest wavenorm, T from each source's brightest band
        (the batched MBBFitter._auto_init_fnorm); init="map" is
        BatchEngine._map_centers."""
        if init not in ("auto", "map"):
            raise ValueError(f"init must be 'auto' or 'map'; got {init!r}")
        if init == "map":
            return self._map_centers()
        S = self.nsources
        centers = np.broadcast_to(self._init, (S, NPARAMS)).copy()
        scatters = np.broadcast_to(self._scatter, (S, NPARAMS)).copy()
        if not self._user_init[4]:
            idx = int(np.argmin(np.abs(self.wave - self.shape.wavenorm)))
            fn = self.flux[:, idx]
            ok = fn > 0
            centers[ok, 4] = fn[ok]
            if not self._user_scatter[4]:
                scatters[ok, 4] = np.maximum(2.0 * self.unc[ok, idx],
                                             0.05 * fn[ok])
        if not self._user_init[0]:
            lam_pk = self.wave[np.argmax(self.flux, axis=1)]
            t0 = np.clip(HCOK_UM_K / (MBBFitter._WIEN_X_PEAK * lam_pk),
                         self._spec.lower[0] * 1.02,
                         self._spec.upper[0] * 0.98)
            centers[:, 0] = t0
            if not self._user_scatter[0]:
                scatters[:, 0] = np.maximum(0.15 * t0, 1.0)
        return centers, scatters

    def _resolve_sampler_backend(self):
        if self.sampler_backend != "auto":
            return self.sampler_backend
        return "fused" if self.device.type == "cuda" else "torch"

    def _lnprob_operands(self, spec):
        """The batch likelihood on this data (kernel operands with the plain
        version beside them, ops.plain: (S, n, nfree) -> (S, n))."""
        from mbb_emcee_tpu_torch.ops.multifit_kernel import (
            prepare_multi_inputs)
        return prepare_multi_inputs(
            self.wave, self.flux, self.unc, self.shape, spec,
            self._response_pack(),
            None if self._band_corr is None else self._whiten_operand(),
            self.device)

    def _band_flux_eval(self):
        return derived.band_flux_eval(self.shape, self.wave,
                                      self._response_pack())

    def _build_sampler(self, spec):
        """A new batch sampler for `spec` on this data (building one packs a
        few hundred constants; the kernel library is built once per
        process)."""
        from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
        backend = self._resolve_sampler_backend()
        if backend == "torch":
            ops = self._lnprob_operands(spec)
            ops.label = "MultiFitter's batch likelihood"    # sampler._label
            self._sampler = MultiEnsembleSampler(
                ops.nsources, self.nwalkers, ops.free_space.nfree, ops.plain,
                self.a, ops.free_space, self._source0)
        else:
            whiten = (None if self._band_corr is None
                      else self._whiten_operand())
            self._sampler = FusedMultiSampler(
                self.nwalkers, self.wave, self.flux, self.unc, self.shape,
                spec, response_pack=self._response_pack(), a=self.a,
                whiten=whiten, device=self.device, source0=self._source0)
        self._backend_used = backend
        return self._sampler

    def _spec_fingerprint(self, spec=None):
        from mbb_emcee_tpu_torch.checkpoint import spec_fingerprint
        return spec_fingerprint(self._spec if spec is None else spec,
                                self.shape, self.a)

    # -- batched derived quantities --------------------------------------------
    def compute_lir(self, redshifts=None, wavemin=8.0, wavemax=1000.0,
                    thin=1, lumdists=None, cosmology="WMAP9"):
        """(S, nsamp) L_IR posteriors in L_sun: one batched quadrature over
        sources x samples, per-source nodes scaled by 1+z. `redshifts`
        defaults to the vector stored by set_data()."""
        with span("mbb.derived.lir"):
            self._require_run()
            z = self._source_redshifts(redshifts)
            integ, values = device_part(self._thinned(thin), lir_operands(
                self.shape, 1.0 + z, wavemin, wavemax))
            prefac = derived.lir_prefactor(
                self._dl_mpc(z, lumdists, cosmology))
            self.lir_chain = prefac[:, None] * integ
            self._device_parts["lir"] = derived.DevicePart(
                values, prefac, self.lir_chain)
            return self.lir_chain

    def lir_cen(self, percentile=68.3):
        if self.lir_chain is None:
            raise RuntimeError("call compute_lir(redshifts) first")
        return derived.derived_summary(
            self.lir_chain, self._device_parts.get("lir"), percentile)

    def compute_dustmass(self, redshifts=None, kappa=2.64, kappa_wave=125.0,
                         thin=1, lumdists=None, cosmology="WMAP9"):
        """(S, nsamp) dust-mass posteriors in M_sun. `redshifts` defaults
        to the vector stored by set_data()."""
        with span("mbb.derived.dustmass"):
            self._require_run()
            z = self._source_redshifts(redshifts)
            opz = 1.0 + z
            g, values = device_part(self._thinned(thin), dustmass_operands(
                self.shape, opz, kappa_wave))
            prefac = derived.dustmass_prefactor(
                self._dl_mpc(z, lumdists, cosmology), opz, kappa,
                kappa_wave)
            self.dustmass_chain = prefac[:, None] * g
            self._device_parts["dustmass"] = derived.DevicePart(
                values, prefac, self.dustmass_chain)
            return self.dustmass_chain

    def dustmass_cen(self, percentile=68.3):
        if self.dustmass_chain is None:
            raise RuntimeError("call compute_dustmass(redshifts) first")
        return derived.derived_summary(
            self.dustmass_chain, self._device_parts.get("dustmass"),
            percentile)

    def compute_peaklambda(self, thin=1, lo=derived.PEAK_RANGE[0],
                           hi=derived.PEAK_RANGE[1]):
        """(S, nsamp) observed peak-wavelength posteriors in um."""
        with span("mbb.derived.peaklambda"):
            self._require_run()
            self.peaklambda_chain, values = device_part(
                self._thinned(thin), peak_operands(self.shape, lo, hi))
            self._device_parts["peaklambda"] = derived.DevicePart(
                values, None, self.peaklambda_chain)
            return self.peaklambda_chain

    def peaklambda_cen(self, percentile=68.3):
        if self.peaklambda_chain is None:
            raise RuntimeError("call compute_peaklambda() first")
        return derived.derived_summary(
            self.peaklambda_chain, self._device_parts.get("peaklambda"),
            percentile)

    def sed_percentiles(self, waves, percentile=68.3, thin=1):
        """(S, 3, nwave) per-wavelength [median, upper, lower] f_nu in mJy
        at the OBSERVED wavelengths `waves` (micron), one batched
        evaluation over sources x samples x wavelengths."""
        self._require_run()
        w = torch.as_tensor(np.atleast_1d(np.asarray(waves, np.float32)),
                            device=self.device)
        sed = derived.sed_eval(self.shape, w)

        def fn(th):
            return sed(th.reshape(-1, NPARAMS)).reshape(
                th.shape[:2] + (w.numel(),))

        fluxes = derived._chunked_samples(fn, self._thinned(thin),
                                          w.numel())
        return derived.sed_band(fluxes, percentile, sample_axis=1)

    # -- persistence -----------------------------------------------------------
    def writeToHDF5(self, filename, thin=1):
        """Persist the whole batch to one HDF5 file in the JAX package's
        batch schema (schema 1); `thin` subsamples the stored chains.
        Reload with MultiFitter.from_h5 (either package's)."""
        import h5py
        self._require_run()
        # the spec the RUN sampled under, not the current one
        spec = getattr(self, "_run_spec", None) or self._effective_spec()
        t = max(int(thin), 1)
        chain = self.chain_free[:, ::t].cpu().numpy().astype(np.float32)
        lnp = self.lnprobability[:, ::t].cpu().numpy().astype(np.float32)
        with h5py.File(filename, "w") as f:
            f.attrs["schema_version"] = 1
            f.attrs["package"] = "mbb_emcee_tpu_torch.multifit"
            f.attrs["nwalkers"] = self.nwalkers
            f.attrs["nsources"] = self.nsources
            f.attrs["thin"] = self.thin * t
            f.attrs["opthin"] = self.shape.opthin
            f.attrs["noalpha"] = self.shape.noalpha
            f.attrs["wavenorm"] = self.shape.wavenorm
            f.create_dataset("ChainFree", data=chain, compression="gzip")
            f.create_dataset("LnProbability", data=lnp, compression="gzip")
            f.create_dataset("AcceptanceFraction",
                             data=self.acceptance_fraction)
            f.create_dataset("Wave", data=self.wave)
            f.create_dataset("Flux", data=self.flux)
            f.create_dataset("Unc", data=self.unc)
            if self.band_names is not None:
                f.attrs["band_names"] = np.array(
                    [n.encode() for n in self.band_names])
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
            for ds, dchain in (("LIRChain", self.lir_chain),
                               ("DustMassChain", self.dustmass_chain),
                               ("PeakLambdaChain", self.peaklambda_chain)):
                if dchain is not None:
                    f.create_dataset(ds, data=np.asarray(dchain, np.float32),
                                     compression="gzip")
            sp = f.create_group("ParamSpec")
            for name in ("lower", "upper", "fixed", "fixed_values",
                         "prior_mean", "prior_isigma"):
                sp.create_dataset(name, data=getattr(spec, name))
            if spec.uplim_bands is not None:
                sp.create_dataset("uplim_bands", data=spec.uplim_bands)
            if self._band_corr is not None:
                sp.create_dataset("band_correlation", data=self._band_corr)
            if self.loo_result is not None:
                from mbb_emcee_tpu_torch.modelcheck import (
                    write_loo_batch_group)
                write_loo_batch_group(f, self.loo_result)
            if self.map_params is not None:
                hdf5io.write_map_group(f, *self._map_fields())
            if self.logz_pt is not None:
                g = f.create_group("PTEvidence")
                for name, arr in (("LogZ", self.logz_pt[0]),
                                  ("LogZErr", self.logz_pt[1]),
                                  ("LogZTI", self.logz_ti[0]),
                                  ("LogZTIErr", self.logz_ti[1]),
                                  ("Betas", self.pt_betas),
                                  ("SwapFraction", self.swap_fraction)):
                    g.create_dataset(name, data=arr)
            if self.evidence is not None:
                ev = self.evidence
                g = f.create_group("Evidence")
                g.attrs["nbatch"] = ev.nbatch
                g.attrs["nlive"] = ev.nlive
                for name, arr in (("LogZ", ev.logz),
                                  ("LogZErr", ev.logz_err), ("H", ev.h),
                                  ("NIter", ev.n_iter),
                                  ("NLike", ev.n_like)):
                    g.create_dataset(name, data=arr)
                if ev.converged is not None:
                    g.create_dataset("Converged", data=ev.converged)
                for name, arr in (("Samples", ev.samples),
                                  ("LogLike", ev.loglike),
                                  ("LogWt", ev.logwt)):
                    g.create_dataset(name, data=np.asarray(arr, np.float32),
                                     compression="gzip")
            if self.hmc_step_size is not None:
                g = f.create_group("HMC")
                g.create_dataset("StepSize", data=self.hmc_step_size)
                g.create_dataset("Mass", data=self.hmc_mass)
        return filename

    def _map_fields(self):
        return (self.map_params, self.map_lnprob, self.map_cov,
                self.map_sigma, self.map_interior, self.map_grad_norm)

    def write_map_h5(self, filename):
        """Persist a MAP-only triage result (no chains; the --map CLI flow):
        data, configuration and the MAPFit group, in the JAX package's
        layout. Reload the arrays with h5py; this is a triage artifact, not
        a from_h5 input."""
        if self.map_params is None:
            raise RuntimeError("run_map() has not been called")
        extra = {}
        if self.source_names is not None:
            extra["SourceNames"] = np.array(
                [n.encode() for n in self.source_names])
        if self.redshifts is not None:
            extra["Redshifts"] = self.redshifts
        return hdf5io.write_map_file(
            filename, self.shape, self.wave, self.flux, self.unc,
            self._map_fields(), attrs={"nwalkers": self.nwalkers},
            datasets=extra)

    @classmethod
    def from_h5(cls, filename, device=None):
        """Reload a persisted batch (either package's file): summaries,
        derived quantities and per-source MBBResults views work on the
        restored object; extend() needs a fresh run()."""
        import h5py
        with h5py.File(filename, "r") as f:
            mf = cls(nwalkers=int(f.attrs["nwalkers"]),
                     wavenorm=float(f.attrs["wavenorm"]),
                     noalpha=bool(f.attrs["noalpha"]),
                     opthin=bool(f.attrs["opthin"]), device=device)
            names = (None if "band_names" not in f.attrs else
                     [n.decode() for n in f.attrs["band_names"]])
            mf.set_data(np.asarray(f["Wave"]), np.asarray(f["Flux"]),
                        np.asarray(f["Unc"]), band_names=names,
                        source_names=(
                            None if "SourceNames" not in f else
                            [n.decode() for n in f["SourceNames"]]),
                        redshifts=(None if "Redshifts" not in f else
                                   np.asarray(f["Redshifts"])))
            if "ResponsePack" in f:
                mf._restored_pack = (
                    np.asarray(f["ResponsePack"]["Nodes"]),
                    np.asarray(f["ResponsePack"]["Weights"]))
            for ds, attr in (("LIRChain", "lir_chain"),
                             ("DustMassChain", "dustmass_chain"),
                             ("PeakLambdaChain", "peaklambda_chain")):
                if ds in f:
                    setattr(mf, attr, np.asarray(f[ds], np.float64))
            sp = f["ParamSpec"]
            mf._spec = _replace(
                mf._spec,
                lower=np.asarray(sp["lower"]),
                upper=np.asarray(sp["upper"]),
                fixed=np.asarray(sp["fixed"], bool),
                fixed_values=np.asarray(sp["fixed_values"]),
                prior_mean=np.asarray(sp["prior_mean"]),
                prior_isigma=np.asarray(sp["prior_isigma"]),
                uplim_bands=(np.asarray(sp["uplim_bands"], bool)
                             if "uplim_bands" in sp else None))
            if "band_correlation" in sp:
                mf._band_corr = np.asarray(sp["band_correlation"],
                                           np.float64)
            mf.free_space = FreeSpace.from_spec(mf._effective_spec())
            mf.chain_free = torch.as_tensor(
                np.asarray(f["ChainFree"], np.float32), device=mf.device)
            mf.lnprobability = torch.as_tensor(
                np.asarray(f["LnProbability"], np.float32),
                device=mf.device)
            mf.acceptance_fraction = np.asarray(f["AcceptanceFraction"])
            mf.thin = int(f.attrs["thin"])
            if "MAPFit" in f:
                g = f["MAPFit"]
                mf.map_params = np.asarray(g["Params"], np.float64)
                mf.map_lnprob = np.asarray(g["LnProb"], np.float64)
                mf.map_cov = np.asarray(g["Cov"], np.float64)
                mf.map_sigma = np.asarray(g["Sigma"], np.float64)
                mf.map_interior = np.asarray(g["Interior"], bool)
                mf.map_grad_norm = np.asarray(g["GradNorm"], np.float64)
                # the restored results bind to the restored spec and data
                mf._record_map(mf._effective_spec())
            if "LOO" in f:
                from mbb_emcee_tpu_torch.modelcheck import (
                    read_loo_batch_group)
                mf.loo_result = read_loo_batch_group(f["LOO"])
            if "PTEvidence" in f:
                g = f["PTEvidence"]
                mf.logz_pt = (np.asarray(g["LogZ"]),
                              np.asarray(g["LogZErr"]))
                mf.logz_ti = (np.asarray(g["LogZTI"]),
                              np.asarray(g["LogZTIErr"]))
                mf.pt_betas = np.asarray(g["Betas"])
                mf.swap_fraction = np.asarray(g["SwapFraction"])
            if "Evidence" in f:
                from mbb_emcee_tpu_torch.nested import NestedBatchResult
                g = f["Evidence"]
                mf.evidence = NestedBatchResult(
                    logz=np.asarray(g["LogZ"]),
                    logz_err=np.asarray(g["LogZErr"]),
                    h=np.asarray(g["H"]),
                    samples=np.asarray(g["Samples"], np.float64),
                    loglike=np.asarray(g["LogLike"], np.float64),
                    logwt=np.asarray(g["LogWt"], np.float64),
                    n_iter=np.asarray(g["NIter"]),
                    n_like=np.asarray(g["NLike"]),
                    nbatch=int(g.attrs["nbatch"]),
                    nlive=int(g.attrs["nlive"]),
                    converged=(np.asarray(g["Converged"], bool)
                               if "Converged" in g else None))
            if "HMC" in f:
                mf.hmc_step_size = np.asarray(f["HMC"]["StepSize"])
                mf.hmc_mass = np.asarray(f["HMC"]["Mass"])
        return mf

    # -- single-source views ---------------------------------------------------
    def results(self, i, redshift=None, cosmology="WMAP9", lumdist=None):
        """Full MBBResults for source i. `redshift` defaults to the
        per-source vector stored by set_data()."""
        from mbb_emcee_tpu_torch.results import MBBResults
        self._require_run()
        i = int(i)
        if redshift is None and self.redshifts is not None:
            redshift = float(self.redshifts[i])
        return MBBResults(fit=_SourceView(self, i), redshift=redshift,
                          cosmology=cosmology, lumdist=lumdist)


class _SourceView:
    """One source of a MultiFitter presented as a finished MBBFitter (the
    attribute surface MBBResults._from_fit reads)."""

    def __init__(self, mf: MultiFitter, i: int):
        self.chain_free = mf.chain_free[i]
        self.chain = np.transpose(
            mf.free_space.expand(mf.chain_free[i].double().cpu().numpy()),
            (1, 0, 2))
        self.lnprobability = mf.lnprobability[i]
        self.acceptance_fraction = mf.acceptance_fraction[i]
        self.shape = mf.shape
        self.redshift = None
        self.device = mf.device
        self._pack = mf._response_pack()
        cov = None
        if mf._band_corr is not None:
            # this source's covariance C = D R D; a missing band is an
            # infinite-variance row/col with zero cross terms, the limit
            # the marginalized whitening implements
            d = mf.unc[i]
            cov = mf._band_corr * np.outer(d, d)
            miss = ~np.isfinite(d)
            if miss.any():
                cov[miss, :] = 0.0
                cov[:, miss] = 0.0
                cov[miss, miss] = np.inf
        self.phot = Photometry(mf.wave, mf.flux[i], mf.unc[i], cov=cov,
                               band_names=mf.band_names)
        spec = mf._effective_spec()
        if spec.uplim_bands is not None and spec.uplim_bands.ndim == 2:
            spec = _replace(spec, uplim_bands=spec.uplim_bands[i])
        self.spec = spec
        self._init = mf._init.copy()
        self.thin = mf.thin
        self.nwalkers = mf.nwalkers
        if mf.logz_pt is not None:
            self.logz_pt = (float(mf.logz_pt[0][i]), float(mf.logz_pt[1][i]))
            self.logz_ti = (float(mf.logz_ti[0][i]), float(mf.logz_ti[1][i]))
        if mf.hmc_step_size is not None:
            self.hmc_step_size = float(mf.hmc_step_size[i])
            self.hmc_mass = mf.hmc_mass[i].copy()
        if mf.evidence is not None:
            # this source's NestedResult, as a single fit's
            # compute_evidence() leaves it
            self.evidence = mf.evidence[i]

    def _response_pack(self):
        return self._pack
