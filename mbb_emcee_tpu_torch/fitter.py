"""Fit orchestration: data ingest, priors/limits/fixed params, burn-in
protocol, production run.

Torch twin of mbb_emcee_tpu/fitter.py: the reference's burn-in ->
re-center-on-best-walker -> re-burn -> reset -> production protocol, each
phase one sampler call. On a CUDA device each call is one launch of the
stretch-move kernel (ops/sampler_kernel.py); on the CPU the plain torch
sampler runs the same protocol.

Parameters are observer frame: theta = (T/(1+z), beta, lambda0*(1+z),
alpha, fnorm). Randomness: the walker balls come from a torch.Generator
seeded with `seed`; the proposals from the Philox stream keyed by a 64-bit
key derived from the same seed. Every launch continues that stream where
the last one stopped, so a checkpointed run, a resumed run and run(n1) +
extend(n2) all give the chain of the single run(n1 + n2), bit for bit.

run_hmc (hmc.py: torch.autograd of the plain likelihood on the fitter's
device) and run_pt (tempering.py: every tempered half-step one launch of
the lnprob kernel on a CUDA device) sample the same posterior from the same
walker ball, on Philox streams of their own under the same key.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from mbb_emcee_tpu_torch.checkpoint import PRNG_IMPL, production
from mbb_emcee_tpu_torch.constants import PARAM_NAMES, NPARAMS, HCOK_UM_K
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
from mbb_emcee_tpu_torch.likelihood import (
    Photometry, LikelihoodSpec, build_lnprob, param_index)
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, make_initial_ball, autocorrelation_time, split_rhat)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin, _replace
from mbb_emcee_tpu_torch.utils.profiling import count, span

# Default initial guess and ball scatter (observer frame).
DEFAULT_INIT = np.array([12.0, 2.0, 250.0, 4.0, 40.0])
DEFAULT_SCATTER = np.array([2.0, 0.3, 50.0, 0.8, 8.0])


def check_jax_keywords(dtype=None, prng_impl=None, lnprob_backend=None,
                       jax_prng="rbg"):
    """Refuse, by keyword, a value of the JAX constructors' dtype=,
    prng_impl= or lnprob_backend= that the port cannot honour. The port
    has one precision (float32), one generator (Philox-4x32-10, the
    kernels' and ops/philox.py's) and a likelihood the device picks (the
    lnprob kernel on CUDA, its plain torch version on the CPU). Unset, or
    the JAX constructor's default (`jax_prng`, "xla"), is accepted."""
    if dtype is not None:
        try:
            f32 = (dtype == torch.float32 if isinstance(dtype, torch.dtype)
                   else np.dtype(dtype) == np.float32)
        except TypeError:       # a name numpy does not know ("bfloat16")
            f32 = False
        if not f32:
            raise ValueError(
                f"dtype={dtype!r} is not taken: mbb_emcee_tpu_torch samples "
                "in float32 only (its kernels and plain torch paths are "
                "fp32); leave dtype unset or pass float32")
    if prng_impl is not None and prng_impl not in (PRNG_IMPL, jax_prng):
        raise ValueError(
            f"prng_impl={prng_impl!r} is not taken: mbb_emcee_tpu_torch "
            f"draws every proposal from one generator, Philox-4x32-10 "
            f"({PRNG_IMPL!r}, the kernels' own); leave prng_impl unset")
    if lnprob_backend not in (None, "xla"):
        raise ValueError(
            f"lnprob_backend={lnprob_backend!r} is not taken: "
            "mbb_emcee_tpu_torch picks the likelihood by device (the lnprob "
            "kernel on CUDA, its plain torch version on the CPU); leave "
            "lnprob_backend unset")


def default_device():
    """The device a fitter runs on when the caller names none: the card.
    Nothing falls back to the CPU: the plain torch path there is a test and
    rehearsal path, and a caller asks for it by name."""
    return "cuda"


def resolve_device(device):
    """torch.device of a `device` argument (None: the card). A CUDA device,
    named or defaulted, with no usable CUDA device raises at once instead
    of failing later inside torch or running the plain torch path on the
    CPU unasked."""
    device = torch.device(default_device() if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu; got {device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" (library) or --device cpu "
            "(command line) to run the plain torch path on the CPU")
    return device


def philox_key(seed):
    """64-bit Philox key from an integer seed (splitmix64 finalizer)."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class MBBFitter(ParamSpaceMixin):
    """Single-source modified-blackbody fit (the reference's mbb_fitter).

    device: "cuda" (the default) or "cpu"; with no device named and no
    CUDA device available the constructor raises (pass device="cpu" for the
    plain torch path on the CPU).
    sampler_backend: "fused" (the whole run as one kernel launch), "torch"
    (the plain torch sampler) or "auto" = fused on CUDA, torch on the CPU.
    mesh: a parallel.walker_mesh; run() then shards the walker axis over
    its devices (parallel.ShardedEnsembleSampler, the lnprob kernel on each
    card, the plain likelihood on the CPU) and the fitter's device is the
    mesh's first. sampler_backend="fused" with a mesh is refused at run():
    the stretch-move kernel runs one ensemble on one card.
    n_ensembles > 1 runs K independent ensembles of this fit through the
    batch tier (MultiFitter; on CUDA one multi-source kernel launch per
    phase) and merges their chains into one (K * nwalkers)-walker product:
    K x the samples, a cross-ensemble split-R-hat, and independent burn-ins.
    Diagonal uncertainties only.
    dtype=, prng_impl= and lnprob_backend= are the JAX constructor's: the
    port samples in float32 from Philox-4x32-10 on the likelihood its
    device picks, and refuses any other value by name
    (check_jax_keywords).
    responses: a response.ResponseSet; the model fluxes are then
    band-integrated over each named band's filter curve (set_data with
    band_names, or a photometry file with a band-name column).
    """

    def __init__(self, nwalkers=250, photfile=None, covfile=None, covextn=0,
                 wavenorm=500.0, noalpha=False, opthin=False, *,
                 redshift=None, responses=None, nthreads=None, seed=1234,
                 a=2.0, dtype=None, prng_impl=None, lnprob_backend=None,
                 device=None, sampler_backend="auto", mesh=None,
                 n_ensembles=1):
        del nthreads  # walker parallelism is on the device
        check_jax_keywords(dtype, prng_impl, lnprob_backend)
        if int(n_ensembles) < 1:
            raise ValueError(f"n_ensembles={n_ensembles} must be >= 1")
        self.n_ensembles = int(n_ensembles)
        self._mf = None
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
        self.redshift = None if redshift is None else float(redshift)
        self.responses = responses
        self.a = float(a)
        self.seed = int(seed)

        self._spec = LikelihoodSpec.default()
        self._init = DEFAULT_INIT.copy()
        self._scatter = DEFAULT_SCATTER.copy()
        self._user_init = np.zeros(NPARAMS, bool)
        self._user_scatter = np.zeros(NPARAMS, bool)
        self.phot: Photometry | None = None

        self.free_space = None
        self.chain_free = None      # (nrec, nwalkers, nfree) tensor
        self.lnprobability = None   # (nrec, nwalkers) tensor
        self.burn_chain_free = None
        self.acceptance_fraction = None
        self.thin = 1
        self.logz_pt = None         # (lnZ, err) stepping stone, run_pt()
        self.logz_ti = None         # (lnZ, err) thermodynamic integration
        self.evidence = None        # NestedResult, compute_evidence()

        if photfile is not None:
            self.read_data(photfile)
        if covfile is not None:
            if self.phot is None:
                raise ValueError("covfile given without photometry")
            self.phot.read_cov(covfile, covextn=covextn)

    # -- data ingest -----------------------------------------------------------
    def read_data(self, photfile):
        """Load text photometry (ref: mbb_fitter.read_data)."""
        phot = Photometry.from_file(photfile)
        self._check_uplim_mask(phot)
        self.phot = phot
        return self

    def set_data(self, wave, flux, unc, cov=None, band_names=None):
        with span("mbb.fit.set_data"):
            phot = Photometry(wave, flux, unc, cov=cov,
                              band_names=band_names)
            self._check_uplim_mask(phot)
            self.phot = phot
        return self

    def _check_uplim_mask(self, phot):
        ub = self._spec.uplim_bands
        if ub is not None and ub.size != phot.nbands:
            raise ValueError(
                f"the photometric upper-limit mask was set for {ub.size} "
                f"bands but the new data has {phot.nbands}; call "
                f"set_phot_upperlimits again (or clear it with None) "
                f"before binding this data")

    def read_cov(self, covfile, covextn=0, is_total=False):
        self._require_data().read_cov(covfile, covextn, is_total)
        return self

    def set_phot_upperlimits(self, mask):
        """Flag bands whose flux column is an upper limit (None clears)."""
        if mask is None:
            self._spec = _replace(self._spec, uplim_bands=None)
            return self
        mask = np.asarray(mask, bool)
        if mask.size != self._require_data().nbands:
            raise ValueError("upper-limit mask length mismatch")
        self._spec = _replace(self._spec, uplim_bands=mask)
        return self

    def _require_data(self) -> Photometry:
        if self.phot is None:
            raise RuntimeError("no photometry loaded; call read_data/set_data")
        return self.phot

    # f_nu of a greybody peaks near x = hc/(lambda k T) ~ 4.
    _WIEN_X_PEAK = 4.0

    def _auto_init_fnorm(self):
        """Unless the user set them, seed fnorm from the flux of the band
        nearest wavenorm and T from the brightest band's wavelength."""
        if self.phot is None:
            return
        if not self._user_init[4]:
            idx = int(np.argmin(np.abs(self.phot.wave -
                                       self.shape.wavenorm)))
            fn = float(self.phot.flux[idx])
            if fn > 0:
                self._init[4] = fn
                if not self._user_scatter[4]:
                    self._scatter[4] = max(2.0 * float(self.phot.unc[idx]),
                                           0.05 * fn)
        if not self._user_init[0]:
            lam_pk = float(self.phot.wave[int(np.argmax(self.phot.flux))])
            t0 = HCOK_UM_K / (self._WIEN_X_PEAK * lam_pk)
            t0 = float(np.clip(t0, self._spec.lower[0] * 1.02,
                               self._spec.upper[0] * 0.98))
            self._init[0] = t0
            if not self._user_scatter[0]:
                self._scatter[0] = max(0.15 * t0, 1.0)

    # -- likelihood and sampler ----------------------------------------------------
    def _response_pack(self):
        """(waves, weights) fp32 (nbands, nnodes) of the response set for
        the photometry's named bands, or None in point mode."""
        phot = self._require_data()
        if self.responses is None:
            return None
        if phot.band_names is None:
            raise ValueError("response mode requires named photometry bands")
        return self.responses.pack(phot.band_names)

    def _resolve_sampler_backend(self):
        if self.mesh is not None:
            if self.sampler_backend == "fused":
                raise ValueError(
                    "sampler_backend='fused' is single-chip; drop mesh= "
                    "or use the default backend")
            return "sharded"
        if self.sampler_backend != "auto":
            return self.sampler_backend
        return "fused" if self.device.type == "cuda" else "torch"

    def build(self):
        """Build (lnprob, free_space, sampler). Called by run()."""
        spec = self._effective_spec()
        backend = self._resolve_sampler_backend()
        self._backend_used = backend
        if backend == "sharded":
            from mbb_emcee_tpu_torch.parallel import ShardedEnsembleSampler
            by_device = {}
            for dev in self.mesh.devices:
                if dev not in by_device:
                    by_device[dev] = self._batched_lnprob(False, dev)
            lnprob, free_space = by_device[self.device]
            sampler = ShardedEnsembleSampler(
                self.nwalkers, free_space.nfree,
                [by_device[dev][0] for dev in self.mesh.devices], self.mesh,
                a=self.a)
            return lnprob, free_space, sampler
        if backend == "fused":
            from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
            sampler = FusedSampler(
                self.nwalkers, self._require_data(), self.shape, spec,
                response_pack=self._response_pack(), a=self.a,
                device=self.device)
            return sampler.lnprob_batch, sampler.free_space, sampler
        lnprob, free_space = build_lnprob(
            self._require_data(), self.shape, spec,
            response_pack=self._response_pack(), device=self.device)
        sampler = EnsembleSampler(self.nwalkers, free_space.nfree, lnprob,
                                  a=self.a)
        return lnprob, free_space, sampler

    def _call_key(self, phot):
        """What MBBFitter.__call__'s cached operands depend on, cheap to
        form and compare: the model shape, the contents of the spec's
        limits, priors and upper-limit mask and of the photometry (a few
        floats per band), and each band's Response, which compares by
        identity (a compiled filter is not edited in place; a new or
        rebuilt response set holds new ones)."""
        spec = self._spec
        bands = None
        if self.responses is not None:
            if phot.band_names is None:
                raise ValueError(
                    "response mode requires named photometry bands")
            bands = tuple(self.responses[n] for n in phot.band_names)
        small = (spec.lower, spec.upper, spec.prior_mean, spec.prior_isigma,
                 spec.uplim_bands, phot.wave, phot.flux, phot.unc, phot.cov)
        return (self.shape, bands, tuple(
            None if a is None else np.asarray(a).tobytes() for a in small))

    def __call__(self, params):
        """lnprob at a FULL 5-parameter vector (ref: mbb_fitter.__call__);
        the box and priors apply, fixed parameters take the given values.
        On CUDA this is one launch of the lnprob kernel."""
        from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
            prepare_lnprob_inputs, mbb_lnprob)
        params = np.asarray(params, dtype=np.float32)
        if params.shape != (NPARAMS,):
            raise ValueError(f"expected {NPARAMS}-vector")
        # The packed operands are cached: ported upstream code calls this
        # in per-sample loops, so the key must cost less than the launch.
        key = self._call_key(self._require_data())
        cache = getattr(self, "_call_cache", None)
        if cache is None or cache[0] != key:
            open_spec = _replace(self._effective_spec(),
                                 fixed=np.zeros(NPARAMS, bool),
                                 fixed_values=np.zeros(NPARAMS))
            ops = prepare_lnprob_inputs(self.phot, self.shape, open_spec,
                                        response_pack=self._response_pack(),
                                        device=self.device)
            cache = (key, ops)
            self._call_cache = cache
        x = torch.from_numpy(params[None, :]).to(self.device)
        return float(mbb_lnprob(x, cache[1])[0])

    # -- the run -------------------------------------------------------------------
    def run(self, nburn=50, nsteps=250, thin=1, p0=None,
            recenter_burn=True, verbose=False, checkpoint=None,
            checkpoint_interval=100, resume=False, init="auto"):
        """Burn-in -> re-center on the best burn-in sample -> re-burn ->
        reset -> production (ref: mbb_fitter.run). Stores the production
        chain on the fitter's device; wrap in MBBResults for analysis.

        With `checkpoint=path` the production run is segmented and the
        chain and full sampler state are flushed to HDF5 every
        `checkpoint_interval` recorded steps; `resume=True` continues an
        interrupted run from that file (skipping the burn-in).

        init="map" seeds the walker ball at the fit_map() mode with ~2
        Laplace-sigma scatter (the triage-then-refine workflow, as
        MultiFitter.run(init="map")); it needs fit_map() on this data
        first. Returns self."""
        if init not in ("auto", "map"):
            raise ValueError(f"init must be 'auto' or 'map'; got {init!r}")
        if init == "map":
            if p0 is not None:
                raise ValueError("init='map' conflicts with an explicit p0")
            if self.n_ensembles == 1:
                self._require_map_fresh("run(init='map')")
        if int(thin) < 1:
            raise ValueError(f"thin={thin} must be >= 1")
        if int(nsteps) % int(thin):
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        if resume and not checkpoint:
            raise ValueError(
                "resume=True requires checkpoint= (the path the previous "
                "run flushed state to)")
        self._mf = None       # a fresh run() invalidates any merged state
        self.logz_pt = self.logz_ti = None     # run_pt's evidence
        if self.n_ensembles > 1:
            if p0 is not None:
                raise ValueError(
                    "n_ensembles > 1 does not combine with an explicit p0")
            if init == "map":
                raise ValueError(
                    "init='map' does not combine with n_ensembles > 1; use "
                    "MultiFitter.run(init='map') for batched "
                    "triage-then-refine")
            return self._run_ensembles(nburn, nsteps, thin, recenter_burn,
                                       verbose, checkpoint,
                                       checkpoint_interval, resume)
        resuming = bool(checkpoint and resume and os.path.exists(checkpoint))
        if resuming and p0 is not None:
            raise ValueError(
                "p0= combined with an actual resume is ambiguous: the "
                "checkpointed state would silently win; drop p0 (or the "
                "checkpoint file) to make the intent explicit")
        if resuming and init == "map":
            raise ValueError(
                "init='map' combined with an actual resume is ambiguous: the "
                "checkpointed state would silently win; drop init= (or the "
                "checkpoint file) to make the intent explicit")

        with span("mbb.fit.run", nburn=int(nburn), nsteps=int(nsteps),
                  thin=int(thin), nsources=1):
            self._auto_init_fnorm()
            _, free_space, sampler = self.build()
            self.free_space = free_space
            self.thin = int(thin)
            if resuming:
                self.burn_chain_free = None
            state, chain, lnpchain = production(
                sampler.run_mcmc,
                lambda: self._burn(sampler, free_space, p0, nburn,
                                   recenter_burn, init),
                nsteps, thin, self.device, checkpoint, checkpoint_interval,
                resuming, None if checkpoint is None
                else self._checkpoint_meta(nsteps), verbose=verbose)
            with span("mbb.fit.record"):
                self.chain_free = chain
                self.lnprobability = lnpchain
                self.final_state = state
                self.acceptance_fraction = sampler.acceptance_fraction(state)
                count("d2h_bytes", self.acceptance_fraction.nbytes)
                self.sampler = sampler

        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            log = enable_console()
            af = self.acceptance_fraction
            log.info(f"Sampler: {self._backend_used} on {self.device}")
            log.info(f"Mean acceptance fraction: {af.mean():.3f} "
                     f"(min {af.min():.3f}, max {af.max():.3f})")
            tau = self.autocorrelation_time()
            names = self.free_param_names
            for n, t in zip(names, tau):
                log.info(f"  autocorrelation time [{n}]: {t:.1f} steps")
            if chain.shape[0] >= 4:
                rhat = self.gelman_rubin()
                log.info("  split-R-hat: " + ", ".join(
                    f"{n}={r:.3f}" for n, r in zip(names, rhat)))
        return self

    def _map_ball(self, free_space):
        """(center, scatter) of the init="map" walker ball: the MAP mode
        with 2 Laplace sigmas of scatter, capped at 10x the default scatter
        (huge floored-Laplace sigmas of a degenerate mode would throw
        walkers across the whole box; MultiFitter's rule)."""
        r = self.map_result
        if r.x.size != free_space.nfree:
            raise RuntimeError(
                "the parameter space changed since fit_map() (fixed/freed "
                "parameters); re-run fit_map before init='map'")
        base = self._scatter[free_space.free_idx]
        return (np.asarray(r.x, np.float64),
                np.minimum(np.clip(2.0 * r.sigma, 1e-6, None), base * 10.0))

    def _burn(self, sampler, free_space, p0, nburn, recenter_burn,
              init="auto"):
        """The start state of production: the walker ball (or p0), burn-in,
        re-center on the best burn-in sample, re-burn, counters reset."""
        idx = free_space.free_idx
        gen = torch.Generator().manual_seed(self.seed)
        with span("mbb.fit.ball"):
            if p0 is None:
                center, scatter = (
                    self._map_ball(free_space) if init == "map"
                    else (self._init[idx], self._scatter[idx]))
                p0 = make_initial_ball(gen, center, scatter,
                                       self.nwalkers, free_space.lower,
                                       free_space.upper, device=self.device)
            else:
                p0 = torch.as_tensor(np.asarray(p0, np.float32),
                                     device=self.device)
                if p0.shape[-1] == NPARAMS:
                    p0 = p0[..., torch.as_tensor(idx, device=self.device)]
            state = sampler.init_state(p0, seed=philox_key(self.seed))
        if nburn > 0:
            with span("mbb.fit.burn"):
                state, bchain, blnp = sampler.run_mcmc(state, nburn)
            self.burn_chain_free = bchain
            if recenter_burn:
                # Re-center the whole ensemble on the best burn-in sample
                # with a tight ball, then burn again from there; the Philox
                # stream continues where the burn-in stopped.
                with span("mbb.fit.recentre"):
                    flat = bchain.reshape(-1, free_space.nfree)
                    best = flat[int(torch.argmax(blnp.reshape(-1)))]
                    best = best.double().cpu().numpy()
                    count("d2h_bytes", best.nbytes)
                    p0b = make_initial_ball(gen, best,
                                            self._scatter[idx] * 0.1,
                                            self.nwalkers, free_space.lower,
                                            free_space.upper,
                                            device=self.device)
                    state = sampler.init_state(p0b, seed=state.seed,
                                               step=state.step)
                with span("mbb.fit.reburn"):
                    state = sampler.advance(state, nburn)
            with span("mbb.fit.reset"):
                state = sampler.reset_counters(state)
        return state

    def _checkpoint_meta(self, nsteps):
        """The run identity a checkpoint records: geometry, engine, and the
        fingerprints of the data (response pack included: resuming after a
        filter-curve swap would splice chains of two band integrations) and
        of the posterior."""
        from mbb_emcee_tpu_torch.checkpoint import (
            PRNG_IMPL, data_fingerprint, new_run_id, spec_fingerprint)
        phot = self._require_data()
        pack = self._response_pack()
        return {"nwalkers": self.nwalkers, "thin": self.thin,
                "nsteps_target": int(nsteps),
                "sampler_backend": self._backend_used,
                "prng_impl": PRNG_IMPL, "seed": self.seed,
                "data_fingerprint": data_fingerprint(
                    phot.wave, phot.flux, phot.unc, phot.cov,
                    *(() if pack is None else pack)),
                "spec_fingerprint": spec_fingerprint(self._spec,
                                                     self.shape, self.a),
                # ties this run's flushes together (see new_run_id)
                "run_id": new_run_id()}

    # -- HMC and parallel tempering ---------------------------------------------
    def _tier_done(self, backend, chain, lnp, acceptance):
        """Record an HMC / PT production chain (run_pt then sets its
        evidence); extend() refuses it."""
        self.logz_pt = self.logz_ti = None
        self.chain_free = chain
        self.lnprobability = lnp
        self.acceptance_fraction = acceptance
        self.burn_chain_free = None
        self.sampler = None
        self.final_state = None
        self._mf = None
        self._backend_used = backend

    def run_hmc(self, nwarmup=500, nsteps=1000, nchains=None, thin=1,
                n_leapfrog=16, target_accept=0.8, p0=None, verbose=False):
        """Gradient-based alternative to run(): Hamiltonian MC over the
        same posterior (hmc.py). Forces are torch.autograd of the plain
        likelihood on the fitter's device (the lnprob kernel has no
        backward pass; the JAX package takes jax.grad of its XLA likelihood
        the same way). Useful for the curved, correlated T-lambda0
        posteriors of optically thick fits.

        Runs `nchains` (default nwalkers) independent chains: dual-averaged
        step size + diagonal mass warmup (`nwarmup` steps, discarded), then
        `nsteps` production steps recorded every `thin`. MBBResults,
        gelman_rubin and writeToHDF5 see the usual (nrec, nchains, nfree)
        chain. extend() does not apply (re-run with more nsteps)."""
        from mbb_emcee_tpu_torch import hmc

        lnprob, free_space, x0 = self._tier_setup(
            "run_hmc samples one set of chains -- use nchains= for more HMC "
            "chains", nchains, p0, plain=True)
        self.thin = int(thin)
        graphs = hmc._HMCGraphs()
        res = hmc._sample(lnprob, free_space.lower, free_space.upper, x0,
                          philox_key(self.seed), graphs, nwarmup=nwarmup,
                          nsteps=nsteps, thin=thin, n_leapfrog=n_leapfrog,
                          target_accept=target_accept)
        self._hmc_mode = graphs.mode     # "graph": one captured transition
        self._tier_done("hmc", res.chain, res.lnprob, res.acceptance_fraction)
        self.hmc_result = res
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            log = enable_console()
            af = self.acceptance_fraction
            log.info(f"HMC on {self.device}: mean acceptance {af.mean():.3f}, "
                     f"step size {res.step_size:.4g}, {x0.shape[0]} chains x "
                     f"{nsteps} steps")
            for n, t in zip(self.free_param_names,
                            self.autocorrelation_time()):
                log.info(f"  autocorrelation time [{n}]: {t:.1f} steps")
        return self

    def run_pt(self, nrungs=12, beta_min="auto", nburn=300, nsteps=1000,
               nchains=None, thin=1, p0=None, verbose=False):
        """Parallel-tempering alternative to run(): K temperature rungs of
        the same posterior with replica exchange between adjacent rungs
        (tempering.py). The single-temperature ensemble traps on the real
        T-lambda0 bimodality of optically thick fits (DESIGN.md); hot rungs
        cross between modes and hand mixed states down the ladder. On a CUDA
        device every tempered half-step's proposals (K x nchains/2 vectors)
        are one launch of the lnprob kernel; on the CPU the plain
        likelihood runs the same draws.

        The production run also yields the evidence: self.logz_pt = (lnZ,
        err) by stepping stone (headline, safe on wide prior boxes) and
        self.logz_ti by thermodynamic integration (a diagnostic). The
        recorded chain is the COLD (beta=1) rung; MBBResults, gelman_rubin
        and writeToHDF5 are unchanged. extend() does not apply; re-run with
        more nsteps."""
        from mbb_emcee_tpu_torch.tempering import pt_sample

        lnprob, _, x0 = self._tier_setup(
            "run_pt already advances K temperature rungs -- use nchains= for "
            "more walkers per rung", nchains, p0, plain=False)
        self.thin = int(thin)
        res = pt_sample(lnprob, x0, philox_key(self.seed), nrungs=nrungs,
                        beta_min=beta_min, nburn=nburn, nsteps=nsteps,
                        thin=thin, a=self.a)
        self._tier_done("pt", res.chain, res.lnprob,
                        res.acceptance_fraction[0])      # cold rung
        self.logz_pt = (res.logz, res.logz_err)
        self.logz_ti = (res.logz_ti, res.logz_ti_err)
        self.pt_result = res
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            log = enable_console()
            log.info(f"PT on {self.device}: {res.betas.size} rungs x "
                     f"{x0.shape[0]} walkers, cold acceptance "
                     f"{res.acceptance_fraction[0].mean():.3f}, swap "
                     f"fractions "
                     f"{np.array2string(res.swap_fraction, precision=2)}")
            log.info(f"  stepping-stone lnZ = {res.logz:.3f} "
                     f"+/- {res.logz_err:.3f}")
        return self

    def _batched_lnprob(self, plain, device=None):
        """(lnprob (n, nfree) -> (n,), free space) of the effective spec on
        `device` (default: the fitter's): the plain torch likelihood
        (plain=True; autograd), else the lnprob kernel on a CUDA device
        (its plain version on the CPU)."""
        spec = self._effective_spec()
        device = self.device if device is None else device
        if plain:
            return build_lnprob(
                self._require_data(), self.shape, spec,
                response_pack=self._response_pack(), device=device)
        from mbb_emcee_tpu_torch.ops import lnprob_kernel
        ops = lnprob_kernel.prepare_lnprob_inputs(
            self._require_data(), self.shape, spec,
            response_pack=self._response_pack(), device=device)

        def lnprob(x):
            return lnprob_kernel.mbb_lnprob(x.contiguous(), ops)
        return lnprob, ops.free_space

    def _tier_setup(self, why, nchains, p0, plain):
        """(batched lnprob, free space, start positions (nchains, nfree) on
        the fitter's device) of run_hmc / run_pt. `plain`: the plain torch
        likelihood (autograd), else the lnprob kernel on a CUDA device (its
        plain version on the CPU). The start is run()'s first walker ball
        (the CPU generator seeded with `seed`) or p0 in 5-param or free
        space."""
        if self.n_ensembles > 1:
            raise ValueError(
                "n_ensembles > 1 applies to the stretch-move run() only; "
                + why)
        nchains = self.nwalkers if nchains is None else int(nchains)
        self._auto_init_fnorm()
        lnprob, free_space = self._batched_lnprob(plain)
        self.free_space = free_space
        idx = free_space.free_idx
        if p0 is None:
            x0 = make_initial_ball(torch.Generator().manual_seed(self.seed),
                                   self._init[idx], self._scatter[idx],
                                   nchains, free_space.lower,
                                   free_space.upper, device=self.device)
        else:
            x0 = torch.as_tensor(np.asarray(p0, np.float32),
                                 device=self.device)
            if x0.shape[-1] == NPARAMS:
                x0 = x0[..., torch.as_tensor(idx, device=self.device)]
        return lnprob, free_space, x0

    def compute_evidence(self, nlive=512, nbatch=32, nsteps=32,
                         max_iter=3000, tol=1e-4, seed=None, verbose=False):
        """Bayesian evidence ln Z of THIS model configuration by nested
        sampling (nested.py), for comparing the model variants upstream
        mbb_emcee fits (optically thin against thick, with or without
        alpha): the Bayes factor between two fitters with the same data and
        prior settings is exp(lnZ_A - lnZ_B).

        The evidence is taken w.r.t. the normalized uniform prior over the
        free-parameter box (set_lowlim/set_uplim) times any Gaussian prior
        factors, as the likelihood applies them. On a CUDA device every
        constrained step's nbatch proposals are one launch of the lnprob
        kernel (1 + n_iter * nsteps launches a call); on the CPU the plain
        likelihood runs the same draws. The draws come from the Philox
        stream of philox_key(seed) (default: the fitter's seed). Returns a
        NestedResult with the weighted samples in the FULL 5-parameter
        space; also stored as self.evidence."""
        from mbb_emcee_tpu_torch.nested import nested_sample

        self._auto_init_fnorm()
        lnprob, free_space = self._batched_lnprob(plain=False)
        res = nested_sample(
            lnprob, free_space.lower, free_space.upper,
            philox_key(self.seed if seed is None else int(seed)),
            nlive=nlive, nbatch=nbatch, nsteps=nsteps, max_iter=max_iter,
            tol=tol, device=self.device)
        res = dataclasses.replace(res, samples=free_space.expand(res.samples))
        self.evidence = res
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            enable_console().info(
                f"nested sampling: lnZ = {res.logz:.3f} +/- "
                f"{res.logz_err:.3f} (H = {res.h:.2f} nats, "
                f"{res.n_iter} iterations, {res.n_like} likelihood evals)")
        return res

    # -- MAP + Laplace triage ------------------------------------------------------
    def _posterior_key(self):
        """What stored MAP results bind to: the effective parameter space,
        the photometry and the response pack (content hashes)."""
        from mbb_emcee_tpu_torch.checkpoint import (
            data_fingerprint, spec_fingerprint)
        phot = self._require_data()
        pack = self._response_pack()
        return (spec_fingerprint(self._effective_spec(), self.shape, self.a),
                data_fingerprint(phot.wave, phot.flux, phot.unc, phot.cov),
                None if pack is None else data_fingerprint(*pack))

    def _require_map_fresh(self, what):
        """Refuse to consume stored MAP results after the posterior or the
        data changed underneath them: the same nfree does not mean the same
        free parameters, and a prior, limit or upper-limit edit moves the
        posterior while leaving the stored mode in place."""
        if getattr(self, "map_result", None) is None:
            raise RuntimeError(f"{what} requires fit_map() on this data "
                               f"first")
        if getattr(self, "_map_token", None) != self._posterior_key():
            raise RuntimeError(
                f"{what}: the stored MAP fit is for a different posterior "
                f"-- the parameter space (priors / limits / fixed / uplim "
                f"mask), data, or responses changed since fit_map(); re-run "
                f"fit_map() first")

    def fit_map(self, nstarts=8, n_adam=150, n_newton=12, adam_lr=0.1,
                verbose=False):
        """MAP point + Laplace error bars (mapfit.py): `nstarts` starts
        through a fixed-iteration Adam-then-damped-Newton optimizer on the
        plain torch likelihood on the fitter's device, then the inverse
        Hessian at the mode. Returns a MAPResult (free-parameter space;
        also stored as self.map_result); interior=False means the mode
        sits within ~2 Laplace sigmas of a box bound and the Gaussian error
        bars should not be trusted -- run the MCMC."""
        from mbb_emcee_tpu_torch.mapfit import (
            MAPResult, map_fit, laplace_cov_host, interior_mask)

        self._auto_init_fnorm()
        spec = self._effective_spec()
        lnprob, free_space = build_lnprob(
            self._require_data(), self.shape, spec,
            response_pack=self._response_pack(), device=self.device)
        if not (np.all(np.isfinite(free_space.lower))
                and np.all(np.isfinite(free_space.upper))):
            raise ValueError(
                "MAP fitting requires finite box bounds on every free "
                "parameter (the defaults are finite)")
        idx = free_space.free_idx
        x0 = make_initial_ball(torch.Generator().manual_seed(self.seed),
                               self._init[idx], self._scatter[idx],
                               int(nstarts), free_space.lower,
                               free_space.upper, device=self.device)
        x_map, lnp_map, H, gn = map_fit(lnprob, free_space.lower,
                                        free_space.upper, x0, n_adam,
                                        n_newton, adam_lr)
        cov, h_ok = laplace_cov_host(H)
        sigma = np.sqrt(np.maximum(np.diag(cov), 0.0))
        interior = bool(h_ok) and bool(interior_mask(
            x_map, sigma, free_space.lower, free_space.upper))
        self.map_result = MAPResult(
            x=x_map, lnprob=float(lnp_map), cov=cov, sigma=sigma,
            interior=interior, grad_norm=float(gn))
        self._map_token = self._posterior_key()
        self.free_space = free_space
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            parts = [f"{PARAM_NAMES[i]}={v:.4g}+/-{s:.3g}"
                     for i, v, s in zip(idx, x_map, sigma)]
            enable_console().info(
                f"MAP fit ({nstarts} starts): " + ", ".join(parts)
                + f"; lnprob={float(lnp_map):.2f}"
                + ("" if interior else
                   " [mode near a box bound -- Laplace suspect]"))
        return self.map_result

    def map_importance(self, nsamples=2048, seed=None):
        """Laplace importance sampling after fit_map(): weighted
        true-posterior summaries without MCMC. The N draws from the Laplace
        Gaussian are evaluated by the fitter's batched lnprob (one launch of
        the lnprob kernel on CUDA). Returns (samples (N, nfree), logw (N,),
        ess), also stored as self.map_is; ess/N near 1 certifies the
        Gaussian approximation, a small ess says run the MCMC."""
        from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR
        from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
            prepare_lnprob_inputs, mbb_lnprob)
        self._require_map_fresh("map_importance")
        r = self.map_result
        ops = prepare_lnprob_inputs(self._require_data(), self.shape,
                                    self._effective_spec(),
                                    response_pack=self._response_pack(),
                                    device=self.device)
        d = ops.nfree
        N = int(nsamples)
        L = np.linalg.cholesky(r.cov)
        logdet = float(np.sum(np.log(np.diag(L))))
        gen = torch.Generator().manual_seed(
            self.seed if seed is None else int(seed))
        eps = torch.randn((N, d), generator=gen,
                          dtype=torch.float32).double().numpy()
        x = r.x[None, :] + eps @ L.T
        lnp = mbb_lnprob(torch.as_tensor(x.astype(np.float32),
                                         device=self.device), ops)
        lnp = lnp.double().cpu().numpy()
        lnq = (-0.5 * np.sum(eps ** 2, axis=1) - logdet
               - 0.5 * d * np.log(2.0 * np.pi))
        # out-of-box draws sit at the finite floor, which would absorb lnq
        # in fp64 and fake uniform weights: mask them to -inf
        logw = np.where(lnp > SUPPORT_FLOOR, lnp - lnq, -np.inf)
        mx = logw.max()
        if not np.isfinite(mx):
            self.map_is = (x, logw, 0.0)
            return self.map_is
        logw = logw - mx
        w = np.exp(logw)
        ess = float(w.sum() ** 2 / np.maximum((w * w).sum(), 1e-300))
        self.map_is = (x, logw, ess)
        return self.map_is

    def map_par_cen(self, param, percentile=68.3):
        """(median, +err, -err) from the importance-refined Laplace
        posterior (map_importance first). Fixed parameters report zero
        errors; an ess = 0 result reports the MAP point with NaN errors."""
        if getattr(self, "map_is", None) is None:
            raise RuntimeError("map_importance() has not been called")
        i = param_index(param)
        r = self.map_result
        free_idx = list(self.free_space.free_idx)
        if i not in free_idx:
            # the value the fit held fixed, not the current spec's
            return np.array([float(self.free_space.template[i]), 0.0, 0.0])
        x, logw, _ = self.map_is
        col = x[:, free_idx.index(i)]
        w = np.exp(logw)
        if w.sum() <= 0.0:
            return np.array([r.x[free_idx.index(i)], np.nan, np.nan])
        order = np.argsort(col)
        cw = np.cumsum(w[order])
        cw /= cw[-1]
        p = float(percentile)
        qs = np.array([50.0 - p / 2, 50.0, 50.0 + p / 2]) / 100.0
        lo, mid, hi = np.interp(qs, cw, col[order])
        return np.array([mid, hi - mid, mid - lo])

    def compute_loo_exact(self, bands=None, nburn=100, nsteps=400,
                          thin=1, seed=None, verbose=False):
        """Exact leave-one-band-out elpd by refitting without each band: the
        estimand PSIS-LOO (MBBResults.compute_loo) approximates, for the
        bands whose k-hat it flags. All K refits run as one batch: a
        MultiFitter whose K sources are copies of this photometry, copy i
        with band i missing, sharing this fitter's box, priors, fixed
        parameters, initialization and responses (on CUDA one launch of
        the multi-source kernel per sampling phase).

        bands: names or indices to assess (default: every band that is not
        an upper limit). Diagonal errors only. Returns a
        modelcheck.ExactLooResult."""
        from mbb_emcee_tpu_torch import derived
        from mbb_emcee_tpu_torch.modelcheck import (
            ExactLooResult, gaussian_pointwise_constants)
        from mbb_emcee_tpu_torch.multifit import MultiFitter

        phot = self._require_data()
        if phot.cov is not None:
            raise ValueError(
                "compute_loo_exact supports diagonal errors only (the "
                "batched refit tier has no covariance mode); use "
                "MBBResults.compute_loo -- its pointwise factors are "
                "already the exact conditional predictive densities "
                "under the covariance")
        nb = phot.nbands
        spec = self._spec
        uplim = (np.zeros(nb, bool) if spec.uplim_bands is None
                 else np.asarray(spec.uplim_bands, bool))

        def _band_idx(b):
            if isinstance(b, (int, np.integer)):
                i = int(b)
                if not 0 <= i < nb:
                    raise ValueError(f"band index {i} out of range")
                return i
            if phot.band_names is None:
                raise ValueError(f"band {b!r} given by name but the "
                                 f"photometry has no band names")
            return list(phot.band_names).index(b)

        if bands is None:
            idx = [i for i in range(nb) if not uplim[i]]
        else:
            idx = [_band_idx(b) for b in bands]
            bad = [i for i in idx if uplim[i]]
            if bad:
                raise ValueError(
                    f"bands {bad} are photometric upper limits; a censored "
                    f"band has no pointwise density to assess")
        idx = np.asarray(idx, np.int64)
        K = idx.size
        if K == 0:
            raise ValueError("no bands to assess")

        # K ragged copies: copy j misses band idx[j]
        flux_b = np.tile(phot.flux, (K, 1))
        unc_b = np.tile(phot.unc, (K, 1))
        flux_b[np.arange(K), idx] = np.nan
        unc_b[np.arange(K), idx] = np.nan
        mf = MultiFitter(nwalkers=self.nwalkers,
                         wavenorm=self.shape.wavenorm,
                         noalpha=self.shape.noalpha,
                         opthin=self.shape.opthin,
                         responses=self.responses, a=self.a,
                         sampler_backend=self.sampler_backend,
                         seed=self.seed if seed is None else int(seed),
                         device=self.device)
        mf._spec = _replace(spec)
        mf._init = self._init.copy()
        mf._scatter = self._scatter.copy()
        mf._user_init = self._user_init.copy()
        mf._user_scatter = self._user_scatter.copy()
        mf.set_data(phot.wave, flux_b, unc_b, band_names=phot.band_names)
        mf.run(nburn=int(nburn), nsteps=int(nsteps), verbose=verbose)

        # ln p(y_i | theta) over each refit's own chain: a one-hot pick of
        # the held-out band's pointwise term, batched over copies x samples
        isig, _, _, lnnorm = gaussian_pointwise_constants(unc_det=phot.unc)
        dev = mf.device
        isig, lnnorm, y = (torch.as_tensor(np.asarray(a, np.float32),
                                           device=dev)
                           for a in (isig, lnnorm, phot.flux))
        sel = torch.zeros((K, nb), dtype=torch.float32, device=dev)
        sel[torch.arange(K, device=dev), torch.as_tensor(idx, device=dev)] = 1
        fluxes = derived.band_flux_eval(self.shape, phot.wave,
                                        self._response_pack())

        def one(th):
            r = (fluxes(th) - y) * isig
            return torch.sum(sel[:, None, :] * (lnnorm - 0.5 * r * r),
                             dim=-1)

        samples = mf._thinned(thin)                     # (K, N, 5)
        n = int(samples.shape[1])
        lnp = derived._chunked_samples(one, samples, nb * (
            1 if self.responses is None else
            self._response_pack()[0].shape[1]))         # (K, N)
        m = lnp.max(axis=1, keepdims=True)
        p = np.exp(lnp - m)
        mean_p = p.mean(axis=1)
        elpd = np.log(mean_p) + m[:, 0]
        se_mc = p.std(axis=1, ddof=1) / (np.sqrt(n) * mean_p)
        names = (None if phot.band_names is None
                 else [phot.band_names[i] for i in idx])
        return ExactLooResult(pointwise_loo=elpd, se_mc=se_mc,
                              point_index=idx, nsamples=n, band_names=names)

    def _run_ensembles(self, nburn, nsteps, thin, recenter_burn, verbose,
                       checkpoint=None, checkpoint_interval=100,
                       resume=False):
        """K independent ensembles through MultiFitter on replicated data,
        merged into one (nrec, K * nwalkers, nfree) product so every
        downstream consumer (MBBResults, gelman_rubin) sees one wider
        ensemble."""
        from mbb_emcee_tpu_torch.multifit import MultiFitter

        phot = self._require_data()
        if phot.cov is not None:
            raise ValueError(
                "n_ensembles > 1 uses the batched likelihood (diagonal "
                "uncertainties only); drop the covariance or use "
                "n_ensembles=1")
        if self.mesh is not None:
            # MultiFitter would read the walker mesh as a source mesh over
            # the K ensembles
            raise ValueError(
                "mesh= cannot combine with n_ensembles > 1: the mesh "
                "shards the walker axis of a single fit, while "
                "n_ensembles runs through the batched multi-source path; "
                "drop mesh= (the fused multi kernel is single-chip) or "
                "use MultiFitter directly for source-axis sharding")
        K = self.n_ensembles
        mf = MultiFitter(nwalkers=self.nwalkers,
                         wavenorm=self.shape.wavenorm,
                         noalpha=self.shape.noalpha,
                         opthin=self.shape.opthin,
                         responses=self.responses, seed=self.seed, a=self.a,
                         sampler_backend=self.sampler_backend,
                         device=self.device)
        mf._spec = self._spec
        mf._init = self._init.copy()
        mf._scatter = self._scatter.copy()
        mf._user_init = self._user_init.copy()
        mf._user_scatter = self._user_scatter.copy()
        mf.set_data(phot.wave, np.broadcast_to(phot.flux, (K, phot.nbands)),
                    np.broadcast_to(phot.unc, (K, phot.nbands)),
                    band_names=phot.band_names)
        mf.run(nburn=nburn, nsteps=nsteps, thin=thin,
               recenter_burn=recenter_burn, verbose=verbose,
               checkpoint=checkpoint,
               checkpoint_interval=checkpoint_interval, resume=resume)
        self._merge_ensembles(mf)
        self._mf = mf
        self._backend_used = mf._backend_used
        self.sampler = mf._sampler
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            log = enable_console()
            log.info(f"Merged {K} independent ensembles ({self.nwalkers} "
                     f"walkers each); mean acceptance "
                     f"{self.acceptance_fraction.mean():.3f}")
            if self.chain_free.shape[0] >= 4:
                log.info("  cross-ensemble split-R-hat: " + ", ".join(
                    f"{n}={r:.3f}" for n, r in zip(self.free_param_names,
                                                   self.gelman_rubin())))
        return self

    def _merge_ensembles(self, mf):
        """(K, nrec, nw, nfree) -> (nrec, K * nw, nfree): walker k * nw + w
        of the merged ensemble is walker w of ensemble k."""
        K, nrec, nw, nfree = mf.chain_free.shape
        self.free_space = mf.free_space
        self.thin = mf.thin
        self.chain_free = mf.chain_free.transpose(0, 1).reshape(
            nrec, K * nw, nfree)
        self.lnprobability = mf.lnprobability.transpose(0, 1).reshape(
            nrec, K * nw)
        self.acceptance_fraction = np.asarray(
            mf.acceptance_fraction).reshape(-1)

    def extend(self, nsteps, verbose=False):
        """Continue the production run for `nsteps` more updates from the
        stored final state (no re-burn), appending to the chain -- the
        run-until-converged loop:

            fit.run(nburn=100, nsteps=500)
            while (fit.gelman_rubin() > 1.05).any():
                fit.extend(500)

        The Philox stream continues where the run stopped, so run(n1) +
        extend(n2) is the chain of run(n1 + n2), bit for bit, on both
        backends. n_ensembles > 1: every ensemble, through
        MultiFitter.extend, then merged again."""
        if self.chain_free is None:
            raise RuntimeError("run() has not been called")
        if self._mf is not None:
            self._mf.extend(nsteps, verbose=verbose)
            self._merge_ensembles(self._mf)
            return self
        if getattr(self, "_backend_used", None) in ("hmc", "pt"):
            raise RuntimeError(
                "extend() continues a plain stretch-move run; after "
                "run_hmc()/run_pt() re-run with a larger nsteps instead "
                "(neither keeps resumable sampler state here)")
        if nsteps % self.thin:
            raise ValueError(
                f"nsteps={nsteps} not divisible by thin={self.thin}")
        state, chain, lnp = self.sampler.run_mcmc(
            self.final_state, int(nsteps), self.thin)
        self.chain_free = torch.cat([self.chain_free, chain], dim=0)
        self.lnprobability = torch.cat([self.lnprobability, lnp], dim=0)
        self.final_state = state
        self.acceptance_fraction = self.sampler.acceptance_fraction(state)
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            enable_console().info(
                f"  extended by {nsteps} steps -> "
                f"{self.chain_free.shape[0]} recorded")
        return self

    # -- products --------------------------------------------------------------------
    def _chain_np(self):
        if self.chain_free is None:
            raise RuntimeError("run() has not been called")
        chain = self.chain_free.double().cpu().numpy()
        count("d2h_bytes", chain.nbytes)
        return chain

    @property
    def chain(self):
        """Full-parameter production chain, reference layout
        (nwalkers, nsteps, 5)."""
        full = self.free_space.expand(self._chain_np())
        return np.transpose(full, (1, 0, 2))

    def autocorrelation_time(self):
        return autocorrelation_time(self._chain_np())

    @property
    def free_param_names(self):
        """Free-parameter names in chain-column order."""
        if self.free_space is None:
            raise RuntimeError("run() has not been called")
        return [PARAM_NAMES[i] for i in self.free_space.free_idx]

    def gelman_rubin(self):
        """Split-R-hat per free parameter of the recorded chain."""
        return split_rhat(self._chain_np())

    def converged(self, rhat_max=1.1, tau_mult=None, rhat=None):
        """Every free parameter's split-R-hat below `rhat_max`; with
        `tau_mult`, also a recorded chain at least tau_mult x the largest
        autocorrelation time (a NaN tau counts as 1)."""
        if rhat is None:
            rhat = self.gelman_rubin()
        ok = bool(np.all(np.asarray(rhat) < float(rhat_max)))
        if ok and tau_mult is not None:
            tau = np.nan_to_num(np.asarray(self.autocorrelation_time(),
                                           np.float64), nan=1.0)
            ok = bool(self.chain_free.shape[0] >= float(tau_mult)
                      * float(np.max(tau)))
        return ok
