"""Generic SED fitting: bring-your-own torch model through the full stack.

Torch twin of mbb_emcee_tpu/sed.py. Everything around the modified
blackbody -- the likelihood with covariance, limits, priors, fixed
parameters and upper limits, the burn -> re-center -> re-burn ->
production protocol, response-curve band integration, percentile
summaries, derived-quantity posteriors, HDF5 persistence, posterior-
predictive checks, LOO, and the HMC, PT, nested-sampling and MAP tiers --
is model-agnostic, and this module exposes it for any SED written as a
single-theta torch function

    fnu(theta, wave) -> f_nu  [mJy at observed-frame wave um]

theta a (npar,) fp32 tensor, wave an fp32 tensor of any shape; the result
has wave's shape. The package batches it over parameter rows with
torch.func.vmap(fnu, in_dims=(0, None)) (`batched_fnu`) and differentiates
through that with torch.autograd (HMC forces; MAP's Hessian by double
backward), so fnu is built from plain torch ops: no Python branch on a
tensor value, no .item(), no in-place write to an input.
SEDModel.validate() checks that at fitter construction.

The hand-written kernels are specialized to the 5-parameter MBB chain, so
SEDFitter runs the plain torch stretch-move sampler (sampler.py) on the
fitter's device, as the JAX package runs its portable XLA sampler here. Dust
mass is MBB physics and stays on MBBResults.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.fitter import philox_key, resolve_device
from mbb_emcee_tpu_torch.likelihood import (
    LNPROB_FLOOR, LikelihoodSpec, Photometry, spec_arrays)
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance_batch)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin, _replace
from mbb_emcee_tpu_torch.results import ChainResults
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, autocorrelation_time, make_initial_ball, split_rhat)

_SED_SCHEMA_VERSION = 1


def batched_fnu(fnu):
    """fnu over a leading axis of parameter rows: (theta (n, npar), wave of
    any shape) -> (n,) + wave.shape."""
    return torch.func.vmap(fnu, in_dims=(0, None))


@dataclasses.dataclass(frozen=True)
class SEDModel:
    """A parametric SED: a single-theta torch flux function plus its
    parameter space.

    fnu(theta, wave): theta is a (npar,) fp32 tensor, wave an observed-frame
    wavelength tensor in um OF ANY SHAPE (scalars, the (nbands,) data grid,
    (nbands, nnodes) response-quadrature nodes, (nquad,) L_IR nodes); return
    f_nu in mJy with wave's shape. It is batched with torch.func.vmap and
    differentiated twice with torch.autograd, so write it with plain torch
    ops (everything in models/modified_blackbody.py qualifies).

    lower/upper form the default hard sampling box (narrow per-fit via
    SEDFitter.set_lowlim/set_uplim). `name` labels HDF5 persistence so a
    reload can refuse a mismatched model.

    `guess` (optional) is a HOST-side data-driven initializer:
    guess(wave (nb,), flux (nb,), unc (nb,)) -> (npar,) numpy initial
    centers for one source (plain numpy in, numpy out; called once per
    source at init time). Entries returned as NaN fall back to the default
    (box-center) seed; values are clipped just inside the box; explicit
    set_param_init calls always win.
    """
    fnu: Callable
    param_names: tuple
    lower: np.ndarray
    upper: np.ndarray
    name: str = "custom-sed"
    guess: Callable = None

    def __post_init__(self):
        names = tuple(str(n) for n in self.param_names)
        object.__setattr__(self, "param_names", names)
        lo = np.atleast_1d(np.asarray(self.lower, np.float64))
        hi = np.atleast_1d(np.asarray(self.upper, np.float64))
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", hi)
        if len(names) != len(set(n.lower() for n in names)):
            raise ValueError("parameter names must be unique "
                             "(case-insensitive)")
        if lo.shape != (len(names),) or hi.shape != (len(names),):
            raise ValueError(
                f"lower/upper must be ({len(names)},) arrays matching "
                f"param_names")
        if np.any(lo >= hi):
            raise ValueError("each lower limit must be < its upper limit")

    @property
    def npar(self):
        return len(self.param_names)

    def param_index(self, name_or_idx):
        """Name (case-insensitive) or index -> index, mirroring
        likelihood.param_index for this model's parameter list."""
        if isinstance(name_or_idx, (int, np.integer)):
            idx = int(name_or_idx)
            if not 0 <= idx < self.npar:
                raise ValueError(f"parameter index {idx} out of range")
            return idx
        key = str(name_or_idx).lower()
        lowered = [n.lower() for n in self.param_names]
        if key in lowered:
            return lowered.index(key)
        raise ValueError(f"unknown parameter {name_or_idx!r}; "
                         f"known: {list(self.param_names)}")

    def validate(self, wave=None, device=None):
        """Evaluate fnu at the box center on a small grid on `device` and
        check shape and finiteness; then evaluate it batched over 2 rows
        under torch.func.vmap and take one backward pass, so a model that
        vmap cannot batch or autograd cannot differentiate fails here,
        naming the model, not deep inside a sampler. `device` None is the
        card (fitter.resolve_device: without one this raises, naming
        device="cpu")."""
        device = resolve_device(device)
        wave = np.array([100.0, 250.0, 500.0]) if wave is None \
            else np.atleast_1d(np.asarray(wave, np.float64))
        theta = torch.as_tensor(0.5 * (self.lower + self.upper),
                                dtype=torch.float32, device=device)
        w = torch.as_tensor(wave, dtype=torch.float32, device=device)
        out = torch.as_tensor(self.fnu(theta, w)).detach()
        if tuple(out.shape) != wave.shape:
            raise ValueError(
                f"{self.name}: fnu returned shape {tuple(out.shape)} for "
                f"wave shape {wave.shape}; it must preserve wave's shape")
        if not bool(torch.all(torch.isfinite(out))):
            raise ValueError(
                f"{self.name}: fnu is non-finite at the box center "
                f"(theta={theta.cpu().numpy()}) -- tighten lower/upper or "
                f"guard the model")
        rows = torch.stack([theta, theta]).requires_grad_(True)
        try:
            with torch.enable_grad():
                vals = batched_fnu(self.fnu)(rows, w)
                if vals.requires_grad:
                    torch.autograd.grad(vals.sum(), rows)
        except (RuntimeError, TypeError, ValueError) as e:
            raise ValueError(
                f"{self.name}: fnu does not batch under torch.func.vmap or "
                f"does not differentiate ({type(e).__name__}: {e}); write "
                "it with plain torch ops: no Python branch on a tensor "
                "value, no .item(), no in-place write to an input") from e
        if tuple(vals.shape) != (2,) + wave.shape:
            raise ValueError(
                f"{self.name}: fnu batched over 2 rows returned shape "
                f"{tuple(vals.shape)}, not {(2,) + wave.shape}")
        return self


def apply_model_guess(model, wave, flux, unc, init, scatter,
                      user_init, user_scatter):
    """Fold one source's SEDModel.guess into (init, scatter) IN PLACE.

    Non-user-set entries take the guess (NaN entries keep the default),
    clipped 1% inside the box; their scatter becomes 10% of the guessed
    magnitude (floored at 2% of the box width) unless the user set one.
    Returns (init, scatter) for chaining."""
    if model.guess is None:
        return init, scatter
    g = np.asarray(model.guess(np.asarray(wave, np.float64),
                               np.asarray(flux, np.float64),
                               np.asarray(unc, np.float64)), np.float64)
    if g.shape != (model.npar,):
        raise ValueError(
            f"{model.name}.guess returned shape {g.shape}; need "
            f"({model.npar},)")
    lo, hi = model.lower, model.upper
    width = hi - lo
    gc = np.clip(g, lo + 0.01 * width, hi - 0.01 * width)
    take = ~np.asarray(user_init, bool) & np.isfinite(g)
    init[take] = gc[take]
    stake = take & ~np.asarray(user_scatter, bool)
    scatter[stake] = np.maximum(0.1 * np.abs(gc[stake]),
                                0.02 * width[stake])
    return init, scatter


def _check_spec_size(model, spec):
    if spec.lower.size != model.npar:
        raise ValueError(
            f"spec is sized for {spec.lower.size} parameters; model "
            f"{model.name!r} has {model.npar}")


def _spec_tensors(spec, device):
    """(free space, free_idx, template, lo_free, hi_free, lo_full, hi_full,
    prior_mean, prior_isig) of `spec` as fp32 tensors on `device`."""
    sa = spec_arrays(spec)
    free_idx = torch.as_tensor(sa.free_space.free_idx, device=device)
    return (sa.free_space, free_idx) + tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in sa[1:])


def build_sed_lnprob(phot: Photometry, model: SEDModel,
                     spec: LikelihoodSpec, response_pack=None, device=None):
    """Generic-model twin of likelihood.build_lnprob, with its semantics
    and operation order (box, clip, upper-limit clamp, whitening or
    1/sigma, priors, LNPROB_FLOOR) and the MBB evaluation swapped for the
    vmapped model.fnu on the clipped full vectors. The data grid, response
    nodes and weights move to `device` here, once.

    Returns (lnprob_fn, free_space); lnprob_fn maps a (n, nfree) fp32
    tensor on `device` to (n,). `device` None is the card, as in
    build_lnprob."""
    _check_spec_size(model, spec)
    device = resolve_device(device)
    (free_space, free_idx, template, lo_free, hi_free, lo_full, hi_full,
     prior_mean, prior_isig) = _spec_tensors(spec, device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    data_flux = dev(phot.flux)
    data_wave = dev(phot.wave)
    if phot.cov is not None:
        whiten = dev(np.linalg.inv(np.linalg.cholesky(phot.cov)))
        diag_iunc = None
    else:
        whiten = None
        diag_iunc = dev(1.0 / phot.unc)
    uplim = None
    if spec.uplim_bands is not None and np.any(spec.uplim_bands):
        uplim = torch.as_tensor(np.asarray(spec.uplim_bands, bool),
                                device=device)
    if response_pack is not None:
        resp_waves, resp_weights = (dev(a) for a in response_pack)
    vfnu = batched_fnu(model.fnu)
    npar = model.npar

    def model_fluxes(theta):
        if response_pack is None:
            return vfnu(theta, data_wave)
        return torch.sum(resp_weights * vfnu(theta, resp_waves), dim=-1)

    def lnprob(theta_free):
        n = theta_free.shape[0]
        theta = template.expand(n, npar).clone()
        theta[:, free_idx] = theta_free
        inbox = torch.all((theta_free >= lo_free) & (theta_free <= hi_free),
                          dim=-1)
        theta_safe = torch.minimum(torch.maximum(theta, lo_full), hi_full)
        delta = model_fluxes(theta_safe) - data_flux
        if uplim is not None:
            delta = torch.where(uplim, torch.clamp(delta, min=0.0), delta)
        if whiten is not None:
            r = torch.sum(whiten * delta[:, None, :], dim=-1)
        else:
            r = delta * diag_iunc
        lnl = -0.5 * torch.sum(r * r, dim=-1)
        dp = (theta - prior_mean) * prior_isig
        lnpri = -0.5 * torch.sum(dp * dp, dim=-1)
        return torch.where(inbox, lnl + lnpri,
                           torch.full_like(lnl, LNPROB_FLOOR))

    return lnprob, free_space


def sed_band_flux_eval(fnu, wave, response_pack=None, device=None):
    """fluxes(theta (n, npar)) -> (n, nbands): the generic model's BAND
    fluxes on `device` -- point evaluation at the data wavelengths, or
    response-integrated over a quadrature pack. The generic twin of
    derived.band_flux_eval and the one place this convention lives:
    posterior_predictive and compute_loo reuse it, so their band fluxes can
    never diverge from each other or from the fitted likelihood's. `device`
    None is the card, as in build_lnprob."""
    device = resolve_device(device)
    vfnu = batched_fnu(fnu)
    grids = [torch.as_tensor(np.asarray(a, np.float32), device=device)
             for a in ((wave,) if response_pack is None else response_pack)]

    def fluxes(theta):
        if response_pack is None:
            return vfnu(theta, grids[0])
        return torch.sum(grids[1] * vfnu(theta, grids[0]), dim=-1)
    return fluxes


def build_sed_lnprob_data(model: SEDModel, spec: LikelihoodSpec,
                          response_pack=None, correlated=False,
                          device=None):
    """Generic-model twin of likelihood.build_lnprob_data: the photometry
    arrives as ARGUMENTS, with a leading source axis, so one function
    serves a whole catalog.

    Returns (lnprob_fn, free_space) with
        lnprob_fn(theta_free (S, n, nfree), wave (nb,), flux (S, nb),
                  iunc (S, nb)) -> (S, n)
    where iunc is the SIGNED 1/sigma of likelihood.signed_iunc (negative:
    that band's flux is a one-sided upper limit for that source; 0: a
    missing band). With correlated=True the 4th argument is instead a
    per-source (S, nb, nb) whitening matrix W, r = W delta (rows and
    columns of missing bands zero). One-sided upper limits do not compose
    with correlated errors: spec.uplim_bands must then be unset. `device`
    None is the card, as in build_lnprob."""
    _check_spec_size(model, spec)
    device = resolve_device(device)
    if correlated and spec.uplim_bands is not None and np.any(
            np.asarray(spec.uplim_bands)):
        raise ValueError(
            "photometric upper limits (one-sided likelihood) do not "
            "compose with correlated band errors; unset one of them")
    (free_space, free_idx, template, lo_free, hi_free, lo_full, hi_full,
     prior_mean, prior_isig) = _spec_tensors(spec, device)
    if response_pack is not None:
        resp_waves, resp_weights = (
            torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in response_pack)
    vfnu = batched_fnu(model.fnu)
    npar = model.npar

    def lnprob(theta_free, wave, flux, iunc):
        nsrc, n = theta_free.shape[:2]
        theta = template.expand(nsrc, n, npar).clone()
        theta[..., free_idx] = theta_free
        inbox = torch.all((theta_free >= lo_free) & (theta_free <= hi_free),
                          dim=-1)
        theta_safe = torch.minimum(torch.maximum(theta, lo_full), hi_full)
        rows = theta_safe.reshape(nsrc * n, npar)
        if response_pack is None:
            model_flux = vfnu(rows, wave)
        else:
            model_flux = torch.sum(resp_weights * vfnu(rows, resp_waves),
                                   dim=-1)
        delta = model_flux.reshape(nsrc, n, -1) - flux[:, None, :]
        if correlated:
            r = torch.sum(iunc[:, None, :, :] * delta[:, :, None, :],
                          dim=-1)
        else:
            u = iunc[:, None, :]
            delta = torch.where(u < 0, torch.clamp(delta, min=0.0), delta)
            r = delta * torch.abs(u)
        lnl = -0.5 * torch.sum(r * r, dim=-1)
        dp = (theta - prior_mean) * prior_isig
        lnpri = -0.5 * torch.sum(dp * dp, dim=-1)
        return torch.where(inbox, lnl + lnpri,
                           torch.full_like(lnl, LNPROB_FLOOR))

    return lnprob, free_space


class SEDFitter(ParamSpaceMixin):
    """Fit a user SEDModel to photometry with the reference's protocol.

    The orchestration mirrors MBBFitter (burn -> re-center on the best
    burn-in sample -> re-burn -> reset -> production) on the plain torch
    stretch-move sampler on `device` ("cuda", the default, raises without a
    card; or "cpu"). The walker balls come from a CPU torch.Generator seeded
    with `seed`, the proposals from the Philox stream of
    fitter.philox_key(seed), which run(n1) + extend(n2) continues, so that
    chain is run(n1 + n2)'s bit for bit. The parameter-space setters
    (set_lowlim/set_uplim/fix_param/set_gaussian_prior/set_param_init) and
    the data surface (set_data/read_data/read_cov/set_responses/
    set_phot_upperlimits) keep the MBB fitter's names and semantics,
    addressed by the MODEL's parameter names.

    Walkers start in a ball around the box center with 5%-of-center scatter
    (or the model's `guess`) unless set_param_init() says otherwise.
    """

    def __init__(self, model: SEDModel, nwalkers=250, photfile=None,
                 redshift=None, seed=207, a=2.0, device=None):
        if not isinstance(model, SEDModel):
            raise TypeError("model must be an SEDModel")
        self.device = resolve_device(device)
        model.validate(device=self.device)
        self.model = model
        self.nwalkers = int(nwalkers)
        self.redshift = None if redshift is None else float(redshift)
        self.seed = int(seed)
        self.a = float(a)
        self.responses = None

        self._spec = LikelihoodSpec.for_box(model.lower, model.upper)
        center = 0.5 * (model.lower + model.upper)
        self._init = center.copy()
        self._scatter = np.where(np.abs(center) > 0,
                                 0.05 * np.abs(center),
                                 0.05 * (model.upper - model.lower))
        self._user_init = np.zeros(model.npar, bool)
        self._user_scatter = np.zeros(model.npar, bool)

        self.phot = None
        self.chain_free = None       # (nrec, nwalkers, nfree) tensor
        self.lnprobability = None    # (nrec, nwalkers) tensor
        self.burn_chain_free = None
        self.free_space = None
        self.thin = 1
        self.logz_pt = None          # (lnZ, err) stepping stone, run_pt()
        self.logz_ti = None
        self.evidence = None         # NestedResult, compute_evidence()
        self._acceptance = None
        self._state = None
        self._sampler = None
        self._run_token = None

        if photfile is not None:
            self.read_data(photfile)

    # -- ParamSpaceMixin hooks ---------------------------------------------------------
    def _param_index(self, param):
        return self.model.param_index(param)

    def _effective_spec(self):
        # No shape-implied fixing for generic models.
        return self._spec

    # -- data --------------------------------------------------------------------------
    def _refuse_uplim_cov(self):
        """The uplim-vs-covariance invariant holds in BOTH setter orders:
        set_phot_upperlimits refuses when a covariance is attached, and
        attaching a covariance refuses when limits are already set."""
        ul = self._spec.uplim_bands
        if ul is not None and np.asarray(ul).any():
            raise ValueError("photometric upper limits do not compose "
                             "with a full covariance")

    def _guess(self):
        apply_model_guess(self.model, self.phot.wave, self.phot.flux,
                          self.phot.unc, self._init, self._scatter,
                          self._user_init, self._user_scatter)

    def set_data(self, wave, flux, unc, cov=None, band_names=None):
        if cov is not None:
            self._refuse_uplim_cov()
        self.phot = Photometry(wave, flux, unc, cov=cov,
                               band_names=band_names)
        self._guess()
        return self

    def read_data(self, photfile):
        """Text photometry '[name] wave flux unc' (Photometry.from_file)."""
        self.phot = Photometry.from_file(photfile)
        self._guess()
        return self

    def read_cov(self, covfile, covextn=0, is_total=False):
        self._refuse_uplim_cov()
        self._require_data().read_cov(covfile, covextn, is_total=is_total)
        return self

    def set_responses(self, response_set):
        """Instrument response curves (response.ResponseSet); requires
        named photometry bands. Band fluxes are then response-integrated
        exactly as in MBBFitter's response mode."""
        self.responses = response_set
        return self

    def set_phot_upperlimits(self, mask):
        """Mark photometry bands as upper limits (one-sided penalty for
        model flux above the quoted value)."""
        phot = self._require_data()
        mask = np.asarray(mask, bool)
        if mask.shape != (phot.nbands,):
            raise ValueError(
                f"uplim mask shape {mask.shape} != ({phot.nbands},)")
        if phot.cov is not None and mask.any():
            raise ValueError("photometric upper limits do not compose "
                             "with a full covariance")
        self._spec = _replace(self._spec, uplim_bands=mask)
        return self

    def _require_data(self):
        if self.phot is None:
            raise RuntimeError("no photometry; call set_data/read_data")
        return self.phot

    def _response_pack(self):
        if self.responses is None:
            return None
        phot = self._require_data()
        if phot.band_names is None:
            raise ValueError("response mode requires named photometry bands")
        return self.responses.pack(phot.band_names)

    # -- lnprob ------------------------------------------------------------------------
    def _lnprob(self, spec=None):
        """(batched lnprob, free space) of `spec` (default: the fitter's)
        on the fitter's device."""
        return build_sed_lnprob(
            self._require_data(), self.model,
            self.spec if spec is None else spec,
            response_pack=self._response_pack(), device=self.device)

    def build(self):
        """(lnprob, free_space, sampler) for the current data + spec."""
        lnprob, free_space = self._lnprob()
        lnprob.label = repr(self.model.name)        # sampler._label
        sampler = EnsembleSampler(self.nwalkers, free_space.nfree, lnprob,
                                  a=self.a)
        return lnprob, free_space, sampler

    def __call__(self, params):
        """lnprob at a FULL parameter vector (MBBFitter.__call__
        semantics): fixed-parameter values in `params` override the
        configured ones for this evaluation; the box and priors still apply
        to every slot. The built lnprob is cached on the posterior's
        content token, so per-sample loops pay no rebuild per call."""
        params = np.asarray(params, np.float64)
        n = self.model.npar
        if params.shape != (n,):
            raise ValueError(f"expected a ({n},) full parameter vector")
        token = self._posterior_token()
        cache = getattr(self, "_call_cache", None)
        if cache is None or cache[0] != token:
            open_spec = _replace(self.spec, fixed=np.zeros(n, bool),
                                 fixed_values=np.zeros(n))
            cache = (token, self._lnprob(open_spec)[0])
            self._call_cache = cache
        x = torch.as_tensor(params[None, :].astype(np.float32),
                            device=self.device)
        return float(cache[1](x)[0])

    # -- the run -----------------------------------------------------------------------
    def _ball(self, center, scatter, n, free_space, gen=None):
        if gen is None:
            gen = torch.Generator().manual_seed(self.seed)
        return make_initial_ball(gen, center, scatter, n, free_space.lower,
                                 free_space.upper, device=self.device)

    def _start(self, free_space, p0, n):
        """(n, nfree) start positions on the fitter's device: p0 (full or
        free space) or the default walker ball."""
        idx = free_space.free_idx
        if p0 is None:
            return self._ball(self._init[idx], self._scatter[idx], n,
                              free_space)
        p0 = torch.as_tensor(np.asarray(p0, np.float32), device=self.device)
        if p0.shape[-1] == self.model.npar:
            p0 = p0[..., torch.as_tensor(idx, device=self.device)]
        return p0

    def run(self, nburn=50, nsteps=250, thin=1, p0=None,
            recenter_burn=True, verbose=False, init="auto"):
        """Burn -> re-center on the best burn-in sample -> re-burn ->
        reset -> production (the reference protocol). Stores the
        production chain on the fitter's device; wrap in SEDResults for
        analysis/persistence. init='map' seeds the walker ball at the
        fit_map() mode with ~2 Laplace-sigma scatter (requires fit_map on
        this data first). Returns self."""
        if int(thin) < 1:
            raise ValueError(f"thin={thin} must be >= 1")
        if int(nsteps) % int(thin):
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        if init not in ("auto", "map"):
            raise ValueError(f"init must be 'auto' or 'map'; got {init!r}")
        if init == "map" and p0 is not None:
            raise ValueError("init='map' conflicts with an explicit p0")
        thin = int(thin)
        _, free_space, sampler = self.build()
        self.free_space = free_space
        self.thin = thin
        idx = free_space.free_idx
        gen = torch.Generator().manual_seed(self.seed)
        if init == "map":
            self._require_map_fresh("run(init='map')")
            r = self.map_result
            if r.x.size != free_space.nfree:
                raise RuntimeError(
                    "the parameter space changed since fit_map(); re-run "
                    "fit_map before init='map'")
            # cap degenerate Laplace sigmas (same rule as MBBFitter)
            scatter = np.minimum(np.clip(2.0 * r.sigma, 1e-6, None),
                                 self._scatter[idx] * 10.0)
            p0 = self._ball(np.asarray(r.x, np.float64), scatter,
                            self.nwalkers, free_space, gen)
        elif p0 is None:
            p0 = self._ball(self._init[idx], self._scatter[idx],
                            self.nwalkers, free_space, gen)
        else:
            p0 = self._start(free_space, p0, self.nwalkers)
        state = sampler.init_state(p0, seed=philox_key(self.seed))
        self.burn_chain_free = None
        if nburn > 0:
            state, bchain, blnp = sampler.run_mcmc(state, nburn)
            self.burn_chain_free = bchain
            if recenter_burn:
                # the whole ensemble in a tight ball on the best burn-in
                # sample, burned again; the Philox stream continues
                flat = bchain.reshape(-1, free_space.nfree)
                best = flat[int(torch.argmax(blnp.reshape(-1)))]
                p0b = self._ball(best.double().cpu().numpy(),
                                 self._scatter[idx] * 0.1, self.nwalkers,
                                 free_space, gen)
                state = sampler.init_state(p0b, seed=state.seed,
                                           step=state.step)
                state = sampler.advance(state, nburn)
            state = sampler.reset_counters(state)

        state, chain, lnp = sampler.run_mcmc(state, nsteps, thin)
        self.chain_free = chain
        self.lnprobability = lnp
        self._state = state
        self._sampler = sampler
        self._acceptance = EnsembleSampler.acceptance_fraction(state)
        self._run_token = self._posterior_token()
        self.logz_pt = self.logz_ti = None
        if verbose:
            print(f"SEDFitter[{self.model.name}] on {self.device}: "
                  f"acceptance {np.mean(self.acceptance_fraction):.3f}, "
                  f"max split-R-hat {self.gelman_rubin()[1].max():.3f}")
        return self

    def extend(self, nsteps):
        """Continue the production run (same posterior, the same Philox
        stream where it stopped) and append to the stored chain -- the
        run-until-converged loop; run(n1) + extend(n2) is run(n1 + n2)'s
        chain bit for bit."""
        if self._state is None:
            raise RuntimeError("extend() needs a finished run()")
        if self._posterior_token() != self._run_token:
            raise RuntimeError(
                "the posterior (spec/data/responses) changed since run(); "
                "re-run instead of extending across different targets")
        if int(nsteps) % self.thin:
            raise ValueError(
                f"nsteps={nsteps} not divisible by thin={self.thin}")
        state, chain, lnp = self._sampler.run_mcmc(
            self._state, int(nsteps), self.thin)
        self.chain_free = torch.cat([self.chain_free, chain], dim=0)
        self.lnprobability = torch.cat([self.lnprobability, lnp], dim=0)
        self._state = state
        self._acceptance = EnsembleSampler.acceptance_fraction(state)
        return self

    def _posterior_token(self):
        from mbb_emcee_tpu_torch.checkpoint import data_fingerprint
        phot = self._require_data()
        pack = self._response_pack()
        spec = self.spec
        uplim = (None if spec.uplim_bands is None
                 else np.asarray(spec.uplim_bands))
        spec_fp = data_fingerprint(
            spec.lower, spec.upper, spec.fixed, spec.fixed_values,
            spec.prior_mean, spec.prior_isigma, uplim,
            np.asarray([self.a]))
        return (data_fingerprint(phot.wave, phot.flux, phot.unc, phot.cov,
                                 *(() if pack is None else pack)),
                spec_fp, self.model.name)

    # -- alternative sampler tiers (all generic: they see only lnprob) -------------------
    def _tier_done(self, chain, lnp, acceptance):
        """Record an HMC / PT production chain; extend() refuses it."""
        self.chain_free = chain
        self.lnprobability = lnp
        self._acceptance = np.asarray(acceptance)
        self._state = self._sampler = None
        self.burn_chain_free = None
        self.logz_pt = self.logz_ti = None

    def run_hmc(self, nwarmup=500, nsteps=1000, thin=1, n_leapfrog=16,
                target_accept=0.8, nchains=None, p0=None, verbose=False):
        """Gradient-based HMC alternative to run() (hmc.py, the same tier
        as MBBFitter.run_hmc): the forces are torch.autograd of the vmapped
        user model on the fitter's device. Downstream analysis (results(),
        gelman_rubin, writeToHDF5) is unchanged; extend() does not apply
        (re-run with more nsteps)."""
        from mbb_emcee_tpu_torch import hmc

        nchains = self.nwalkers if nchains is None else int(nchains)
        lnprob, free_space = self._lnprob()
        self.free_space = free_space
        self.thin = int(thin)
        x0 = self._start(free_space, p0, nchains)
        graphs = hmc._HMCGraphs()
        res = hmc._sample(lnprob, free_space.lower, free_space.upper, x0,
                          philox_key(self.seed), graphs, nwarmup=nwarmup,
                          nsteps=nsteps, thin=thin, n_leapfrog=n_leapfrog,
                          target_accept=target_accept)
        self._hmc_mode = graphs.mode     # "graph": one captured transition
        self._tier_done(res.chain, res.lnprob, res.acceptance_fraction)
        self.hmc_result = res
        if verbose:
            print(f"HMC[{self.model.name}]: mean acceptance "
                  f"{self._acceptance.mean():.3f}, step size "
                  f"{res.step_size:.4g}, {nchains} chains x {nsteps} steps")
        return self

    def run_pt(self, nrungs=12, beta_min="auto", nburn=300, nsteps=1000,
               nchains=None, thin=1, p0=None, verbose=False):
        """Parallel-tempering alternative to run() for multimodal
        posteriors (tempering.py, the same tier as MBBFitter.run_pt): K
        rungs with replica exchange; the recorded chain is the cold rung,
        and the run also yields the evidence (self.logz_pt stepping-stone,
        self.logz_ti thermodynamic check)."""
        from mbb_emcee_tpu_torch.tempering import pt_sample

        nchains = self.nwalkers if nchains is None else int(nchains)
        lnprob, free_space = self._lnprob()
        self.free_space = free_space
        self.thin = int(thin)
        x0 = self._start(free_space, p0, nchains)
        res = pt_sample(lnprob, x0, philox_key(self.seed), nrungs=nrungs,
                        beta_min=beta_min, nburn=nburn, nsteps=nsteps,
                        thin=thin, a=self.a)
        self._tier_done(res.chain, res.lnprob, res.acceptance_fraction[0])
        self.logz_pt = (res.logz, res.logz_err)
        self.logz_ti = (res.logz_ti, res.logz_ti_err)
        self.pt_result = res
        if verbose:
            print(f"PT[{self.model.name}]: {res.betas.size} rungs x "
                  f"{nchains} walkers, cold acceptance "
                  f"{self._acceptance.mean():.3f}, stepping-stone lnZ = "
                  f"{res.logz:.3f} +/- {res.logz_err:.3f}")
        return self

    def compute_evidence(self, nlive=512, nbatch=32, nsteps=32,
                         max_iter=3000, tol=1e-4, seed=None,
                         verbose=False):
        """Bayesian evidence ln Z of THIS model configuration by nested
        sampling (nested.py) -- Bayes factors between model variants (1- vs
        2-component, free vs fixed parameters) on the same data -- with the
        prior convention of MBBFitter.compute_evidence: the normalized
        uniform prior over the free box times any Gaussian prior factors.
        The draws come from the Philox stream of philox_key(seed) (default:
        the fitter's seed). Returns a NestedResult with samples expanded to
        the full parameter space; also stored as self.evidence."""
        from mbb_emcee_tpu_torch.nested import nested_sample

        lnprob, free_space = self._lnprob()
        if not (np.all(np.isfinite(free_space.lower))
                and np.all(np.isfinite(free_space.upper))):
            raise ValueError("nested sampling requires finite box bounds")
        res = nested_sample(
            lnprob, free_space.lower, free_space.upper,
            philox_key(self.seed if seed is None else int(seed)),
            nlive=nlive, nbatch=nbatch, nsteps=nsteps, max_iter=max_iter,
            tol=tol, device=self.device)
        res = dataclasses.replace(res, samples=free_space.expand(res.samples))
        self.evidence = res
        if verbose:
            print(f"nested[{self.model.name}]: lnZ = {res.logz:.3f} +/- "
                  f"{res.logz_err:.3f} ({res.n_iter} iterations)")
        return res

    def fit_map(self, nstarts=8, n_adam=150, n_newton=12, adam_lr=0.1,
                verbose=False):
        """MAP point + Laplace error bars (mapfit.py, the same machinery as
        MBBFitter.fit_map): multi-start Adam-then-damped-Newton in the
        sigmoid-unconstrained box on the fitter's device, then the inverse
        Hessian (double backward through the vmapped model) at the mode.
        Returns a MAPResult (free space; stored as self.map_result);
        interior=False flags a mode near a box bound -- run the MCMC."""
        from mbb_emcee_tpu_torch.mapfit import (
            MAPResult, map_fit, laplace_cov_host, interior_mask)

        lnprob, free_space = self._lnprob()
        if not (np.all(np.isfinite(free_space.lower))
                and np.all(np.isfinite(free_space.upper))):
            raise ValueError(
                "MAP fitting requires finite box bounds on every free "
                "parameter")
        idx = free_space.free_idx
        x0 = self._ball(self._init[idx], self._scatter[idx], int(nstarts),
                        free_space)
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
        self._map_token = self._posterior_token()
        self.free_space = free_space
        if verbose:
            names = [self.model.param_names[i] for i in idx]
            parts = [f"{n}={v:.4g}+/-{s:.3g}"
                     for n, v, s in zip(names, x_map, sigma)]
            print(f"MAP[{self.model.name}] ({nstarts} starts): "
                  + ", ".join(parts) + f"; lnprob={float(lnp_map):.2f}"
                  + ("" if interior else
                     " [mode near a box bound -- Laplace suspect]"))
        return self.map_result

    def _require_map_fresh(self, what):
        if getattr(self, "map_result", None) is None:
            raise RuntimeError(f"{what} requires fit_map() on this data "
                               f"first")
        if getattr(self, "_map_token", None) != self._posterior_token():
            raise RuntimeError(
                f"{what}: the stored MAP fit is for a different posterior "
                f"-- the parameter space, data, or responses changed "
                f"since fit_map(); re-run fit_map() first")

    def map_importance(self, nsamples=2048, seed=None):
        """Laplace importance sampling after fit_map(): weighted
        true-posterior summaries without MCMC (MBBFitter.map_importance's
        semantics: ess/nsamples near 1 certifies the Gaussian; a small ess
        says run the MCMC). The draws come from a CPU torch.Generator
        seeded with `seed` (default: the fitter's). Returns (samples, logw,
        ess), also stored as self.map_is."""
        from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR
        self._require_map_fresh("map_importance")
        r = self.map_result
        lnprob, free_space = self._lnprob()
        d = free_space.nfree
        N = int(nsamples)
        L = np.linalg.cholesky(r.cov)
        logdet = float(np.sum(np.log(np.diag(L))))
        gen = torch.Generator().manual_seed(
            self.seed if seed is None else int(seed))
        eps = torch.randn((N, d), generator=gen,
                          dtype=torch.float32).double().numpy()
        x = r.x[None, :] + eps @ L.T
        lnp = lnprob(torch.as_tensor(x.astype(np.float32),
                                     device=self.device))
        lnp = lnp.double().cpu().numpy()
        lnq = (-0.5 * np.sum(eps ** 2, axis=1) - logdet
               - 0.5 * d * np.log(2.0 * np.pi))
        # out-of-box draws sit at the finite floor: mask them to -inf
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
        errors; ess = 0 reports the MAP point with NaN errors."""
        if getattr(self, "map_is", None) is None:
            raise RuntimeError("map_importance() has not been called")
        i = self._param_index(param)
        r = self.map_result
        free_idx = list(self.free_space.free_idx)
        if i not in free_idx:
            # the value the RUN held fixed, not the current spec's
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

    # -- chain views ---------------------------------------------------------------------
    def _require_run(self):
        if self.chain_free is None:
            raise RuntimeError("fitter has not been run")

    def _chain_np(self):
        self._require_run()
        return self.chain_free.double().cpu().numpy()

    @property
    def chain(self):
        """(nwalkers, nsteps, npar) full-space production chain."""
        free = np.transpose(self._chain_np(), (1, 0, 2))
        return self.free_space.expand(free)

    @property
    def acceptance_fraction(self):
        self._require_run()
        return self._acceptance

    def gelman_rubin(self):
        """(names, rhat) over the free parameters."""
        names = [self.model.param_names[i]
                 for i in self.free_space.free_idx]
        return names, split_rhat(self._chain_np())

    def autocorrelation_time(self):
        return autocorrelation_time(self._chain_np())

    def results(self, **kw):
        """SEDResults for this finished run (analysis + persistence)."""
        return SEDResults(fit=self, **kw)


class SEDResults(ChainResults):
    """Analysis/persistence for an SEDFitter run -- the generic-model
    MBBResults (same summaries, same batched derived quantities on the
    results' device, same HDF5 dual constructor).

    Construct with fit= (a run SEDFitter; its device) or h5file= (device=
    None: the card) plus model= to re-enable model-dependent computations
    on a reload: chains and stored derived quantities load without it, but
    sed_percentiles / compute_lir / compute_peaklambda /
    posterior_predictive / compute_loo need the flux function. Dust mass is
    absent: kappa B_nu(T) is MBB physics (use MBBResults)."""

    def __init__(self, fit=None, h5file=None, model=None, redshift=None,
                 cosmology=None, lumdist=None, device=None):
        self._setup(fit, h5file, redshift, cosmology, lumdist, device)
        if fit is not None:
            if model is not None and model is not fit.model:
                raise ValueError("model= conflicts with fit.model")
            self._from_fit(fit)
        else:
            self.model = model
            self._from_h5(h5file)

    # -- construction --------------------------------------------------------------------
    def _from_fit(self, fit):
        fit._require_run()
        self.model = fit.model
        if self.redshift is None and fit.redshift is not None:
            self.redshift = float(fit.redshift)
        self.chain = fit.chain                       # (nw, nsteps, npar)
        self.lnprobability = np.transpose(
            fit.lnprobability.double().cpu().numpy(), (1, 0))
        self.acceptance_fraction = np.asarray(fit.acceptance_fraction)
        self.phot = fit.phot
        self.param_spec = fit.spec
        self.param_init = fit._init.copy()
        self.thin = fit.thin
        self.nwalkers = int(self.chain.shape[0])
        self.response_pack = fit._response_pack()

    def _from_h5(self, h5file):
        import h5py
        from mbb_emcee_tpu_torch.modelcheck import read_loo_group

        def text(v):
            return v.decode() if isinstance(v, bytes) else str(v)

        explicit_z, explicit_dl = self.redshift, self.lumdist
        with h5py.File(h5file, "r") as f:
            if text(f.attrs.get("kind", "")) != "sed":
                raise ValueError(
                    f"{h5file} is not an SEDResults file (MBB results load "
                    f"via MBBResults)")
            stored_names = tuple(text(n) for n in f.attrs["param_names"])
            stored_model = text(f.attrs.get("model_name", ""))
            if self.model is not None:
                if tuple(self.model.param_names) != stored_names:
                    raise ValueError(
                        f"model {self.model.name!r} has parameters "
                        f"{self.model.param_names}; file stores "
                        f"{stored_names}")
                if self.model.name != stored_model:
                    raise ValueError(
                        f"file was written by model {stored_model!r}, "
                        f"got {self.model.name!r}")
            self._stored_param_names = stored_names
            self.model_name = stored_model
            self.chain = np.asarray(f["Chain"], np.float64)
            self.lnprobability = np.asarray(f["LogLike"], np.float64)
            self.acceptance_fraction = np.asarray(
                f["AcceptanceFraction"], np.float64)
            self.nwalkers = int(f.attrs["nwalkers"])
            self.thin = int(f.attrs["thin"])
            z = float(f.attrs["redshift"])
            if self.redshift is None and np.isfinite(z):
                self.redshift = z
            dl = float(f.attrs["lumdist"])
            if self.lumdist is None and np.isfinite(dl):
                self.lumdist = dl
            cname = text(f.attrs.get("cosmology", b""))
            if cname and not self._cosmology_explicit:
                self._cosmo = Cosmology.named(cname)
                self.cosmology_name = cname
            ph = f["Photometry"]
            names = None
            if "BandNames" in ph:
                names = [text(n) for n in ph["BandNames"][()]]
            self.phot = Photometry(
                np.asarray(ph["Wave"]), np.asarray(ph["Flux"]),
                np.asarray(ph["FluxUnc"]),
                cov=np.asarray(ph["Cov"]) if "Cov" in ph else None,
                band_names=names)
            pc = f["ParamConfig"]
            uplim = (np.asarray(pc["PhotUpperLimits"], bool)
                     if "PhotUpperLimits" in pc else None)
            self.param_spec = LikelihoodSpec(
                lower=np.asarray(pc["Lower"], np.float64),
                upper=np.asarray(pc["Upper"], np.float64),
                fixed=np.asarray(pc["Fixed"], bool),
                fixed_values=np.asarray(pc["FixedValues"], np.float64),
                prior_mean=np.asarray(pc["PriorMean"], np.float64),
                prior_isigma=np.asarray(pc["PriorInvSigma"], np.float64),
                uplim_bands=uplim)
            self.param_init = np.asarray(pc["Initial"], np.float64)
            if "Response" in f:
                g = f["Response"]
                self.response_pack = (np.asarray(g["Nodes"], np.float64),
                                      np.asarray(g["Weights"], np.float64))
            for name, attr in (("LIRChain", "lir"),
                               ("DustMassChain", "dustmass")):
                if name in f:
                    setattr(self, f"{attr}_chain",
                            np.asarray(f[name], np.float64))
                    setattr(self, f"{attr}_meta",
                            {k: f[name].attrs[k] for k in f[name].attrs})
            if "PeakLambdaChain" in f:
                self.peaklambda_chain = np.asarray(
                    f["PeakLambdaChain"], np.float64)
            if "LOO" in f:
                self.loo_result = read_loo_group(f["LOO"])

        # Constructor arguments win over stored metadata.
        if explicit_z is not None:
            self.redshift = explicit_z
        if explicit_dl is not None:
            self.lumdist = explicit_dl

    # -- basic summaries -------------------------------------------------------------------
    @property
    def param_names(self):
        return (tuple(self.model.param_names) if self.model is not None
                else self._stored_param_names)

    def _param_index(self, param):
        if self.model is not None:
            return self.model.param_index(param)
        if isinstance(param, (int, np.integer)):
            return int(param)
        lowered = [n.lower() for n in self._stored_param_names]
        key = str(param).lower()
        if key in lowered:
            return lowered.index(key)
        raise ValueError(f"unknown parameter {param!r}; "
                         f"known: {list(self._stored_param_names)}")

    def best_fit_model(self):
        """Callable wave -> f_nu (mJy, host fp64) at the
        maximum-probability sample."""
        fnu = self._require_model().fnu
        theta = torch.as_tensor(np.asarray(self.best_fit[0], np.float32),
                                device=self.device)

        def sed(wave):
            w = torch.as_tensor(np.asarray(wave, np.float32),
                                device=self.device)
            return fnu(theta, w).double().cpu().numpy()
        return sed

    def gelman_rubin(self):
        return split_rhat(self._free_chain())

    # -- model-dependent computations ---------------------------------------------------------
    def _require_model(self):
        if self.model is None:
            raise RuntimeError(
                "this computation evaluates the SED model; reload with "
                "SEDResults(h5file=..., model=<the SEDModel>)")
        return self.model

    def _band_fluxes(self):
        return sed_band_flux_eval(self._require_model().fnu, self.phot.wave,
                                  self.response_pack, device=self.device)

    def _over_samples(self, one, thin):
        """one(theta (npar,)) vmapped over the thinned chain in chunks of
        derived.CHUNK rows on the results' device; host fp64."""
        return derived.batched(torch.func.vmap(one),
                               self._samples(thin)).double().cpu().numpy()

    def sed_percentiles(self, waves, percentile=68.3, thin=1):
        """(3, nwave) [median, upper, lower] posterior SED band in mJy --
        batched evaluation (samples x wavelengths)."""
        fnu = self._require_model().fnu
        w = torch.as_tensor(np.atleast_1d(np.asarray(waves, np.float32)),
                            device=self.device)
        fluxes = self._over_samples(lambda th: fnu(th, w), thin)
        return derived.sed_band(fluxes, percentile, sample_axis=0)

    def compute_lir(self, wavemin=8.0, wavemax=1000.0, thin=1,
                    z_param=None):
        """Posterior of L_IR(wavemin-wavemax um REST) in L_sun: the
        MBBResults formula (GL quadrature in ln-lambda, fp64 host
        prefactor) applied to the generic model.

        z_param: name (or index) of a SAMPLED redshift parameter. Each chain
        sample is then integrated over its own observed window
        [wavemin, wavemax]*(1+z_i) with its own luminosity distance (one
        vectorized fp64 D_L pass), i.e. the L_IR posterior is marginalized
        over the z posterior. Requires a cosmology; an explicit scalar
        lumdist= contradicts a per-sample z and raises."""
        model = self._require_model()
        fnu = model.fnu
        if z_param is None:
            lam, w = derived.lir_nodes_weights(self._opz(), wavemin,
                                               wavemax)
            lam_t, w_t = (torch.as_tensor(a.astype(np.float32),
                                          device=self.device)
                          for a in (lam, w))
            integ = self._over_samples(
                lambda th: torch.sum(w_t * fnu(th, lam_t)), thin)
            prefac = derived.lir_prefactor(self._dl_mpc())
        else:
            if self.lumdist is not None:
                raise ValueError(
                    "explicit lumdist= cannot combine with z_param: "
                    "each sample carries its own redshift")
            zi = model.param_index(z_param)
            integ = self._over_samples(derived.lir_zparam_integrand(
                fnu, zi, wavemin, wavemax, device=self.device), thin)
            zvec = np.asarray(self._thinned(thin)[:, zi], np.float64)
            prefac = derived.lir_prefactor(
                luminosity_distance_batch(zvec, self._cosmo))
        self.lir_chain = prefac * integ
        self.lir_meta = {"wavemin": float(wavemin),
                         "wavemax": float(wavemax), "thin": int(thin)}
        if z_param is not None:
            self.lir_meta["z_param"] = str(z_param)
        return self.lir_chain

    def compute_peaklambda(self, thin=1, lo=derived.PEAK_RANGE[0],
                           hi=derived.PEAK_RANGE[1]):
        """Posterior of the OBSERVED f_nu peak wavelength (um): batched
        golden-section in ln-lambda on log f_nu (ops/rootfind.golden_max),
        one sample per vmapped row."""
        from mbb_emcee_tpu_torch.ops.rootfind import golden_max
        fnu = self._require_model().fnu
        ulo, uhi = (torch.tensor(float(np.log(v)), dtype=torch.float32,
                                 device=self.device) for v in (lo, hi))

        def peak(theta):
            def logf(u):
                lam = torch.exp(u)
                # a 0-dim lambda (one sample's point under vmap) goes in
                # as a 1-element grid and comes back as a scalar
                f = fnu(theta, lam[None] if lam.dim() == 0 else lam)
                return torch.log(torch.clamp(f, min=1e-30)).reshape(())
            um, _ = golden_max(logf, ulo, uhi, iters=derived.PEAK_ITERS)
            return torch.exp(um)

        self.peaklambda_chain = self._over_samples(peak, thin)
        return self.peaklambda_chain

    def plot_pz(self, **kw):
        """P(z) posterior figure for photo-z fits (plotting.plot_pz)."""
        from mbb_emcee_tpu_torch import plotting
        return plotting.plot_pz(self, **kw)

    # -- persistence ------------------------------------------------------------------------------
    def writeToHDF5(self, filename):
        """Persist chains + settings in the JAX package's kind='sed' schema
        (the MBB schema's logical layout, tagged with the model name and
        parameter list), so either package's SEDResults reads the file."""
        import h5py
        from mbb_emcee_tpu_torch.modelcheck import write_loo_group
        with h5py.File(filename, "w") as f:
            f.attrs["schema_version"] = _SED_SCHEMA_VERSION
            f.attrs["package"] = "mbb_emcee_tpu_torch"
            f.attrs["kind"] = "sed"
            f.attrs["model_name"] = self.model_name_str.encode()
            f.attrs["param_names"] = np.array(
                [n.encode() for n in self.param_names])
            f.attrs["nwalkers"] = self.nwalkers
            f.attrs["thin"] = self.thin
            f.attrs["redshift"] = (np.nan if self.redshift is None
                                   else self.redshift)
            f.attrs["lumdist"] = (np.nan if self.lumdist is None
                                  else self.lumdist)
            f.attrs["cosmology"] = (self.cosmology_name or "").encode()
            f.create_dataset("Chain",
                             data=np.asarray(self.chain, np.float32),
                             compression="gzip")
            f.create_dataset("LogLike",
                             data=np.asarray(self.lnprobability,
                                             np.float32),
                             compression="gzip")
            f.create_dataset("AcceptanceFraction",
                             data=np.asarray(self.acceptance_fraction,
                                             np.float32))
            ph = f.create_group("Photometry")
            ph.create_dataset("Wave", data=self.phot.wave)
            ph.create_dataset("Flux", data=self.phot.flux)
            ph.create_dataset("FluxUnc", data=self.phot.unc)
            if self.phot.cov is not None:
                ph.create_dataset("Cov", data=self.phot.cov)
            if self.phot.band_names is not None:
                ph.create_dataset("BandNames", data=np.array(
                    [n.encode() for n in self.phot.band_names]))
            if self.response_pack is not None:
                g = f.create_group("Response")
                g.create_dataset("Nodes", data=np.asarray(
                    self.response_pack[0], np.float64))
                g.create_dataset("Weights", data=np.asarray(
                    self.response_pack[1], np.float64))
            spec = self.param_spec
            pc = f.create_group("ParamConfig")
            pc.create_dataset("Lower", data=spec.lower)
            pc.create_dataset("Upper", data=spec.upper)
            pc.create_dataset("Fixed", data=spec.fixed.astype(np.uint8))
            pc.create_dataset("FixedValues", data=spec.fixed_values)
            pc.create_dataset("PriorMean", data=spec.prior_mean)
            pc.create_dataset("PriorInvSigma", data=spec.prior_isigma)
            pc.create_dataset("Initial", data=self.param_init)
            if spec.uplim_bands is not None:
                pc.create_dataset("PhotUpperLimits", data=np.asarray(
                    spec.uplim_bands, np.uint8))
            for name, chain, meta in (
                    ("LIRChain", self.lir_chain, self.lir_meta),
                    ("DustMassChain", self.dustmass_chain,
                     self.dustmass_meta)):
                if chain is not None:
                    ds = f.create_dataset(name, data=chain,
                                          compression="gzip")
                    for k, v in (meta or {}).items():
                        ds.attrs[k] = v
            if self.peaklambda_chain is not None:
                f.create_dataset("PeakLambdaChain",
                                 data=self.peaklambda_chain,
                                 compression="gzip")
            if self.loo_result is not None:
                write_loo_group(f, self.loo_result)
        return filename

    @property
    def model_name_str(self):
        return (self.model.name if self.model is not None
                else getattr(self, "model_name", "custom-sed"))

    def __repr__(self):
        lines = [f"SEDResults[{self.model_name_str}]:"]
        fixed = self.param_spec.fixed
        for i, name in enumerate(self.param_names):
            if fixed[i]:
                lines.append(f"  {name:12s} fixed at "
                             f"{self.param_spec.fixed_values[i]:.5g}")
            else:
                c = self.par_cen(i)
                lines.append(f"  {name:12s} {c[0]:.5g} "
                             f"+{c[1]:.3g} -{c[2]:.3g}")
        if self.lir_chain is not None:
            c = derived._percentile_summary(self.lir_chain)
            lines.append(f"  L_IR        {c[0]:.4g} +{c[1]:.3g} -{c[2]:.3g} "
                         f"L_sun")
        if self.peaklambda_chain is not None:
            c = derived._percentile_summary(self.peaklambda_chain)
            lines.append(f"  peak lambda {c[0]:.5g} +{c[1]:.3g} -{c[2]:.3g} "
                         f"um (observed)")
        return "\n".join(lines)
