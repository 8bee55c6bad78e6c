"""The batch tier's one engine: data, the stretch-move run protocol, the
device-side summaries and every inference tier, shared by MultiFitter (the
5-parameter MBB; multifit.py) and SEDMultiFitter (a user SEDModel;
sedmulti.py).

Torch twin of mbb_emcee_tpu/batchengine.py: the data setters (:183-353),
the run / extend / checkpoint protocol (:465-702), the summaries (:704-843),
the derived-quantity plumbing (:846-897) and the PT, HMC, MAP, nested,
PPC and LOO tiers (:899-1913). The JAX engine's program cache and
traced-program plumbing have no counterpart: torch runs eagerly, and the
multi-source kernel takes the whole batch in one launch.

Source mesh (the JAX engine's _shard / shard_map legs, :363-463): with
`mesh` (a parallel.walker_mesh) every tier splits the source axis into
mesh.size contiguous blocks (_shards), runs its per-source computation on
each block on that shard's device -- the sampler, the PT / HMC / MAP /
nested cores, the model's band fluxes of PPC and LOO -- with the block's
GLOBAL source indices, so each source draws the Philox streams it draws
unsharded, and joins the results in source order on the mesh's first
device, where the chains, states and summaries live (_on_shards). Every
per-source result is therefore the unsharded run's bit for bit, and a
checkpoint written under one mesh resumes under another or none (the
streams do not depend on the partitioning; mesh_token is recorded).

An adapter class supplies the likelihood and the model through a small
hook surface; the engine never looks inside the operands:

  _lnprob_operands(spec)  -> the batch likelihood on this data: .plain(theta
                             (S, n, nfree)) -> (S, n), .fn(theta, .wave,
                             *.data), .free_space (MultiOperands for the
                             MBB, PlainBatchOperands for a generic model)
  _build_sampler(spec)    -> the run protocol's sampler (.free_space,
                             init_state / advance / run_mcmc /
                             reset_counters / acceptance_fraction: K3's
                             FusedMultiSampler, or sampler.
                             MultiEnsembleSampler on the plain likelihood);
                             it sets self._sampler and self._backend_used
  _init_centers(init)     -> (S, npar) full-space walker-ball centers and
                             scatters; init="map" is _map_centers()
  _band_flux_eval()       -> fluxes(theta (S, n, npar)) -> (S, n, nb), the
                             model's band fluxes as the likelihood sees them
                             (PPC, LOO)
  _model_token(spec)      -> everything the likelihood is built from
                             besides the per-source data (model, parameter
                             space, wavelengths, response pack): the
                             engine's _posterior_token (the identity
                             extend() refuses to splice across) and _map_key
                             (what stored MAP results bind to) add the batch
                             geometry, upper limits and band correlation
  _per_source_priors()    -> {name: (mean (S,), 1/sigma (S,))}, the
                             per-source interim Gaussian priors that
                             HierarchicalFitter.from_batch divides out
                             (default: none)
  _spec_fingerprint(spec) -> the hash of the parameter space and model in a
                             checkpoint (default spec: the fitter's)
  _response_pack()        -> the (nodes, weights) quadrature pack or None
  _param_names            -> the full-space parameter names
  _param_index(param)     -> name or index -> index (ParamSpaceMixin)
  _engine_label()         -> the tag of log lines

Chains stay on the fitter's device as (S, nrec, nwalkers, nfree) tensors;
par_cen, best_fit, split-R-hat and the autocorrelation time are batched
reductions over all sources there, so a multi-GB catalog chain never has to
cross to the host for a summary.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.checkpoint import production
from mbb_emcee_tpu_torch.constants import PARAM_NAMES
from mbb_emcee_tpu_torch.fitter import philox_key
from mbb_emcee_tpu_torch.likelihood import signed_iunc
from mbb_emcee_tpu_torch.models.cosmology import luminosity_distance_batch
from mbb_emcee_tpu_torch.paramspace import _replace
from mbb_emcee_tpu_torch.utils.profiling import count, span
from mbb_emcee_tpu_torch.sampler import (
    MultiEnsembleSampler, make_initial_ball)


def _cut(x, lo, hi, device):
    """Rows lo:hi of x's leading (source) axis, on `device`: tensors, numpy
    arrays, and dataclasses and tuples of them field by field; any other
    value (ints, floats, None) is shared and passes unchanged."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi].to(device)
    if isinstance(x, np.ndarray):
        return x[lo:hi]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _cut(getattr(x, f.name), lo, hi, device)
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        parts = [_cut(v, lo, hi, device) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def _join(parts, device):
    """The shards' results joined in source order (the inverse of _cut):
    tensors concatenated on `device`, numpy arrays concatenated, dataclasses
    and tuples field by field; any other value is the same on every shard
    and is taken once."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(x, np.ndarray):
        return np.concatenate(parts)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _join([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        joined = [_join(list(v), device) for v in zip(*parts)]
        return type(x)(*joined) if hasattr(x, "_fields") else tuple(joined)
    if any(p != x for p in parts[1:]):
        raise AssertionError(f"shards disagree on a shared value: {parts}")
    return x


# A shard of the source axis: its view of the fitter (_shard_view), what the
# tier built on it, its global source indices and block on its device.
_Shard = collections.namedtuple("_Shard", "view obj sources lo hi device")


class _ShardedBatchSampler:
    """The run protocol's sampler over the source shards: each shard's own
    sampler (K3, or the plain multi run) on its block of sources, the state
    whole on the fitter's device between calls and cut per call (without a
    mesh, the one sampler called directly)."""

    def __init__(self, engine, shards):
        self._shards = shards
        self._on_shards = engine._on_shards
        self.free_space = shards[0].obj.free_space

    def _on(self, fn, *args):
        return self._on_shards(self._shards, fn, *args)

    def init_state(self, p0, seed, step=0):
        return self._on(lambda s, _, p: s.init_state(p, seed, step), p0)

    def run_mcmc(self, state, nsteps, thin=1):
        return self._on(lambda s, _, st: s.run_mcmc(st, nsteps, thin), state)

    def advance(self, state, nsteps):
        return self._on(lambda s, _, st: s.advance(st, nsteps), state)

    reset_counters = staticmethod(MultiEnsembleSampler.reset_counters)
    acceptance_fraction = staticmethod(
        MultiEnsembleSampler.acceptance_fraction)

    @property
    def graph_mode(self):
        """The tuple of the shards' samplers' graph_mode ("graph" or
        "eager" after a plain multi run; None on K3), in shard order."""
        return tuple(getattr(sh.obj, "graph_mode", None)
                     for sh in self._shards)


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


@dataclasses.dataclass
class PlainBatchOperands:
    """A batch likelihood without a kernel: fn(theta (S, n, nfree), wave,
    *data) -> (S, n) on per-source operands `data` (each with a leading
    source axis) on one device."""
    wave: torch.Tensor
    data: tuple
    fn: object
    free_space: object

    def plain(self, theta_free):
        return self.fn(theta_free, self.wave, *self.data)


class BatchEngine:
    """Batch-tier surface shared by MultiFitter and SEDMultiFitter: data,
    upper limits, band correlation, the stretch-move run protocol, the
    batched summaries and the inference tiers, over the hook surface of the
    module docstring. Host classes carry wave/flux/unc, band_names/
    source_names/redshifts, free_space, chain_free, lnprobability,
    acceptance_fraction, device, nwalkers, seed, a, _spec, _init, _scatter
    (ParamSpaceMixin)."""

    _param_names = PARAM_NAMES
    mesh = None         # a parallel.walker_mesh over the source axis
    _source0 = 0        # global index of the first source (a shard's view)

    def _engine_label(self):
        return type(self).__name__

    # -- the source mesh ---------------------------------------------------------
    def _mesh_token(self):
        from mbb_emcee_tpu_torch.parallel.mesh import mesh_token
        return str(mesh_token(self.mesh))

    def _shard_view(self, lo, hi, device):
        """This fitter restricted to sources lo:hi on `device`: the block's
        per-source data, upper-limit mask and metadata, and its first
        global source index. Adapters with more per-source state extend
        it."""
        import copy
        v = copy.copy(self)
        v.mesh = None
        v.device = device
        v._source0 = self._source0 + lo
        v.flux, v.unc = self.flux[lo:hi], self.unc[lo:hi]
        for name in ("source_names", "redshifts"):
            if getattr(self, name) is not None:
                setattr(v, name, getattr(self, name)[lo:hi])
        ub = self._spec.uplim_bands
        if ub is not None and ub.ndim == 2:
            v._spec = _replace(self._spec, uplim_bands=ub[lo:hi])
        return v

    def _shards(self, build):
        """Per shard of the source mesh, build(view) on its block's view
        with the block's global source indices on its device; without a
        mesh one shard, the whole batch, built on the fitter itself."""
        S = self.nsources
        if self.mesh is None:
            return [_Shard(self, build(self), torch.arange(
                S, device=self.device) + self._source0, 0, S, None)]
        from mbb_emcee_tpu_torch.parallel.mesh import mesh_blocks
        out = []
        for lo, hi, dev in mesh_blocks(self.mesh, S):
            v = self._shard_view(lo, hi, dev)
            out.append(_Shard(v, build(v), torch.arange(lo, hi, device=dev)
                              + self._source0, lo, hi, dev))
        return out

    def _on_shards(self, shards, fn, *args):
        """fn(shard.obj, shard.sources, *args) on every shard, `args` with a
        leading source axis cut to its block on its device (_cut), the
        results joined in source order on the fitter's device (_join).
        Without a mesh, one call on the whole batch."""
        if shards[0].device is None:
            return fn(shards[0].obj, shards[0].sources, *args)
        # every block is cut before any shard's work is queued: a copy off
        # the fitter's device waits for the work queued there, so a cut
        # made after the first shard's launch would hold the other cards
        # until that shard's run ended
        cuts = [[_cut(a, sh.lo, sh.hi, sh.device) for a in args]
                for sh in shards]
        return _join([fn(sh.obj, sh.sources, *c)
                      for sh, c in zip(shards, cuts)], self.device)

    def _shard_operands(self, spec):
        """Per shard, the batch likelihood on its block (_lnprob_operands;
        without a mesh, on the whole batch under `spec`)."""
        return self._shards(lambda v: v._lnprob_operands(
            spec if v is self else v._effective_spec()))

    def _batch_sampler(self, spec):
        """The run protocol's sampler: the adapter's (_build_sampler) on
        every shard's block (_ShardedBatchSampler; without a mesh one
        shard, the whole batch under `spec`)."""
        shards = self._shards(lambda v: v._build_sampler(
            spec if v is self else v._effective_spec()))
        self._backend_used = shards[0].view._backend_used
        self._sampler = _ShardedBatchSampler(self, shards)
        return self._sampler

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
        with span("mbb.fit.set_data"):
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
                # A per-source mask binds to source identities, not to
                # the batch geometry: a new same-shape catalog must not
                # inherit it.
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
        """(S, nwalkers, nrec, npar) full-parameter chains (reference
        layout per source), host numpy."""
        self._require_run()
        full = self.free_space.expand(self.chain_free.double().cpu().numpy())
        return np.transpose(full, (0, 2, 1, 3))

    def flatchain(self):
        """(S, nrec * nwalkers, npar), host numpy."""
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
        return [self._param_names[i] for i in self.free_space.free_idx]

    def par_cen(self, param, percentile=68.3):
        """(S, 3): per-source (median, +err, -err), computed on the chain's
        device and interpreted under the spec the run sampled (a parameter
        fixed at run time reports its fixed value with zero errors)."""
        self._require_run()
        i = self._param_index(param)
        fs = self.free_space
        hit = np.nonzero(fs.free_idx == i)[0]
        if hit.size == 0:
            v = float(fs.template[i])
            return np.tile([v, 0.0, 0.0], (self.nsources, 1))
        with span("mbb.results.percentiles", param=param):
            data = self.chain_free[..., int(hit[0])].reshape(
                self.nsources, -1)
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
                count("d2h_bytes", vals.nbytes)
                out.append(vals[:, 0]
                           + (vals[:, 1] - vals[:, 0]) * (pos - lo))
            lo, mid, hi = out
        return np.stack([mid, hi - mid, mid - lo], axis=1)

    def best_fit(self):
        """(params (S, npar), lnprob (S,)) at each source's max-lnp
        sample."""
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
        """Each source's D_L in Mpc: `lumdists` as given, else one
        vectorised pass over every redshift under `cosmology` (a named
        set, a Cosmology, None for the default, or one explicit D_L for
        every source)."""
        if lumdists is not None:
            return np.asarray(lumdists, np.float64)
        z = np.asarray(redshifts, np.float64).ravel()
        with span("mbb.derived.distance", redshifts=int(z.size)):
            if isinstance(cosmology, (int, float)):
                return np.full(z.size, float(cosmology))
            return luminosity_distance_batch(z, cosmology)

    def _thinned(self, thin):
        """(S, nsamp, npar) fp32 thinned full-parameter samples on the
        chain's device."""
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

    # -- the stretch-move run protocol ------------------------------------------
    def _balls(self, gen, centers, scatters, n=None):
        """(S, n, nfree) balls (n = nwalkers by default), one per source in
        source order from the CPU generator `gen`, reflected at the box:
        built on the host and moved to the fitter's device in one copy."""
        fs = self.free_space
        n = self.nwalkers if n is None else int(n)
        return torch.stack([
            make_initial_ball(gen, c, s, n, fs.lower, fs.upper, device="cpu")
            for c, s in zip(centers, scatters)]).to(self.device)

    def _map_centers(self):
        """init="map"'s (S, npar) centers and scatters: each source's
        run_map() mode with ~2 Laplace-sigma scatter, capped at 10x the
        default scatter, so the ensemble starts in the typical set and
        short burns suffice."""
        if getattr(self, "map_params", None) is None:
            raise RuntimeError(
                "init='map' requires run_map() on this data first")
        self._require_map_fresh("init='map'")
        S = self.nsources
        centers = self.map_params.copy()
        scatters = np.broadcast_to(self._scatter,
                                   (S, self._scatter.size)).copy()
        idx = self.free_space.free_idx
        sig = np.clip(2.0 * self.map_sigma, 1e-6, None)
        scatters[:, idx] = np.minimum(sig, scatters[:, idx] * 10.0)
        return centers, scatters

    def _posterior_token(self, spec):
        """Identity of the posterior a run sampled (extend() refuses to
        splice chains across a change): the model, geometry, band
        correlation CONTENT, upper-limit mask and band names."""
        uplim = (None if spec.uplim_bands is None
                 else np.asarray(spec.uplim_bands).tobytes())
        return (self._model_token(spec), self.nsources, self.nwalkers,
                int(self.thin), float(self.a),
                None if self._band_corr is None
                else self._band_corr.tobytes(),
                uplim,
                None if self.band_names is None
                else tuple(self.band_names))

    def _map_key(self, spec):
        """What stored MAP results bind to besides the data: the model and
        parameter space, the upper-limit mask and the band correlation."""
        return (self._model_token(spec), self.nsources,
                None if spec.uplim_bands is None
                else np.asarray(spec.uplim_bands).tobytes(),
                None if self._band_corr is None
                else self._band_corr.tobytes())

    def _per_source_priors(self):
        return {}

    def _record_map(self, spec):
        self._map_token = self._map_key(spec)
        self._map_data = (self.flux.copy(), self.unc.copy(),
                          self.wave.copy())

    def _require_map_fresh(self, what):
        """Refuse stored MAP results after the posterior or the data changed
        (the same nfree does not mean the same free parameters)."""
        data = getattr(self, "_map_data", None)
        if (getattr(self, "_map_token", None)
                != self._map_key(self._effective_spec())
                or data is None
                or not (np.array_equal(data[0], self.flux)
                        and np.array_equal(data[1], self.unc)
                        and np.array_equal(data[2], self.wave))):
            raise RuntimeError(
                f"{what}: the stored MAP results are for a different batch "
                f"/ parameter space / error model; re-run run_map() first")

    def _same_data(self):
        return (getattr(self, "_run_data", None) is not None
                and np.array_equal(self._run_data[0], self.flux)
                and np.array_equal(self._run_data[1], self.unc)
                and np.array_equal(self._run_data[2], self.wave))

    def run(self, nburn=50, nsteps=250, thin=1, recenter_burn=True,
            verbose=False, checkpoint=None, checkpoint_interval=100,
            resume=False, init="auto"):
        """Burn -> per-source re-center on its best walker -> re-burn ->
        reset -> production, all sources in lockstep; each phase is one
        call of the adapter's sampler (_build_sampler). init="map" seeds
        each source's walker ball at its run_map() mode (_map_centers).

        With `checkpoint=path` the production run is segmented and the
        per-source chain blocks and the full batch sampler state are
        flushed to HDF5 every `checkpoint_interval` recorded steps
        (checkpoint.production); `resume=True` continues an interrupted run
        from that file, bitwise the uninterrupted chain. A resume under
        another sampler backend, data or posterior is refused. Returns
        self."""
        if self.flux is None:
            raise RuntimeError("no data; call set_data")
        if int(thin) < 1:
            raise ValueError(f"thin={thin} must be >= 1")
        if nsteps % thin:
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        if init not in ("auto", "map"):
            raise ValueError(f"init must be 'auto' or 'map'; got {init!r}")
        if resume and not checkpoint:
            raise ValueError(
                "resume=True requires checkpoint= (the path the previous "
                "run flushed state to); without it the run would silently "
                "restart from scratch")
        with span("mbb.fit.run", nburn=int(nburn), nsteps=int(nsteps),
                  thin=int(thin), nsources=self.nsources):
            # before the sampler replaces free_space: init="map" reads
            # run_map's
            centers = self._init_centers(init)
            spec = self._effective_spec()
            samp = self._batch_sampler(spec)
            self.free_space = samp.free_space
            self._run_spec = spec       # persisted by writeToHDF5
            self.thin = int(thin)
            state, chain, lnpchain = production(
                samp.run_mcmc,
                lambda: self._burn(samp, nburn, recenter_burn, centers),
                nsteps, thin, self.device, checkpoint, checkpoint_interval,
                bool(checkpoint and resume and os.path.exists(checkpoint)),
                None if checkpoint is None
                else self._checkpoint_meta(nsteps), multi=True,
                verbose=verbose)
            self._record(state, chain, lnpchain)
            self._run_data = (self.flux.copy(), self.unc.copy(),
                              self.wave.copy())
            self._post_token = self._posterior_token(spec)
            self.logz_pt = self.logz_ti = self.swap_fraction = None
            self.pt_betas = self.hmc_step_size = self.hmc_mass = None
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            af = self.acceptance_fraction
            enable_console().info(
                f"{self._engine_label()} ({self._backend_used} on "
                f"{self.device}): mean acceptance fraction over "
                f"{self.nsources} sources: {af.mean():.3f} (per-source min "
                f"{af.mean(1).min():.3f}, max {af.mean(1).max():.3f})")
        return self

    def _burn(self, samp, nburn, recenter_burn, init_centers):
        """The start state of production: the per-source walker balls
        around `init_centers` ((S, npar) centers and scatters), burn-in,
        per-source re-center, re-burn, counters reset."""
        fs = self.free_space
        centers, scatters = init_centers
        cen_f, sca_f = centers[:, fs.free_idx], scatters[:, fs.free_idx]
        gen = torch.Generator().manual_seed(self.seed)
        with span("mbb.fit.ball"):
            state = samp.init_state(self._balls(gen, cen_f, sca_f),
                                    seed=philox_key(self.seed))
        if nburn > 0:
            with span("mbb.fit.burn"):
                state = samp.advance(state, nburn)
            if recenter_burn:
                # Each source re-centers on the best walker of ITS final
                # burn state (not the single fit's whole-burn-chain rule);
                # the Philox streams continue where the burn stopped.
                with span("mbb.fit.recentre"):
                    S = self.nsources
                    best = state.pos[
                        torch.arange(S, device=state.pos.device),
                        torch.argmax(state.lnp, dim=1)]
                    best = best.double().cpu().numpy()
                    count("d2h_bytes", best.nbytes)
                    p0b = self._balls(gen, best, 0.1 * sca_f)
                    state = samp.init_state(p0b, seed=state.seed,
                                            step=state.step)
                with span("mbb.fit.reburn"):
                    state = samp.advance(state, nburn)
            with span("mbb.fit.reset"):
                state = samp.reset_counters(state)
        return state

    def _checkpoint_meta(self, nsteps):
        """The run identity a batch checkpoint records (see
        MBBFitter._checkpoint_meta); the band correlation enters the data
        fingerprint only when set, as in the JAX package."""
        from mbb_emcee_tpu_torch.checkpoint import (
            PRNG_IMPL, data_fingerprint, new_run_id)
        pack = self._response_pack()
        return {"nwalkers": self.nwalkers, "nsources": self.nsources,
                "thin": self.thin, "nsteps_target": int(nsteps),
                "sampler_backend": self._backend_used,
                "prng_impl": PRNG_IMPL, "seed": self.seed,
                "data_fingerprint": data_fingerprint(
                    self.wave, self.flux, self.unc,
                    *(() if self._band_corr is None
                      else (self._band_corr,)),
                    *(() if pack is None else pack)),
                "spec_fingerprint": self._spec_fingerprint(),
                "mesh_token": self._mesh_token(),
                "run_id": new_run_id()}

    def _record(self, state, chain, lnpchain):
        with span("mbb.fit.record"):
            self.final_state = state
            self.chain_free = chain
            self.lnprobability = lnpchain
            self.acceptance_fraction = self._sampler.acceptance_fraction(
                state)
            count("d2h_bytes", self.acceptance_fraction.nbytes)

    def extend(self, nsteps, verbose=False):
        """Continue the production run of every source from the stored
        final state (the run-until-converged serving loop). The Philox
        streams continue, so run(n1) + extend(n2) gives the chain of the
        longer run(n1 + n2), on every backend."""
        if getattr(self, "final_state", None) is None:
            raise RuntimeError(
                "extend() requires a prior stretch-move run() on this "
                "fitter (run_hmc/run_pt runs are not continuable -- re-run "
                "with more steps; a reloaded file carries no sampler "
                "state)")
        if not self._same_data():
            raise RuntimeError(
                "set_data() was called after run(); extend() would keep "
                "sampling the PREVIOUS batch's posterior -- call run() "
                "for the new data instead")
        spec = self._effective_spec()
        if self._posterior_token(spec) != self._post_token:
            raise RuntimeError(
                "the parameter space / error model / band configuration "
                "changed after run(); extend() would splice chains from "
                "different posteriors -- call run() instead")
        if nsteps % self.thin:
            raise ValueError(
                f"nsteps={nsteps} not divisible by thin={self.thin}")
        state, chain, lnp = self._sampler.run_mcmc(
            self.final_state, int(nsteps), self.thin)
        self._record(state, torch.cat([self.chain_free, chain], dim=1),
                     torch.cat([self.lnprobability, lnp], dim=1))
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            enable_console().info(
                f"  extended by {nsteps} steps -> "
                f"{self.chain_free.shape[1]} recorded per source")
        return self

    # -- PT and HMC tiers -------------------------------------------------------
    def _engine_record_nonextendable(self, kind):
        """Post-run bookkeeping for tiers whose chains extend() does not
        continue (PT / HMC; their checkpoint= makes them resumable): drop
        the stretch-move continuation state, so extend() refuses, and the
        other tier's results."""
        self.final_state = None
        self._sampler = None
        if kind != "pt":
            self.logz_pt = self.logz_ti = None
            self.swap_fraction = self.pt_betas = None
        if kind != "hmc":
            self.hmc_step_size = self.hmc_mass = None

    def _engine_posterior_fp(self, spec):
        """Short content hash of the posterior a PT / HMC run samples (data,
        band correlation, response pack, parameter space), stored in its
        checkpoint and re-checked on resume: resuming another posterior
        would splice chains silently."""
        from mbb_emcee_tpu_torch.checkpoint import data_fingerprint
        pack = self._response_pack()
        return data_fingerprint(
            self.wave, self.flux, self.unc,
            *(() if self._band_corr is None else (self._band_corr,)),
            *(() if pack is None else pack),
            np.asarray([self._spec_fingerprint(spec)]))

    def _tier_ck_meta(self, spec, extra):
        """The run identity a PT / HMC checkpoint records: geometry, seed,
        stretch scale, posterior, and the tier's own settings (`extra`)."""
        return {"nwalkers": self.nwalkers, "nsources": self.nsources,
                "thin": int(self.thin), "seed": int(self.seed),
                "a": float(self.a),
                "posterior_fp": self._engine_posterior_fp(spec), **extra}

    def _tier_ck_check(self, meta, spec, expect, path):
        """Refuse a checkpoint of another generator, geometry, seed,
        posterior or tier setting (`expect`)."""
        from mbb_emcee_tpu_torch.checkpoint import (
            PRNG_IMPL, check_resume_meta)
        check_resume_meta(meta, self._tier_ck_meta(
            spec, dict(expect, prng_impl=PRNG_IMPL)), path)

    def _tier_resume(self, checkpoint, tier, spec, expect, nrec, thin):
        """(state arrays, aux arrays, chain blocks, lnp blocks, records
        done, run_id) of a PT / HMC checkpoint after the resume checks."""
        from mbb_emcee_tpu_torch.checkpoint import load_tier_checkpoint
        st, aux, chain, lnp, meta = load_tier_checkpoint(checkpoint, tier)
        self._tier_ck_check(meta, spec, expect, checkpoint)
        done = 0 if chain is None else chain.shape[1]
        if done > nrec:
            raise ValueError(
                f"checkpoint already holds {done} records; this run "
                f"targets only {nrec} -- resume with nsteps >= "
                f"{done * thin}")
        run_id = meta.get("run_id")
        run_id = run_id.decode() if isinstance(run_id, bytes) else run_id
        return (st, aux, [] if chain is None else [chain],
                [] if lnp is None else [lnp], done, run_id)

    def _tier_checks(self, nsteps, thin, resume, checkpoint):
        if self.flux is None:
            raise RuntimeError("no data; call set_data")
        if int(thin) < 1:
            raise ValueError(f"thin={thin} must be >= 1")
        if nsteps % thin:
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        if int(nsteps) // int(thin) <= 0:
            raise ValueError(
                f"nsteps={nsteps} yields zero recorded steps at "
                f"thin={thin}")
        if resume and not checkpoint:
            raise ValueError(
                "resume=True requires checkpoint= (the path the previous "
                "run flushed state to)")

    @staticmethod
    def _tier_chain(blocks, device):
        """One (S, nrec, ...) tensor on `device` from record blocks (device
        tensors, or host arrays when the run was checkpointed)."""
        if all(isinstance(b, torch.Tensor) for b in blocks):
            return torch.cat(blocks, dim=1)
        return torch.as_tensor(np.concatenate(
            [b.cpu().numpy() if isinstance(b, torch.Tensor) else b
             for b in blocks], axis=1), device=device)

    def run_pt(self, nrungs=12, beta_min="auto", nburn=300, nsteps=1000,
               thin=1, verbose=False, checkpoint=None,
               checkpoint_interval=100, resume=False):
        """Batched parallel tempering (tempering.py): every source gets K
        temperature rungs x W walkers, all (S, K, W) advancing in lockstep
        on the batch likelihood's plain version on the fitter's device (no
        kernel takes per-source operands for an arbitrary set of vectors;
        the JAX package's batch PT runs its XLA likelihood the same way).

        Three phases: a SCOUT burn on a shared coarse ladder; a main BURN on
        the (with beta_min="auto") per-source adapted ladders
        (tempering.auto_ladder_batch; one rung count K for the batch),
        seeded rung by nearest rung from the scout state; and PRODUCTION
        segments carrying the tempered state and the stepping-stone
        accumulators from segment to segment (tempering.pt_segment).

        With `checkpoint=path` production is segmented every
        `checkpoint_interval` records and the tempered state, ladders and
        evidence accumulators are flushed (checkpoint.save_tier_checkpoint);
        `resume=True` continues an interrupted run from that file toward
        the same nsteps target, the chain bit for bit the uninterrupted
        run's (a kill during scout or burn restarts those phases).

        The recorded chain is each source's cold rung, so chain_free,
        lnprobability and acceptance_fraction have run()'s shapes and every
        batched summary works unchanged. Per source: self.logz_pt = (lnZ
        (S,), err (S,)) by stepping stone, self.logz_ti by thermodynamic
        integration, self.swap_fraction (S, K-1), self.pt_betas (S, K).
        extend() does not apply."""
        from mbb_emcee_tpu_torch.tempering import (
            PTState, SSStats, _SUPPORT_FLOOR, auto_ladder_batch,
            geometric_ladder, init_pt_state, nearest_rungs, pt_advance,
            pt_segment, reset_counters, thermodynamic_logz)

        self._tier_checks(nsteps, thin, resume, checkpoint)
        if self.nwalkers % 2:
            raise ValueError("nwalkers must be even")
        spec = self._effective_spec()
        shards = self._shard_operands(spec)
        free_space = shards[0].obj.free_space
        self.free_space = free_space
        self._run_spec = spec       # persisted by writeToHDF5
        self.thin = int(thin)
        S, W, d = self.nsources, self.nwalkers, free_space.nfree
        dev = self.device
        a = self.a
        nrec = int(nsteps) // int(thin)
        adapt = beta_min == "auto"
        K1 = int(nrungs)
        sources = torch.arange(S, device=dev)
        resuming = bool(checkpoint and resume and os.path.exists(checkpoint))
        interval = max(1, int(checkpoint_interval))
        expect = {"nrungs": K1, "nburn": int(nburn)}
        run_id = None
        if resuming:
            st, aux, chain_blocks, lnp_blocks, done, run_id = \
                self._tier_resume(checkpoint, "pt", spec, expect, nrec,
                                  int(thin))
            betas_b = np.asarray(aux["betas"], np.float64)
            state = PTState(
                **{k: torch.as_tensor(st[k], device=dev) for k in (
                    "pos", "lnp", "naccept", "nswap", "nswap_prop")},
                nsteps=int(st["nsteps"]), seed=int(st["seed"]),
                step=int(st["step"]))
            ss = SSStats(aux["ss_m"], aux["ss_s1"], aux["ss_s2"],
                         float(aux["ss_n"]))
            lnp_sum = np.asarray(aux["acc"], np.float64)
        else:
            cen, sca = self._init_centers()
            idx = free_space.free_idx
            p0 = self._balls(torch.Generator().manual_seed(self.seed),
                             cen[:, idx], sca[:, idx])
            # -- phase 1: scout burn on a shared coarse ladder
            scout = geometric_ladder(K1, 1e-2 if adapt else float(beta_min))
            state = self._on_shards(
                shards, lambda ops, _, p: init_pt_state(
                    p, ops.plain, philox_key(self.seed)),
                p0[:, None].expand(S, K1, W, d).contiguous())
            state = self._on_shards(
                shards, lambda ops, src, st, b: pt_advance(
                    st, ops.plain, b, nburn, a, src),
                state, torch.as_tensor(
                    scout, dtype=torch.float32, device=dev).expand(S, K1))
            # -- ladder adaptation (host, tiny)
            if adapt:
                lnp_h = state.lnp.double().cpu().numpy()       # (S, K1, W)
                masked = np.where(lnp_h > _SUPPORT_FLOOR, lnp_h, np.nan)
                with np.errstate(all="ignore"):
                    worst = np.nanmin(masked.reshape(S, -1), axis=1)
                worst = np.where(np.isfinite(worst), worst, -1e6)
                betas_b = auto_ladder_batch(worst, nrungs_min=K1)
                near = torch.as_tensor(nearest_rungs(betas_b, scout),
                                       device=dev)             # (S, K2)
                pos0 = state.pos[sources[:, None], near]
                nburn2 = max(int(nburn) // 2, 50)
            else:
                betas_b = np.broadcast_to(scout, (S, K1)).copy()
                pos0 = state.pos
                nburn2 = 0
            # -- phase 2: (re-)burn on the adapted ladders
            seed, step = state.seed, state.step
            state = self._on_shards(
                shards, lambda ops, _, p: init_pt_state(
                    p, ops.plain, seed, step), pos0.contiguous())
            if nburn2 > 0:
                state = self._on_shards(
                    shards, lambda ops, src, st, b: pt_advance(
                        st, ops.plain, b, nburn2, a, src),
                    state, torch.as_tensor(
                        betas_b, dtype=torch.float32, device=dev))
                state = reset_counters(state)
            ss = lnp_sum = None
            chain_blocks, lnp_blocks, done = [], [], 0

        # -- phase 3: production segments (one when not checkpointing; every
        # segment the same per-record transition, so segmenting never
        # changes the chain)
        K2 = betas_b.shape[1]
        betas_t = torch.as_tensor(betas_b, dtype=torch.float32, device=dev)
        if checkpoint is not None:
            from mbb_emcee_tpu_torch.checkpoint import (
                new_run_id, save_tier_checkpoint)
            meta = self._tier_ck_meta(spec, dict(
                expect, k2=K2, run_id=run_id or new_run_id(),
                mesh_token=self._mesh_token()))
        while done < nrec:
            seg = nrec - done if checkpoint is None else min(interval,
                                                              nrec - done)
            state, chain, lnpch, lnp_sum, ss = self._on_shards(
                shards, lambda ops, src, st, b, c: pt_segment(
                    st, ops.plain, b, seg, int(thin), a, src, c),
                state, betas_t, None if ss is None else (lnp_sum, ss))
            keep = (lambda t: t) if checkpoint is None else (
                lambda t: t.cpu().numpy())
            chain_blocks.append(keep(chain))
            lnp_blocks.append(keep(lnpch))
            done += seg
            if checkpoint is not None:
                save_tier_checkpoint(
                    checkpoint, "pt",
                    {"pos": state.pos.cpu().numpy(),
                     "lnp": state.lnp.cpu().numpy(),
                     "naccept": state.naccept.cpu().numpy(),
                     "nswap": state.nswap.cpu().numpy(),
                     "nswap_prop": state.nswap_prop.cpu().numpy(),
                     "nsteps": np.int64(state.nsteps),
                     "seed": np.uint64(state.seed),
                     "step": np.int64(state.step)},
                    chain_blocks, lnp_blocks, meta,
                    aux_arrays={"betas": betas_b, "ss_m": ss.m,
                                "ss_s1": ss.s1, "ss_s2": ss.s2,
                                "ss_n": np.float64(ss.n), "acc": lnp_sum})
                if verbose:
                    from mbb_emcee_tpu_torch.utils.log import enable_console
                    enable_console().info(
                        f"  PT checkpoint: {done}/{nrec} records x {S} "
                        f"sources -> {checkpoint}")

        self.chain_free = self._tier_chain(chain_blocks, dev)
        self.lnprobability = self._tier_chain(lnp_blocks, dev)
        self.acceptance_fraction = (
            state.naccept[:, 0, :].double().cpu().numpy()
            / max(state.nsteps, 1))                        # cold rung
        self.swap_fraction = (state.nswap.cpu().numpy()
                              / np.maximum(state.nswap_prop.cpu().numpy(),
                                           1))
        self.pt_betas = betas_b
        logz, logz_err = ss.logz()                         # (S,), (S,)
        ti, ti_err = thermodynamic_logz(betas_b, lnp_sum / done)
        self.logz_pt = (logz, logz_err)
        self.logz_ti = (ti, ti_err)
        self._engine_record_nonextendable("pt")
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            af = self.acceptance_fraction
            enable_console().info(
                f"PT on {dev} over {S} sources: {K2} rungs x {W} walkers, "
                f"mean cold acceptance {af.mean():.3f}, min adjacent swap "
                f"fraction {self.swap_fraction.min():.2f}, lnZ in "
                f"[{logz.min():.2f}, {logz.max():.2f}] (median err "
                f"{np.median(logz_err):.3f})")
        return self

    def run_hmc(self, nwarmup=500, nsteps=1000, thin=1, n_leapfrog=16,
                target_accept=0.8, verbose=False, checkpoint=None,
                checkpoint_interval=100, resume=False):
        """Batched gradient-based sampling (hmc.py): every source runs W
        independent HMC chains, all (S, W) in lockstep -- the two-phase
        warmup (dual-averaged step size, diagonal mass) then leapfrog + MH
        production -- with forces from torch.autograd of the batch
        likelihood's plain version on the fitter's device (the JAX package
        takes jax.grad of its XLA likelihood). Each source adapts its OWN
        step size (self.hmc_step_size, (S,)) and diagonal metric
        (self.hmc_mass, (S, nfree)).

        With `checkpoint=path` PRODUCTION is segmented every
        `checkpoint_interval` records and the complete per-source state
        (positions, gradients, step sizes, metrics, accept counters, the
        Philox stream position) is flushed (checkpoint.save_tier_checkpoint);
        `resume=True` continues an interrupted run toward the same nsteps
        target, exactly the uninterrupted chain (production runs at fixed
        (eps, mass); a kill during warmup restarts warmup).

        The recorded chains have run()'s shapes; extend() does not apply."""
        from mbb_emcee_tpu_torch.hmc import (
            _HMCGraphs, _prod_core, _to_unconstrained, _warmup_core,
            check_box)

        self._tier_checks(nsteps, thin, resume, checkpoint)
        spec = self._effective_spec()
        shards = self._shard_operands(spec)
        free_space = shards[0].obj.free_space
        self.free_space = free_space
        self._run_spec = spec       # persisted by writeToHDF5
        check_box(free_space.lower, free_space.upper)
        self.thin = int(thin)
        thin_i = int(thin)
        S, W = self.nsources, self.nwalkers
        dev = self.device
        nrec = int(nsteps) // thin_i

        def box(device):
            return (torch.as_tensor(np.asarray(a, np.float32), device=device)
                    for a in (free_space.lower,
                              free_space.upper - free_space.lower))
        lower, width = box(dev)
        resuming = bool(checkpoint and resume and os.path.exists(checkpoint))
        interval = max(1, int(checkpoint_interval))
        # one captured transition per shard for the whole call: the warmup
        # and every production segment replay it
        graphs = _HMCGraphs()
        expect = {"nwarmup": int(nwarmup), "n_leapfrog": int(n_leapfrog),
                  "target_accept": float(target_accept)}
        names = ("u", "g", "lp", "raw", "nacc", "eps", "mass")
        run_id = None
        if resuming:
            st, _, chain_blocks, lnp_blocks, done, run_id = \
                self._tier_resume(checkpoint, "hmc", spec, expect, nrec,
                                  thin_i)
            u, g, lp, raw, nacc, eps, mass = (
                torch.as_tensor(st[n], device=dev) for n in names)
            seed, step = int(st["seed"]), int(st["step"])
        else:
            cen, sca = self._init_centers()
            idx = free_space.free_idx
            p0 = self._balls(torch.Generator().manual_seed(self.seed),
                             cen[:, idx], sca[:, idx])
            seed = philox_key(self.seed)
            u, g, lp, raw, eps, mass, step = self._on_shards(
                shards, lambda ops, src, u0: _warmup_core(
                    ops.plain, *box(src.device), u0, int(nwarmup),
                    int(n_leapfrog), float(target_accept), seed, 0, src,
                    graphs),
                _to_unconstrained(p0, lower, width))
            nacc = torch.zeros((S, W), dtype=torch.int32, device=dev)
            chain_blocks, lnp_blocks, done = [], [], 0

        if checkpoint is not None:
            from mbb_emcee_tpu_torch.checkpoint import (
                new_run_id, save_tier_checkpoint)
            meta = self._tier_ck_meta(spec, dict(
                expect, run_id=run_id or new_run_id(),
                mesh_token=self._mesh_token()))
        while done < nrec:
            seg = nrec - done if checkpoint is None else min(interval,
                                                              nrec - done)
            chain, lnpch, u, g, lp, raw, nacc, step = self._on_shards(
                shards, lambda ops, src, *st: _prod_core(
                    ops.plain, *box(src.device), *st, seg * thin_i, thin_i,
                    int(n_leapfrog), seed, step, src, graphs),
                u, g, lp, raw, nacc, eps, mass)
            keep = (lambda t: t) if checkpoint is None else (
                lambda t: t.cpu().numpy())
            chain_blocks.append(keep(chain))
            lnp_blocks.append(keep(lnpch))
            done += seg
            if checkpoint is not None:
                arrays = dict(zip(names, (t.cpu().numpy() for t in (
                    u, g, lp, raw, nacc, eps, mass))))
                arrays.update(seed=np.uint64(seed), step=np.int64(step))
                save_tier_checkpoint(checkpoint, "hmc", arrays,
                                     chain_blocks, lnp_blocks, meta)
                if verbose:
                    from mbb_emcee_tpu_torch.utils.log import enable_console
                    enable_console().info(
                        f"  HMC checkpoint: {done}/{nrec} records x {S} "
                        f"sources -> {checkpoint}")

        self.chain_free = self._tier_chain(chain_blocks, dev)
        self.lnprobability = self._tier_chain(lnp_blocks, dev)
        self.acceptance_fraction = (nacc.double().cpu().numpy()
                                    / (done * thin_i))          # (S, W)
        self.hmc_step_size = eps.double().cpu().numpy()
        self.hmc_mass = mass.double().cpu().numpy()
        self._hmc_mode = graphs.mode     # "graph": one captured transition
        self._engine_record_nonextendable("hmc")
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            af = self.acceptance_fraction
            enable_console().info(
                f"HMC on {dev} over {S} sources: {W} chains x "
                f"{done * thin_i} steps, mean acceptance {af.mean():.3f} "
                f"(per-source min {af.mean(1).min():.3f}), step sizes in "
                f"[{self.hmc_step_size.min():.4g}, "
                f"{self.hmc_step_size.max():.4g}]")
        return self

    # -- nested-sampling evidence ------------------------------------------------
    def compute_evidence(self, nlive=512, nbatch=32, nsteps=32,
                         max_iter=3000, tol=1e-4, seed=None, verbose=False):
        """Per-source Bayesian evidences ln Z for the whole batch
        (nested.make_nested_batch_runner): the S nested runs advance in
        lockstep, every constrained step one (S, nbatch) call of the batch
        likelihood's plain version on the fitter's device (the JAX package
        runs its XLA likelihood the same way), and each source freezes at
        its own termination. Same prior convention as the single fit:
        normalized uniform over the free box times the configured Gaussian
        priors; run it once per model variant over the same batch and
        difference the (S,) logz vectors for per-source Bayes factors.

        Needs data (set_data) but not a prior run(). Source s draws the
        Philox stream of source index s under philox_key(seed) (default:
        the fitter's seed). Returns a NestedBatchResult with the samples in
        the full parameter space; also stored as self.evidence."""
        from mbb_emcee_tpu_torch.nested import make_nested_batch_runner

        if self.flux is None:
            raise RuntimeError("no data; call set_data")
        spec = self._effective_spec()
        ops = self._lnprob_operands(spec)
        free_space = ops.free_space
        if not (np.all(np.isfinite(free_space.lower))
                and np.all(np.isfinite(free_space.upper))):
            raise ValueError("nested sampling requires finite box bounds")

        def bind(o):
            return lambda theta, *data: o.fn(theta, o.wave, *data)

        # with a mesh, each shard's likelihood on its device
        lnprob = (bind(ops) if self.mesh is None else
                  [bind(sh.obj) for sh in self._shard_operands(spec)])
        runner = make_nested_batch_runner(
            lnprob, free_space.lower, free_space.upper, nlive=nlive,
            nbatch=nbatch, nsteps=nsteps, max_iter=max_iter, tol=tol,
            device=self.device, mesh=self.mesh)
        res = runner(philox_key(self.seed if seed is None else int(seed)),
                     ops.data)
        res.samples = free_space.expand(res.samples)
        self.evidence = res
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            enable_console().info(
                f"nested sampling [{self.device}] over {self.nsources} "
                f"sources: lnZ in [{res.logz.min():.2f}, "
                f"{res.logz.max():.2f}], median err "
                f"{np.median(res.logz_err):.3f}, iterations "
                f"{res.n_iter.min()}-{res.n_iter.max()}")
        return res

    # -- MAP + Laplace triage ---------------------------------------------------
    def run_map(self, nstarts=8, n_adam=150, n_newton=12, adam_lr=0.1,
                verbose=False):
        """Batched MAP + Laplace quick fits (mapfit.py): S sources x
        `nstarts` starts, each a fixed-iteration Adam-then-damped-Newton
        optimizer, as one batched torch computation on the per-source
        plain likelihood on the fitter's device. Stores per source

            map_params   (S, npar) full-space MAP points
            map_lnprob   (S,)   posterior log-density at the mode
            map_cov      (S, nfree, nfree) Laplace covariance
            map_sigma    (S, nfree) sqrt(diag)
            map_interior (S,) bool: mode safely inside the box (False: the
                         Laplace error bars are not trustworthy; run the
                         MCMC for that source)
            map_grad_norm (S,)

        and returns self. map_cen(param) gives (S, 2) value +/- sigma."""
        from mbb_emcee_tpu_torch.mapfit import (
            map_fit, laplace_cov_host, interior_mask)
        if self.flux is None:
            raise RuntimeError("no data; call set_data")
        spec = self._effective_spec()
        shards = self._shard_operands(spec)
        free_space = shards[0].obj.free_space
        self.free_space = free_space
        # the spec THIS fit ran under: writeToHDF5 persists it
        self._run_spec = spec
        if not (np.all(np.isfinite(free_space.lower))
                and np.all(np.isfinite(free_space.upper))):
            raise ValueError(
                "MAP fitting requires finite box bounds on every free "
                "parameter (the defaults are finite)")
        idx = free_space.free_idx
        cen, sca = self._init_centers()
        x0 = self._balls(torch.Generator().manual_seed(self.seed),
                         cen[:, idx], sca[:, idx], int(nstarts))
        x_map, lnp_map, H, gn = self._on_shards(
            shards, lambda ops, _, x: map_fit(
                ops.plain, free_space.lower, free_space.upper, x, n_adam,
                n_newton, adam_lr), x0)
        self.map_params = free_space.expand(x_map)
        self.map_lnprob = lnp_map
        self.map_cov, h_ok = laplace_cov_host(H)
        self.map_sigma = np.sqrt(np.maximum(
            np.diagonal(self.map_cov, axis1=1, axis2=2), 0.0))
        # a non-finite Hessian is never trustworthy, whatever sigma says
        self.map_interior = h_ok & interior_mask(
            x_map, self.map_sigma, free_space.lower, free_space.upper)
        self.map_grad_norm = gn
        self._record_map(spec)
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            n_bad = int((~self.map_interior).sum())
            enable_console().info(
                f"MAP triage over {self.nsources} sources x {nstarts} "
                f"starts on {self.device}: lnprob in "
                f"[{self.map_lnprob.min():.1f}, {self.map_lnprob.max():.1f}]"
                f"; {n_bad} modes at the box edge (Laplace suspect -- run "
                f"the MCMC for those)")
        return self

    def map_importance(self, nsamples=512, seed=None, verbose=False):
        """Laplace importance sampling after run_map(): `nsamples` draws
        per source from each Laplace Gaussian, the true posterior evaluated
        in one batched call on the fitter's device, importance weights
        w = p/q with q in closed form from the standard-normal draws.
        Stores map_samples (S, N, nfree), map_logw (S, N) and map_ess (S,)
        and returns map_ess: ess/N near 1 says the posterior is
        Gaussian-like and map_par_cen's summaries hold; a small ess says
        run the MCMC for that source."""
        from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR
        if getattr(self, "map_params", None) is None:
            raise RuntimeError("run_map() has not been called")
        self._require_map_fresh("map_importance()")
        shards = self._shard_operands(self._effective_spec())
        free_space = shards[0].obj.free_space
        S = self.nsources
        d = free_space.nfree
        N = int(nsamples)
        # host fp64 proposal pieces: Cholesky factors and log-normalizers
        L = np.linalg.cholesky(self.map_cov)            # (S, d, d)
        logdet = np.sum(np.log(np.diagonal(L, axis1=1, axis2=2)), axis=1)
        mu = self.map_params[:, free_space.free_idx]    # (S, d)
        gen = torch.Generator().manual_seed(
            self.seed if seed is None else int(seed))
        eps = torch.randn((S, N, d), generator=gen, dtype=torch.float32)
        dev = self.device
        eps_d = eps.to(dev)
        # x = mu + L eps per draw, written out (no matmul: no TF32)
        Lt = torch.as_tensor(L.astype(np.float32), device=dev)
        x = (torch.as_tensor(mu.astype(np.float32), device=dev)[:, None, :]
             + torch.sum(eps_d[:, :, None, :] * Lt[:, None, :, :], dim=-1))
        lnp = self._on_shards(shards, lambda ops, _, xs: ops.plain(xs),
                              x).double().cpu().numpy()       # (S, N)
        lnq = (-0.5 * np.sum(eps.double().numpy() ** 2, axis=2)
               - logdet[:, None] - 0.5 * d * np.log(2.0 * np.pi))
        # Out-of-box draws sit at the finite floor, which absorbs lnq in
        # fp64: unmasked, an all-out-of-box source would get uniform
        # weights and a perfect ess = N. Mask them to -inf.
        logw = np.where(lnp > SUPPORT_FLOOR, lnp - lnq, -np.inf)
        mx = logw.max(axis=1, keepdims=True)
        any_in = np.isfinite(mx[:, 0])
        logw = np.where(any_in[:, None], logw - np.where(
            np.isfinite(mx), mx, 0.0), -np.inf)
        w = np.exp(logw)
        w_sum = w.sum(axis=1, keepdims=True)
        ess = np.where(
            any_in,
            (w_sum[:, 0] ** 2) / np.maximum((w * w).sum(axis=1), 1e-300),
            0.0)
        self.map_samples = x.double().cpu().numpy()
        self.map_logw = logw
        self.map_ess = ess
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            frac = ess / N
            enable_console().info(
                f"Laplace importance sampling: N={N}/source, ess/N median "
                f"{np.median(frac):.2f} (min {frac.min():.2f}); "
                f"{int((frac < 0.2).sum())} sources below 0.2 -- run the "
                f"MCMC for those")
        return ess

    def map_par_cen(self, param, percentile=68.3):
        """(S, 3) weighted (median, +err, -err) from the importance-refined
        Laplace posterior (map_importance first). Fixed parameters report
        zero errors; a source with no draw in the box reports its MAP
        point with NaN errors."""
        if getattr(self, "map_samples", None) is None:
            raise RuntimeError("map_importance() has not been called")
        i = self._param_index(param)
        free_idx = list(self.free_space.free_idx)
        if i not in free_idx:
            vals = self.map_params[:, i]
            return np.column_stack([vals, np.zeros_like(vals),
                                    np.zeros_like(vals)])
        col = self.map_samples[:, :, free_idx.index(i)]   # (S, N)
        w = np.exp(self.map_logw)
        p = float(percentile)
        qs = np.array([50.0 - p / 2, 50.0, 50.0 + p / 2]) / 100.0
        out = np.empty((self.nsources, 3))
        for s in range(self.nsources):
            order = np.argsort(col[s])
            cw = np.cumsum(w[s][order])
            if cw[-1] <= 0.0:
                out[s] = (self.map_params[s, i], np.nan, np.nan)
                continue
            cw /= cw[-1]
            lo, mid, hi = np.interp(qs, cw, col[s][order])
            out[s] = (mid, hi - mid, mid - lo)
        return out

    def map_cen(self, param):
        """(S, 2) MAP value +/- Laplace sigma for `param` (sigma = 0 for
        fixed parameters)."""
        if getattr(self, "map_params", None) is None:
            raise RuntimeError("run_map() has not been called")
        i = self._param_index(param)
        vals = self.map_params[:, i]
        free_idx = list(self.free_space.free_idx)
        sig = (self.map_sigma[:, free_idx.index(i)]
               if i in free_idx else np.zeros(self.nsources))
        return np.column_stack([vals, sig])

    # -- posterior-predictive QA + LOO ------------------------------------------
    def _detected(self, what):
        """(signed iunc (S, nb), detected mask (S, nb)): a source with no
        detected (non-missing, non-upper-limit) band is refused."""
        iunc = self._iunc_operand()          # signed: <0 uplim, 0 missing
        inc = iunc > 0
        if np.any(~inc.any(axis=1)):
            bad = int(np.argwhere(~inc.any(axis=1))[0, 0])
            raise RuntimeError(
                f"{what}: source {bad} has no detected (non-missing, "
                f"non-upper-limit) band")
        return iunc, inc

    def _sample_chunk(self, nb_inner):
        """Samples per pass of a (S, chunk, ...) computation whose
        per-sample fan-out is `nb_inner` (about 64M elements each)."""
        return max(1, (64 << 20) // max(self.nsources * nb_inner, 1))

    def posterior_predictive(self, thin=1, seed=0):
        """Batched posterior-predictive goodness of fit over the catalog.

        For every source s and thinned chain sample t, the whitened
        chi-square of the observed photometry T_obs is compared with that
        of photometry replicated from the fitted error model, T_rep =
        |eps|^2, all (S x nsamples) pairs batched on the chain's device.
        Missing bands and upper-limit slots are excluded from the
        statistic and the replication (band_p NaN there); with a band
        correlation the per-source whitening is the exact marginal over
        each source's observed bands, and replication draws through its
        inverse. The normal draws come from a torch.Generator on the
        chain's device seeded with `seed`. Returns a PPCBatchResult."""
        from mbb_emcee_tpu_torch.multifit import PPCBatchResult
        self._require_run()
        iunc, inc = self._detected("posterior_predictive")
        S, nb = inc.shape
        ndata = inc.sum(axis=1).astype(np.int64)
        dev = self.chain_free.device
        y_h = np.where(inc, np.nan_to_num(self.flux), 0.0)

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        y = t32(y_h)[:, None, :]
        y64 = torch.as_tensor(y_h, device=dev)[:, None, :]
        mask = t32(inc)[:, None, :]
        flux_shards = self._shards(lambda v: v._band_flux_eval())
        if self._band_corr is None:
            a = t32(np.where(inc, iunc, 0.0))[:, None, :]
            with np.errstate(divide="ignore"):
                b = t32(np.where(inc, 1.0 / np.where(inc, iunc, 1.0),
                                 0.0))[:, None, :]

            def whiten(r):
                return r * a

            def color(e):
                return b * e
        else:
            # the exact marginal whitening (zero rows/cols at missing
            # slots) and its inverse on the observed block, host fp64
            W = self._whiten_operand()
            Lm = np.zeros_like(W)
            for s in range(S):
                p = inc[s]
                Lm[s][np.ix_(p, p)] = np.linalg.inv(W[s][np.ix_(p, p)])
            Wt, Lt = t32(W)[:, None], t32(Lm)[:, None]

            def whiten(r):
                return torch.sum(Wt * (r * mask)[:, :, None, :], dim=-1)

            def color(e):
                return torch.sum(Lt * e[:, :, None, :], dim=-1)

        samples = self._thinned(thin)
        N = int(samples.shape[1])
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        pack = self._response_pack()
        inner = nb * (pack[0].shape[1] if pack is not None else 1)
        if self._band_corr is not None:
            inner = max(inner, nb * nb)
        chunk = self._sample_chunk(inner)
        co, cr = [], []
        above = torch.zeros((S, nb), dtype=torch.int64, device=dev)
        for i in range(0, N, chunk):
            m = self._on_shards(flux_shards, lambda f, _, th: f(th),
                                samples[:, i:i + chunk])  # (S, c, nb)
            d = whiten(m - y)
            eps = torch.randn(m.shape, generator=gen, device=dev) * mask
            co.append(torch.sum(d * d, dim=-1))
            cr.append(torch.sum(eps * eps, dim=-1))
            above += torch.sum((m + color(eps)).double() >= y64, dim=1)
        chi2_obs = torch.cat(co, dim=1).double().cpu().numpy()
        chi2_rep = torch.cat(cr, dim=1).double().cpu().numpy()
        band_p = np.where(inc, above.cpu().numpy() / N, np.nan)
        return PPCBatchResult(
            p_value=np.mean(chi2_rep >= chi2_obs, axis=1),
            band_p=band_p, chi2_obs=chi2_obs, chi2_rep=chi2_rep,
            ndata=ndata, nfree=self.free_space.nfree, nsamples=N,
            excluded=~inc)

    def compute_loo(self, thin=1):
        """Batched WAIC + PSIS-LOO over the catalog (modelcheck.py): the
        (S x nsamples x nb) pointwise log-likelihood is computed in
        sample-axis chunks on the chain's device; the PSIS tail smoothing
        runs host-side in fp64 per source and band. Missing bands and
        upper limits are excluded (NaN in the pointwise arrays); with a
        band correlation the pointwise factors are the exact conditional
        predictive densities p(y_i | y_-i, theta) through each source's
        marginal precision. Returns (and stores as .loo_result) a
        modelcheck.LooBatchResult."""
        from mbb_emcee_tpu_torch import modelcheck
        self._require_run()
        iunc, inc = self._detected("compute_loo")
        S, nb = inc.shape
        dev = self.chain_free.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        y = t32(np.where(inc, np.nan_to_num(self.flux), 0.0))[:, None, :]
        if self._band_corr is None:
            lam_diag = np.where(inc, iunc, np.nan) ** 2      # 1/sigma^2
            per_source = (y, t32(np.where(inc, iunc, 0.0))[:, None, :])

            def one(fluxes, th, y, op):
                d = (fluxes(th) - y) * op
                return -0.5 * d * d
            inner = nb
        else:
            # Lambda_s = W_s^T W_s (exact marginal precision; zero rows and
            # columns at missing slots), fp64 host like the whitener
            W = self._whiten_operand()
            lam_diag = np.where(inc, np.einsum("skb,skb->sb", W, W), np.nan)
            idg = t32(np.where(inc, 1.0 / np.where(inc, lam_diag, 1.0),
                               0.0))[:, None, :]
            per_source = (y, t32(W)[:, None], idg)       # Wt (S, 1, k, b)

            def one(fluxes, th, y, Wt, idg):
                d = fluxes(th) - y                       # (S, c, b)
                r = torch.sum(Wt * d[:, :, None, :], dim=-1)       # W d
                g = torch.sum(Wt * r[:, :, :, None], dim=-2)       # W^T r
                return -0.5 * g * g * idg
            inner = nb * nb
        pack = self._response_pack()
        inner = max(inner, nb * (pack[0].shape[1] if pack is not None
                                 else 1))
        flux_shards = self._shards(lambda v: v._band_flux_eval())
        q = derived._chunked_samples(
            lambda th: self._on_shards(flux_shards, lambda f, _, *a: one(
                f, *a), th, *per_source), self._thinned(thin), inner)
        with np.errstate(invalid="ignore"):
            lnnorm = 0.5 * (np.log(lam_diag) - np.log(2.0 * np.pi))
        self.loo_result = modelcheck.loo_batch_from_loglik(
            q + lnnorm[:, None, :], inc)
        return self.loo_result
