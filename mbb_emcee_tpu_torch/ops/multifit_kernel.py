"""K3: the stretch-move runs of many sources as one hand-written CUDA kernel
launch, and the batch tier's sampler around it.

Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_multifit.py
::_make_multi_kernel (:203-343; lnprob _make_multi_lnp :69-166), which
FusedMultiPallasSampler._make_run (:597-720) launches. The CUDA source is
csrc/multifit.cu (its header notes what bounds it and how it is laid out):
one thread block per source running the single-ensemble run loop of
csrc/stretch.cuh on the shared per-walker lnprob of csrc/lnprob.cuh.

The plain PyTorch version is sampler.multi_stretch_run_plain over
likelihood.build_lnprob_data, with the same uniform layout and the same
per-source Philox streams. `mbb_multi_stretch_run` runs the plain version
for a state on the CPU, and for a CUDA state launches the kernel or raises;
`mbb_multi_stretch_run.launches` counts kernel launches. `FusedMultiSampler`
is the sampler surface around it (the counterpart of
pallas_multifit.py:346-771).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mbb_emcee_tpu_torch.likelihood import (
    FreeSpace, build_lnprob_data, signed_iunc)
from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
    current_stream_handle, pack_constants, response_nodes)
from mbb_emcee_tpu_torch.ops.sampler_kernel import (
    MAX_WALKERS, check_run_smem)
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, MultiSamplerState, _check_run_args,
    multi_stretch_run_plain)


def _sanitize_missing_flux(flux, unc):
    """Zero the flux at missing bands (non-finite unc -> weight 0 via
    signed_iunc) BEFORE it reaches the kernel: NaN * 0 is NaN, so an
    unsanitized NaN flux poisons chi2 and silently freezes that source's
    chain (accept = log u < NaN is always False). A non-finite flux at a
    WEIGHTED band is a data error -- raise."""
    finite_w = np.isfinite(unc)
    bad = finite_w & ~np.isfinite(flux)
    if bad.any():
        s, b = np.argwhere(bad)[0]
        raise ValueError(
            f"non-finite flux at a weighted band (source {s}, band {b}); "
            "mark missing bands by setting unc to NaN/inf")
    return np.where(finite_w, flux, 0.0)


def _refuse_uplim_with_whiten(uplim_bands):
    if uplim_bands is not None and np.asarray(uplim_bands).any():
        raise ValueError(
            "photometric upper limits do not compose with correlated "
            "band errors (whiten=)")


def _data_operands(flux, unc, uplim_bands, whiten):
    """Host fp64 (flux (S, nb) with missing bands zeroed, error operand):
    signed 1/sigma (S, nb), or the whitening matrices (S, nb, nb)."""
    flux = np.atleast_2d(np.asarray(flux, np.float64))
    unc = np.atleast_2d(np.asarray(unc, np.float64))
    if unc.shape != flux.shape or flux.ndim != 2:
        raise ValueError("flux/unc must be (S, nbands)")
    flux = _sanitize_missing_flux(flux, unc)
    if whiten is None:
        return flux, signed_iunc(unc, uplim_bands)
    _refuse_uplim_with_whiten(uplim_bands)
    nsrc, nb = flux.shape
    return flux, np.asarray(whiten, np.float64).reshape(nsrc, nb, nb)


@dataclasses.dataclass
class MultiOperands:
    """Everything the multi-source kernel needs on one device: the shared
    packed constants and configuration (as for K1/K2, with the flux and
    whitening slots zero), the per-source fluxes (S, nb) and error operand
    (signed 1/sigma (S, nb), or whitening (S, nb, nb) when `correlated`),
    and the plain version's function of build_lnprob_data."""
    consts: torch.Tensor
    icfg: np.ndarray
    fcfg: np.ndarray
    wave: torch.Tensor
    flux: torch.Tensor
    errs: torch.Tensor
    correlated: bool
    free_space: FreeSpace
    fn: Callable

    @property
    def nfree(self):
        return self.free_space.nfree

    @property
    def nsources(self):
        return self.flux.shape[0]

    @property
    def device(self):
        return self.consts.device

    def plain(self, theta_free):
        """The plain batched lnprob (S, n, nfree) -> (S, n) on this data."""
        return self.fn(theta_free, self.wave, self.flux, self.errs)

    def set_data(self, flux, unc, uplim_bands, whiten):
        """Replace the per-source fluxes and error operands (same S, nb and
        error model)."""
        if (whiten is not None) != self.correlated:
            raise ValueError(
                "the error model (diagonal, or correlated with whiten=) is "
                "fixed when the sampler is built; rebuild it to switch")
        flux, errs = _data_operands(flux, unc, uplim_bands, whiten)
        if flux.shape != tuple(self.flux.shape):
            raise ValueError(f"flux/unc must be {tuple(self.flux.shape)}")
        self.flux, self.errs = (_f32(a, self.device) for a in (flux, errs))


def _f32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                           device=device)


def prepare_multi_inputs(wave, flux, unc, shape, spec, response_pack=None,
                         whiten=None, device="cpu") -> MultiOperands:
    """Pack a batch likelihood (shared wavelengths (nb,), per-source
    flux/unc (S, nb) with NaN/inf marking missing bands, model shape, spec
    with an optional (nb,) or (S, nb) upper-limit mask, optional response
    pack, optional per-source whitening (S, nb, nb)) into kernel operands
    on `device`, with the plain version's function beside them."""
    correlated = whiten is not None
    wave = np.atleast_1d(np.asarray(wave, np.float64))
    nb = wave.size
    flux, errs = _data_operands(flux, unc, spec.uplim_bands, whiten)
    if flux.shape[1] != nb:
        raise ValueError(f"flux/unc must be (S, {nb})")
    fn, free_space = build_lnprob_data(shape, spec, response_pack,
                                       correlated=correlated, device=device)
    # The mask and the data ride the per-source operands: the shared
    # constants carry zero flux and whitening slots and no mask.
    consts, icfg, fcfg = pack_constants(
        shape, dataclasses.replace(spec, uplim_bands=None), free_space,
        np.zeros(nb), np.zeros((nb, nb)),
        response_nodes(wave, response_pack, device), correlated, device)
    return MultiOperands(
        consts=consts, icfg=icfg, fcfg=fcfg, wave=_f32(wave, device),
        flux=_f32(flux, device), errs=_f32(errs, device),
        correlated=correlated, free_space=free_space, fn=fn)


def mbb_multi_stretch_run(state: MultiSamplerState, ops: MultiOperands,
                          nrec, thin, a=2.0, uniforms=None):
    """`nrec` records of `thin` stretch-move steps for every source from
    `state` under the batch likelihood in `ops`. `uniforms`
    (S, nrec, 6 * thin, half) fp32 replaces the per-source Philox streams
    keyed by state.seed at state.step. Returns (state,
    chain (S, nrec, nwalkers, nfree), lnpchain (S, nrec, nwalkers))."""
    device = state.pos.device
    if device != ops.device:
        raise ValueError(f"state on {device}, likelihood operands on "
                         f"{ops.device}")
    if device.type == "cpu":
        return multi_stretch_run_plain(state, ops.plain, nrec, thin, a,
                                       uniforms)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    nsrc, nw, nfree = state.pos.shape
    half = nw // 2
    if nsrc != ops.nsources or nfree != ops.nfree or nw % 2:
        raise ValueError(
            f"state positions {tuple(state.pos.shape)} do not match the "
            f"likelihood's {ops.nsources} sources x {ops.nfree} free "
            f"parameters (and an even walker count)")
    if nw > MAX_WALKERS:
        raise ValueError(f"at most {MAX_WALKERS} walkers per ensemble")
    if uniforms is not None:
        if uniforms.device != device or uniforms.dtype != torch.float32 \
                or tuple(uniforms.shape) != (nsrc, nrec, 6 * thin, half) \
                or not uniforms.is_contiguous():
            raise ValueError(
                f"uniforms must be a contiguous float32 "
                f"({nsrc}, {nrec}, {6 * thin}, {half}) tensor on {device}")
    check_run_smem(ops.icfg, half, -(-half // 32) * 32, device,
                   "the multi-source stretch-move kernel")
    pos = state.pos.to(torch.float32).contiguous()
    nacc = state.naccept.to(torch.int32).contiguous()
    lib = build_kernels()
    chain = torch.empty((nsrc, nrec, nw, nfree), dtype=torch.float32,
                        device=device)
    lnpchain = torch.empty((nsrc, nrec, nw), dtype=torch.float32,
                           device=device)
    pos_out = torch.empty((nsrc, nw, nfree), dtype=torch.float32,
                          device=device)
    lnp_out = torch.empty((nsrc, nw), dtype=torch.float32, device=device)
    nacc_out = torch.empty((nsrc, nw), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.mbb_multi_stretch_launch(
            pos.data_ptr(), nacc.data_ptr(), ops.consts.data_ptr(),
            ops.flux.data_ptr(), ops.errs.data_ptr(),
            0 if uniforms is None else uniforms.data_ptr(),
            chain.data_ptr(), lnpchain.data_ptr(), pos_out.data_ptr(),
            lnp_out.data_ptr(), nacc_out.data_ptr(), nsrc, half, nrec, thin,
            float(a), state.seed & (2 ** 64 - 1), state.step,
            ops.icfg.ctypes.data, ops.fcfg.ctypes.data,
            current_stream_handle(device))
    if rc != 0:
        raise RuntimeError(f"mbb_multi_stretch_run kernel launch failed: "
                           f"CUDA error {rc}")
    mbb_multi_stretch_run.launches += 1
    new_state = MultiSamplerState(
        pos=pos_out, lnp=lnp_out, naccept=nacc_out,
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


mbb_multi_stretch_run.launches = 0


class FusedMultiSampler:
    """Batched stretch-move sampler over S independent sources sharing the
    model shape, spec and band geometry, each run one launch of the
    multi-source kernel (the likelihood is compiled into it; the per-source
    data are runtime operands, replaced by set_data).

    rng="hw" draws the proposals from the per-source Philox streams;
    rng="external" takes them from a `uniforms` argument (replay tests).
    plain=True runs the plain multi run instead on any device (the batch
    tier's sampler_backend="torch")."""

    def __init__(self, nwalkers, wave, flux, unc, shape, spec,
                 response_pack=None, a=2.0, rng="hw", whiten=None,
                 device="cuda", plain=False):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if rng not in ("hw", "external"):
            raise ValueError("rng must be 'hw' or 'external'")
        if nwalkers > MAX_WALKERS:
            raise ValueError(f"at most {MAX_WALKERS} walkers per ensemble")
        self.nwalkers = int(nwalkers)
        self.a = float(a)
        self.rng = rng
        self.plain = bool(plain)
        self.ops = prepare_multi_inputs(wave, flux, unc, shape, spec,
                                        response_pack, whiten, device)
        self.free_space = self.ops.free_space
        self.ndim = self.free_space.nfree
        self.nsources = self.ops.nsources
        if nwalkers < 2 * self.ndim:
            raise ValueError(f"nwalkers={nwalkers} < 2*ndim={2 * self.ndim}")
        self.half = self.nwalkers // 2

    def set_data(self, flux, unc, uplim_bands=None, whiten=None):
        """Replace the per-source photometry (same S and band count) with
        the new batch's upper-limit mask ((nb,), (S, nb) or None) or, for a
        sampler built with correlated errors, its whiten= matrices. Nothing
        is rebuilt."""
        self.ops.set_data(flux, unc, uplim_bands, whiten)
        return self

    def init_state(self, p0, seed, step=0) -> MultiSamplerState:
        """p0: (S, nwalkers, ndim) on the sampler's device. lnprob is
        recomputed at the start of every run, so it starts as zeros."""
        p0 = p0.to(torch.float32).contiguous()
        want = (self.nsources, self.nwalkers, self.ndim)
        if tuple(p0.shape) != want:
            raise ValueError(f"p0 shape {tuple(p0.shape)} != {want}")
        return MultiSamplerState(
            pos=p0, lnp=torch.zeros(want[:2], device=p0.device),
            naccept=torch.zeros(want[:2], dtype=torch.int32,
                                device=p0.device),
            nsteps=0, seed=int(seed), step=int(step))

    # Both act on any state with naccept/nsteps: here (S, nwalkers).
    reset_counters = staticmethod(EnsembleSampler.reset_counters)
    acceptance_fraction = staticmethod(EnsembleSampler.acceptance_fraction)

    def run_mcmc(self, state: MultiSamplerState, nsteps, thin=1,
                 uniforms=None):
        """Advance every source `nsteps` updates in one launch, recording
        every `thin`-th. `uniforms` only in rng='external' mode:
        (S, nsteps // thin, 6 * thin, nwalkers // 2)."""
        _check_run_args(nsteps, thin)
        if uniforms is not None and self.rng != "external":
            raise ValueError(
                "uniforms= requires rng='external'; the Philox sampler "
                "would silently ignore the provided stream")
        if uniforms is None and self.rng == "external":
            raise ValueError("rng='external' requires a uniforms array")
        if self.plain:
            return multi_stretch_run_plain(state, self.ops.plain,
                                           nsteps // thin, thin, self.a,
                                           uniforms)
        return mbb_multi_stretch_run(state, self.ops, nsteps // thin, thin,
                                     self.a, uniforms)

    def advance(self, state: MultiSamplerState, nsteps, uniforms=None):
        """Advance without keeping the chain (burn-in)."""
        state, _, _ = self.run_mcmc(state, nsteps, thin=nsteps,
                                    uniforms=uniforms)
        return state
