"""K3: the stretch-move runs of many sources as one hand-written CUDA kernel
launch, and the batch tier's sampler around it.

Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_multifit.py
::_make_multi_kernel (:203-343; lnprob _make_multi_lnp :69-166), which
FusedMultiPallasSampler._make_run (:597-720) launches. The CUDA source is
csrc/multifit.cu (its header notes what bounds it and how it is laid out):
the single-ensemble run loop of csrc/stretch.cuh on the shared per-walker
lnprob of csrc/lnprob.cuh, once per source, on a layout that
`plan_multi_launch` picks per mode and per catalog size (G lanes per walker
in one block per source, or a thread-block cluster of C blocks per source).

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
    H100_SMEM_OPTIN, H100_SMS, current_stream_handle, device_sm_count,
    pack_constants, plan_mode, response_nodes, smem_optin_bytes)
from mbb_emcee_tpu_torch.ops.sampler_kernel import (
    ERR_CLUSTER_UNPLACEABLE, MAX_WALKERS, check_plan, check_run_smem,
    max_threads, stretch_plan)
from mbb_emcee_tpu_torch.sampler import (
    MultiEnsembleSampler, MultiSamplerState, _check_run_args,
    multi_stretch_run_plain)
from mbb_emcee_tpu_torch.utils.profiling import count, note, span

# K3's layouts (csrc/multifit.cu): G lanes per walker in one block per
# source, or in a thread-block cluster of C blocks per source.
MULTI_GROUPS = (1, 4)
MULTI_CLUSTER_GROUPS = (8, 16, 32)
# (lanes per walker, in a cluster) -> the most threads a block of it takes
# (the kernels' launch bounds, K2's per group).
MULTI_LAYOUTS = {
    **{(g, False): max_threads(g) for g in MULTI_GROUPS},
    **{(g, True): max_threads(g) for g in MULTI_CLUSTER_GROUPS}}
# Blocks per SM a layout's launch bounds keep registers for (1 if not
# listed): G = 4 is bounded to 64 registers so two blocks of 512 threads
# share an SM.
MULTI_MIN_BLOCKS = {(4, False): 2}
# Per mode (ops/sampler_kernel.py plan_mode), K3's layouts (G, C) in order
# of preference; each is taken only where the whole catalog runs at once
# (one wave, a cluster's blocks each on an SM of its own), one thread per
# walker for any catalog. Chosen from chip_smoke.py's K3 sweep at 4-1024
# sources (PERF.md): K2's clusters while the card places every source's C
# blocks on C SMs, the largest cluster first (on an H100 up to 15 sources
# on 8 SMs, 30 on 4, 66 on 2); lanes per walker in one block repeat each
# walker's serial work on every lane, so they pay only where the band
# items are many (response mode: G = 4 at 256 sources 0.75 of one thread
# per walker; in point mode it ran 1.53x there); point mode gains under 3%
# from 2-block clusters (within two calls' spread), and the thin model with
# alpha fixed nothing from any layout.
MULTI_PLAN_TABLE = {
    "point": ((8, 8), (8, 4), (1, 1)),
    "point_noalpha_thick": ((8, 8), (8, 4), (1, 1)),
    "point_noalpha_thin": ((1, 1),),
    "response": ((32, 8), (16, 4), (8, 2), (4, 1), (1, 1)),
}
# The H100 SXM's per-SM limits (compute capability 9.0), beside
# ops/lnprob_kernel.py's H100_SMS: the planner's model of what the card
# runs at once, off the card. Each block reserves 1 KB of the SM's 228 KB
# of shared memory.
H100_SM_THREADS, H100_SM_BLOCKS, H100_SM_REGISTERS = 2048, 32, 65536
H100_SM_SMEM, H100_BLOCK_SMEM_RESERVED = 233472, 1024


def h100_resident(plan, sm_count=H100_SMS):
    """How many sources of `plan` an H100 of `sm_count` SMs runs at once:
    for a cluster of C blocks each on an SM of its own, sm_count // C (an
    upper bound: the card's GPCs may split fewer groups of C SMs off); for
    one block per source, CUDA's occupancy rules (threads, blocks,
    registers at the layout's launch bounds, 65,536 over its threads times
    MULTI_MIN_BLOCKS, and shared memory per SM) times sm_count. The
    planner's stand-in off the card for mbb_multi_resident."""
    if plan.cluster > 1:
        return sm_count // plan.cluster
    layout = (plan.group, False)
    regs = H100_SM_REGISTERS // (MULTI_LAYOUTS[layout]
                                 * MULTI_MIN_BLOCKS.get(layout, 1))
    per_sm = min(H100_SM_THREADS // plan.threads, H100_SM_BLOCKS,
                 H100_SM_REGISTERS // (regs * plan.threads),
                 H100_SM_SMEM // (plan.smem_bytes + H100_BLOCK_SMEM_RESERVED))
    return sm_count * per_sm


def plan_multi_launch(nb, nnodes, half, nsources, noalpha=False,
                      opthin=False, sm_count=H100_SMS,
                      smem_limit=H100_SMEM_OPTIN, resident=None):
    """K3's layout for `nsources` sources of 2 * half walkers on nb bands x
    nnodes nodes, a model with (noalpha=False) or without the Wien merge
    solve, thick or optically thin, on a card of `sm_count` SMs: the first
    of MULTI_PLAN_TABLE's layouts for the mode (swept at 250 walkers) whose
    block fits (MULTI_LAYOUTS' threads, `smem_limit` bytes) and whose whole
    catalog runs at once, `resident(plan)` >= nsources. A cluster's lanes
    per walker are halved down to 8 while it does not fit. One thread per
    walker otherwise. `resident` is how many sources of a plan the card
    runs at once, a cluster's blocks each on its own SM (card_resident on
    the card; h100_resident's model by default)."""
    if resident is None:
        def resident(plan):
            return h100_resident(plan, sm_count)
    for group, cluster in MULTI_PLAN_TABLE[plan_mode(nnodes, noalpha,
                                                     opthin)]:
        groups = [g for g in MULTI_CLUSTER_GROUPS[::-1] if g <= group] \
            if cluster > 1 else [group]
        for g in groups:
            plan = stretch_plan(g, cluster, nb, nnodes, half)
            if plan.threads <= MULTI_LAYOUTS[(g, cluster > 1)] \
                    and plan.smem_bytes <= smem_limit \
                    and ((g, cluster) == (1, 1)
                         or resident(plan) >= nsources):
                return plan
    return stretch_plan(1, 1, nb, nnodes, half)


def card_resident(device, nb, nnodes, half):
    """plan_multi_launch's `resident` from CUDA device `device` itself: the
    library's mbb_multi_resident (CUDA's occupancy calculator on the kernel
    as built: a cluster plan's clusters with a block per SM, or the plan's
    blocks with its shared memory for nb bands x nnodes nodes and 2 * half
    walkers)."""
    lib = build_kernels()

    def resident(plan):
        with torch.cuda.device(device):
            n = lib.mbb_multi_resident(nb, nnodes, half, plan.group,
                                       plan.cluster, plan.walkers_per_block,
                                       plan.threads)
        if n < 0:
            raise RuntimeError(f"mbb_multi_resident failed: CUDA error {-n}"
                               f" ({plan})")
        return n
    return resident


def plan_multi_on_card(nb, nnodes, half, nsources, noalpha, opthin, device):
    """plan_multi_launch for CUDA device `device` (an index or a
    torch.device): its SMs, its shared-memory limit per block and its own
    residency counts."""
    device = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return plan_multi_launch(nb, nnodes, half, nsources, noalpha, opthin,
                             device_sm_count(index), smem_optin_bytes(index),
                             card_resident(index, nb, nnodes, half))


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

    @property
    def data(self):
        """The per-source operands the plain function takes after wave."""
        return (self.flux, self.errs)

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
                         whiten=None, device=None) -> MultiOperands:
    """Pack a batch likelihood (shared wavelengths (nb,), per-source
    flux/unc (S, nb) with NaN/inf marking missing bands, model shape, spec
    with an optional (nb,) or (S, nb) upper-limit mask, optional response
    pack, optional per-source whitening (S, nb, nb)) into kernel operands
    on `device`, with the plain version's function beside them. `device`
    None is the card, as in build_lnprob."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
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
                          nrec, thin, a=2.0, uniforms=None, plan=None,
                          source0=0):
    """`nrec` records of `thin` stretch-move steps for every source from
    `state` under the batch likelihood in `ops`. `uniforms`
    (S, nrec, 6 * thin, half) fp32 replaces the per-source Philox streams
    keyed by state.seed at state.step; source s draws the stream of global
    source source0 + s (a shard of a catalog passes its first source's
    index). `plan` (a StretchPlan of one of
    MULTI_LAYOUTS) sets the kernel's layout; None takes plan_multi_on_card's
    for the card (the plain version on the CPU has none, but a bad plan is
    refused on every device). Returns (state, chain
    (S, nrec, nwalkers, nfree), lnpchain (S, nrec, nwalkers)).

    Under the profiler its span records the bands and the nodes a band
    (the pack's padded count, 1 for point bands), on the card also the
    `group` and `cluster` of the layout it launched, and counts
    `sed_evals`: steps x walkers x bands x nodes x sources."""
    nsrc, nw = int(state.pos.shape[0]), int(state.pos.shape[1])
    nb, nodes = int(ops.icfg[3]), int(ops.icfg[4])
    with span("mbb.kernel.k3", steps=nrec * thin, records=nrec,
              sources=nsrc, bands=nb, nodes=nodes):
        count("sed_evals", nrec * thin * nw * nb * nodes * nsrc)
        return _mbb_multi_stretch_run(state, ops, nrec, thin, a, uniforms,
                                      plan, source0)


def _mbb_multi_stretch_run(state: MultiSamplerState, ops: MultiOperands,
                           nrec, thin, a=2.0, uniforms=None, plan=None,
                           source0=0):
    device = state.pos.device
    if device != ops.device:
        raise ValueError(f"state on {device}, likelihood operands on "
                         f"{ops.device}")
    nsrc, nw, nfree = state.pos.shape
    half = nw // 2
    nb, nnodes = int(ops.icfg[3]), int(ops.icfg[4])
    if plan is not None:
        check_plan(plan, nb, nnodes, half, MULTI_LAYOUTS)
    if device.type == "cpu":
        return multi_stretch_run_plain(state, ops.plain, nrec, thin, a,
                                       uniforms, source0)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
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
    if plan is None:
        plan = plan_multi_on_card(nb, nnodes, half, nsrc, bool(ops.icfg[1]),
                                  bool(ops.icfg[0]), device)
    check_run_smem(ops.icfg, half, plan.threads, device,
                   "the multi-source stretch-move kernel")
    note(group=plan.group, cluster=plan.cluster)
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
            lnp_out.data_ptr(), nacc_out.data_ptr(), nsrc, half, plan.group,
            plan.cluster, plan.walkers_per_block, plan.threads, nrec, thin,
            float(a), state.seed & (2 ** 64 - 1), state.step, int(source0),
            ops.icfg.ctypes.data, ops.fcfg.ctypes.data,
            current_stream_handle(device))
    if rc == ERR_CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"mbb_multi_stretch_run: the card cannot place a "
                           f"cluster of {plan.cluster} blocks x "
                           f"{plan.threads} threads ({plan})")
    if rc != 0:
        raise RuntimeError(f"mbb_multi_stretch_run kernel launch failed: "
                           f"CUDA error {rc} ({plan})")
    mbb_multi_stretch_run.launches += 1
    new_state = MultiSamplerState(
        pos=pos_out, lnp=lnp_out, naccept=nacc_out,
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


mbb_multi_stretch_run.launches = 0


class FusedMultiSampler(MultiEnsembleSampler):
    """Batched stretch-move sampler over S independent sources sharing the
    model shape, spec and band geometry, each run one launch of the
    multi-source kernel (the likelihood is compiled into it; the per-source
    data are runtime operands, replaced by set_data).

    rng="hw" draws the proposals from the per-source Philox streams, source
    s on the stream of global source source0 + s;
    rng="external" takes them from a `uniforms` argument (replay tests).
    The batch tier's sampler_backend="torch" is sampler.MultiEnsembleSampler
    over the same operands' plain version."""

    def __init__(self, nwalkers, wave, flux, unc, shape, spec,
                 response_pack=None, a=2.0, rng="hw", whiten=None,
                 device="cuda", source0=0):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if rng not in ("hw", "external"):
            raise ValueError("rng must be 'hw' or 'external'")
        if nwalkers > MAX_WALKERS:
            raise ValueError(f"at most {MAX_WALKERS} walkers per ensemble")
        self.rng = rng
        self.ops = prepare_multi_inputs(wave, flux, unc, shape, spec,
                                        response_pack, whiten, device)
        super().__init__(self.ops.nsources, nwalkers,
                         self.ops.free_space.nfree, self.ops.plain, a,
                         self.ops.free_space, source0)

    def set_data(self, flux, unc, uplim_bands=None, whiten=None):
        """Replace the per-source photometry (same S and band count) with
        the new batch's upper-limit mask ((nb,), (S, nb) or None) or, for a
        sampler built with correlated errors, its whiten= matrices. Nothing
        is rebuilt."""
        self.ops.set_data(flux, unc, uplim_bands, whiten)
        return self

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
        return mbb_multi_stretch_run(state, self.ops, nsteps // thin, thin,
                                     self.a, uniforms, source0=self.source0)
