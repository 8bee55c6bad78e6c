"""K1: the batched lnprob as a hand-written CUDA kernel, and its wrapper.

Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py::_make_kernel
(:248; body _make_lnp_compute :136-245), which build_pallas_lnprob (:338)
launches. The CUDA source is csrc/lnprob.cu with the per-walker body in
csrc/lnprob.cuh, which the stretch-move kernel (csrc/sampler.cu) shares.
What bounds it is noted in csrc/lnprob.cuh, how it is laid out in
csrc/lnprob.cu.

The plain PyTorch version of this kernel is likelihood.build_lnprob's
batched function; `prepare_lnprob_inputs` builds it beside the packed kernel
operands. `mbb_lnprob` runs the plain version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises; `mbb_lnprob.launches`
counts kernel launches. `plan_lnprob_launch` picks the kernel's layout
(lanes per vector, threads per block, blocks) from the likelihood's mode
and the batch size.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import NPARAMS
from mbb_emcee_tpu_torch.likelihood import FreeSpace, build_lnprob
from mbb_emcee_tpu_torch.models.modified_blackbody import LOG_C2
from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.utils.profiling import count, span


# The lnprob kernel's layouts (csrc/lnprob.cu): lanes of one warp per vector,
# and the threads of a block.
LNPROB_GROUPS = (1, 4, 8, 16, 32)
LNPROB_MIN_THREADS, LNPROB_MAX_THREADS = 32, 256
# The H100 SXM's opt-in maximum of shared memory per block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin) and its streaming
# multiprocessors: the planners' defaults off the card.
H100_SMEM_OPTIN = 232448
H100_SMS = 132
# Per mode (plan_mode), the lanes per vector in order of preference. Lanes
# shorten a vector's chain and multiply the work its warps do, so each is
# taken only while the batch's lanes, n x G, stay within LNPROB_SM_LANES
# threads per SM (4 warps per scheduler, well inside one wave); then fewer
# lanes, then one thread per vector for any batch. And the threads of a
# block. Chosen from chip_smoke.py's K1 sweep at 250 to 1,048,576 vectors
# on an H100 (PERF.md): in point mode 8 lanes run 0.70-0.85 of one thread
# per vector up to 4,096 vectors, 4 lanes never beat both, and at 16,384
# one thread per vector is fastest; on a 5 x 65 response pack 32 lanes run
# 0.10 at 250 vectors, 16 lanes 0.19 at 4,096, 4-8 lanes 0.56-0.60 at
# 16,384, and from 62,500 one thread per vector wins.
LNPROB_PLAN_TABLE = {
    "point": (8, 1),
    "point_noalpha_thick": (8, 1),
    "point_noalpha_thin": (8, 1),
    "response": (32, 16, 8, 4, 1),
}
LNPROB_SM_LANES = 512
LNPROB_BLOCK_THREADS = 128


@dataclasses.dataclass(frozen=True)
class LnprobOperands:
    """Everything both kernels need for one likelihood, on one device:
    the packed constant buffer (layout in csrc/lnprob.cuh), the runtime
    configuration as host int32/fp32 arrays, and the plain version."""
    consts: torch.Tensor
    icfg: np.ndarray
    fcfg: np.ndarray
    free_space: FreeSpace
    plain: Callable

    @property
    def nfree(self):
        return self.free_space.nfree

    @property
    def device(self):
        return self.consts.device

    @functools.cached_property
    def launch_args(self):
        """(nb, nnodes, noalpha, opthin, device index, and the addresses of
        consts, icfg and fcfg): what every launch needs of these operands,
        read once (a CUDA device only)."""
        dev = self.consts.device
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return (int(self.icfg[3]), int(self.icfg[4]), bool(self.icfg[1]),
                bool(self.icfg[0]), index, self.consts.data_ptr(),
                self.icfg.ctypes.data, self.fcfg.ctypes.data)


@dataclasses.dataclass(frozen=True)
class LnprobPlan:
    """The lnprob kernel's layout: `group` lanes of one warp per vector,
    `blocks` blocks of `threads` threads (a tile of threads / group vectors
    each; fewer blocks than tiles loop over them, blocks apart), and
    `smem_bytes` of dynamic shared memory per block."""
    group: int
    threads: int
    blocks: int
    smem_bytes: int


def plan_smem_bytes(nb, nnodes, threads):
    """Dynamic shared memory of one lnprob block of `threads` threads:
    csrc/lnprob.cuh's mbb_lik_dyn_bytes (the packed constants, then one slot
    per band per thread), which the kernel library exports as
    mbb_lnprob_smem_bytes."""
    return 4 * (20 + nb * (nb + 2) + 2 * nb * nnodes + nb * threads)


def lnprob_smem_bytes(nb, nnodes, threads=LNPROB_MIN_THREADS):
    """Shared memory one block of `threads` threads of the lnprob kernel
    (by default its smallest block) takes for a likelihood of nb bands x
    nnodes nodes, as csrc/lnprob.cu computes it (builds the kernels)."""
    return int(build_kernels().mbb_lnprob_smem_bytes(nb, nnodes, threads))


def plan_mode(nnodes, noalpha=False, opthin=False):
    """The plan tables' key for a likelihood of nnodes nodes per band and a
    model with or without the Wien merge solve (noalpha), thick or thin."""
    if nnodes > 1:
        return "response"
    if not noalpha:
        return "point"
    return "point_noalpha_thin" if opthin else "point_noalpha_thick"


def lnprob_tiles(n, group, threads):
    """Tiles of threads / group vectors that hold n vectors."""
    return -(-n // (threads // group))


def lnprob_plan(group, threads, n, nb, nnodes, max_blocks=None):
    """The plan of `group` lanes per vector in blocks of `threads` threads
    for n vectors: one block per tile, or `max_blocks` blocks looping over
    the tiles when there are more."""
    tiles = max(lnprob_tiles(n, group, threads), 1)
    blocks = tiles if max_blocks is None else max(min(tiles, max_blocks), 1)
    return LnprobPlan(group, threads, blocks,
                      plan_smem_bytes(nb, nnodes, threads))


def fit_threads(nb, nnodes, smem_limit, threads=LNPROB_BLOCK_THREADS):
    """`threads`, less a warp at a time while a block of it takes more than
    `smem_limit` bytes of shared memory for nb bands x nnodes nodes (down to
    one warp, which may still not fit)."""
    while threads > LNPROB_MIN_THREADS \
            and plan_smem_bytes(nb, nnodes, threads) > smem_limit:
        threads -= 32
    return threads


def plan_lnprob_launch(nb, nnodes, n, noalpha=False, opthin=False,
                       sm_count=H100_SMS, smem_limit=H100_SMEM_OPTIN):
    """The lnprob kernel's layout for n vectors of a likelihood of nb bands
    x nnodes nodes and a model with (noalpha=False) or without the Wien
    merge solve, thick or optically thin, on a card of `sm_count` SMs with
    `smem_limit` bytes of shared memory per block: the first of
    LNPROB_PLAN_TABLE's lanes per vector for the mode with
    n x G <= sm_count x LNPROB_SM_LANES, one thread per vector for any
    batch; in blocks of fit_threads threads, one block per tile."""
    n = max(int(n), 1)
    threads = fit_threads(nb, nnodes, smem_limit)
    for group in LNPROB_PLAN_TABLE[plan_mode(nnodes, noalpha, opthin)]:
        if group == 1 or n * group <= sm_count * LNPROB_SM_LANES:
            return lnprob_plan(group, threads, n, nb, nnodes)
    raise AssertionError("LNPROB_PLAN_TABLE rows end with one thread per "
                         "vector")


def check_lnprob_plan(plan, nb, nnodes, n):
    """Raise ValueError unless `plan` is a layout the lnprob kernel runs for
    this likelihood and n vectors."""
    if not isinstance(plan, LnprobPlan):
        raise ValueError(f"plan must be a LnprobPlan, got {type(plan)}")
    g, t, b = plan.group, plan.threads, plan.blocks
    problems = []
    if g not in LNPROB_GROUPS:
        problems.append(f"group {g} not in {LNPROB_GROUPS}")
    if t % 32 or not LNPROB_MIN_THREADS <= t <= LNPROB_MAX_THREADS:
        problems.append(f"{t} threads is not a multiple of 32 in "
                        f"[{LNPROB_MIN_THREADS}, {LNPROB_MAX_THREADS}]")
    elif g in LNPROB_GROUPS:
        tiles = max(lnprob_tiles(n, g, t), 1)
        if not 1 <= b <= tiles:
            problems.append(f"{b} blocks outside 1..{tiles} tiles of "
                            f"{t // g} vectors")
    if plan.smem_bytes != plan_smem_bytes(nb, nnodes, t):
        problems.append(f"smem_bytes {plan.smem_bytes} != "
                        f"{plan_smem_bytes(nb, nnodes, t)} for {t} threads")
    if problems:
        raise ValueError("bad lnprob plan: " + "; ".join(problems))


@functools.lru_cache(maxsize=None)
def smem_optin_bytes(index):
    """The opt-in maximum of shared memory per block of CUDA device `index`
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    limit = build_kernels().mbb_smem_optin(index)
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of CUDA "
                           f"device {index}")
    return limit


def check_smem(nbytes, device, what):
    """Raise ValueError when a block of `nbytes` of shared memory does not
    fit the card: the kernels size their shared memory at launch and have
    no other cap."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    limit = smem_optin_bytes(index)
    if nbytes > limit:
        raise ValueError(
            f"{what} needs {nbytes} bytes of shared memory per block; the "
            f"card's opt-in maximum per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin) is {limit} bytes")


def response_nodes(wave, response_pack=None, device=None):
    """The (nbands, nnodes) fp64 wavelength nodes and weights the kernels
    sum over: the response pack, or one unit-weight node per band at the
    data wavelength. On a CUDA device a pack the lnprob kernel's block
    cannot hold is refused; on the CPU the plain version takes any size.
    `device` None is the card (fitter.resolve_device: without one this
    raises, naming device="cpu")."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    nb = len(wave)
    if response_pack is not None:
        waves = np.asarray(response_pack[0], np.float64)
        weights = np.asarray(response_pack[1], np.float64)
        if waves.shape != weights.shape or waves.ndim != 2 \
                or waves.shape[0] != nb:
            raise ValueError("response pack must be two (nbands, nnodes) "
                             "arrays")
    else:
        waves = np.asarray(wave, np.float64)[:, None]
        weights = np.ones((nb, 1))
    if torch.device(device).type == "cuda":
        check_smem(lnprob_smem_bytes(nb, waves.shape[1]), device,
                   f"a {nb} x {waves.shape[1]} response pack")
    return waves, weights


def pack_constants(shape, spec, free_space, flux, whiten, nodes, use_chol,
                   device):
    """(consts, icfg, fcfg): the packed constant buffer on `device` (layout
    in csrc/lnprob.cuh) and the host configuration arrays, for fluxes
    `flux` (nb,), whitening `whiten` (nb, nb), `nodes` = (waves, weights)
    from response_nodes and the upper-limit flags of spec.uplim_bands."""
    waves, weights = nodes
    nb, nnodes = waves.shape
    # Fixed parameters get a finite window centered on their value: the
    # kernel uses the same limits for the in-box check and the clip, so
    # they must contain the value (fix_param('alpha', 0.0) with the
    # default lower bound of 0.01).
    fv = np.asarray(spec.fixed_values, np.float64)
    lower = np.where(spec.fixed, fv - 1.0, spec.lower)
    upper = np.where(spec.fixed, fv + 1.0, spec.upper)
    uplim = np.zeros(nb)
    if spec.uplim_bands is not None:
        uplim[np.asarray(spec.uplim_bands, bool)] = 1.0
    packed = np.concatenate([
        lower, upper, spec.prior_mean, spec.prior_isigma,
        flux, np.ravel(whiten), waves.ravel(), weights.ravel(), uplim])
    consts = torch.as_tensor(packed.astype(np.float32), device=device)

    free_idx = np.zeros(NPARAMS, np.int64)
    free_idx[:free_space.nfree] = free_space.free_idx
    icfg = np.array([int(shape.opthin), int(shape.noalpha), int(use_chol),
                     nb, nnodes, free_space.nfree, *free_idx], np.int32)
    fcfg = np.array([*free_space.template, LOG_C2,
                     LOG_C2 - math.log(shape.wavenorm)], np.float32)
    return consts, icfg, fcfg


def prepare_lnprob_inputs(phot, shape, spec, response_pack=None,
                          device=None) -> LnprobOperands:
    """Pack a likelihood (photometry, model shape, spec, optional
    (waves, weights) response pack of shape (nbands, nnodes)) into kernel
    operands on `device`, with the plain version built beside them.
    `device` None is the card, as in build_lnprob."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    plain, free_space = build_lnprob(phot, shape, spec,
                                     response_pack=response_pack,
                                     device=device)
    nodes = response_nodes(phot.wave, response_pack, device)
    use_chol = phot.cov is not None
    whiten = (np.linalg.inv(np.linalg.cholesky(phot.cov)) if use_chol
              else np.diag(1.0 / phot.unc))
    consts, icfg, fcfg = pack_constants(shape, spec, free_space, phot.flux,
                                        whiten, nodes, use_chol, device)
    return LnprobOperands(consts=consts, icfg=icfg, fcfg=fcfg,
                          free_space=free_space, plain=plain)


def current_stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def device_sm_count(device):
    """The SMs of CUDA device `device` (multi_processor_count)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def plan_lnprob_on_card(nb, nnodes, n, noalpha, opthin, index):
    """plan_lnprob_launch for CUDA device `index`: its SMs and its
    shared-memory limit per block. Cached: a sampler asks for the same plan
    at every call."""
    return plan_lnprob_launch(nb, nnodes, n, noalpha, opthin,
                              device_sm_count(index),
                              smem_optin_bytes(index))


def mbb_lnprob(theta_free, ops: LnprobOperands, plan=None):
    """Batched lnprob (n, nfree) -> (n,) of the likelihood in `ops`:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    `plan` (a LnprobPlan) sets the kernel's layout; None takes
    plan_lnprob_launch's for the card (the plain version on the CPU has
    none, but a bad plan is refused on every device).

    Under the profiler its span records the bands and the nodes a band
    (the pack's padded count, 1 for point bands) and counts `sed_evals`:
    vectors x bands x nodes."""
    nb, nodes = int(ops.icfg[3]), int(ops.icfg[4])
    with span("mbb.kernel.k1", bands=nb, nodes=nodes):
        count("sed_evals",
              theta_free.numel() // theta_free.shape[-1] * nb * nodes)
        return _mbb_lnprob(theta_free, ops, plan)


def _mbb_lnprob(theta_free, ops: LnprobOperands, plan=None):
    if theta_free.device != ops.device:
        raise ValueError(f"theta on {theta_free.device}, likelihood "
                         f"operands on {ops.device}")
    if plan is not None:
        check_lnprob_plan(plan, int(ops.icfg[3]), int(ops.icfg[4]),
                          theta_free.shape[0])
    if theta_free.device.type == "cpu":
        return ops.plain(theta_free)
    if theta_free.device.type != "cuda":
        raise ValueError(f"unsupported device {theta_free.device}")
    if theta_free.dtype != torch.float32 or theta_free.dim() != 2 \
            or theta_free.shape[1] != ops.nfree \
            or not theta_free.is_contiguous():
        raise ValueError(
            f"theta must be a contiguous float32 (n, {ops.nfree}) tensor; "
            f"got {theta_free.dtype} {tuple(theta_free.shape)}")
    lib = build_kernels()
    n = theta_free.shape[0]
    nb, nnodes, noalpha, opthin, index, consts_ptr, icfg_ptr, fcfg_ptr = \
        ops.launch_args
    if plan is None:
        plan = plan_lnprob_on_card(nb, nnodes, n, noalpha, opthin, index)
    if plan.smem_bytes > 48 * 1024:
        check_smem(plan.smem_bytes, theta_free.device, "the lnprob kernel")
    out = torch.empty(n, dtype=torch.float32, device=theta_free.device)
    with torch.cuda.device(index):
        rc = lib.mbb_lnprob_launch(
            theta_free.data_ptr(), consts_ptr, out.data_ptr(), n, plan.group,
            plan.threads, plan.blocks, icfg_ptr, fcfg_ptr,
            current_stream_handle(index))
    if rc != 0:
        raise RuntimeError(f"mbb_lnprob kernel launch failed: CUDA error "
                           f"{rc} ({plan})")
    mbb_lnprob.launches += 1
    return out


mbb_lnprob.launches = 0
