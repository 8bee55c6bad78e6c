"""K2: the whole stretch-move run as one hand-written CUDA kernel launch.

Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_sampler.py
::_make_sampler_kernel (:63-194), which FusedPallasSampler._make_run
(:327-422) launches. The CUDA source is csrc/sampler.cu (its header notes
what bounds it and how it is laid out); it calls the lnprob kernel's
per-walker body from csrc/lnprob.cuh.

The plain PyTorch version is the EnsembleSampler run loop,
sampler.stretch_run_plain, over stretch_half_step_from_uniforms with the
same uniform layout and the same Philox stream. `mbb_stretch_run` runs the
plain version for a state on the CPU, and for a CUDA state launches the
kernel or raises; `mbb_stretch_run.launches` counts kernel launches.
`plan_stretch_launch` picks the kernel's layout (lanes per walker, blocks
per cluster). `FusedSampler` is the sampler surface around it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
    H100_SMEM_OPTIN, LnprobOperands, check_smem, current_stream_handle,
    mbb_lnprob, plan_mode, prepare_lnprob_inputs, smem_optin_bytes)
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, SamplerState, _check_run_args, stretch_run_plain)
from mbb_emcee_tpu_torch.utils.profiling import count, span

# The G = 1, C = 1 layout holds the ensemble in one block of at most 1024
# threads, one per walker pair.
MAX_WALKERS = 2048
MAX_THREADS = 1024
# A grouped layout's block is at most 512 threads, so its kernel may take
# 128 registers a thread (csrc/sampler.cu's launch bounds).
MAX_GROUP_THREADS = 512
GROUPS = (1, 8, 16, 32)       # lanes per walker
MAX_CLUSTER = 8               # blocks per cluster (the portable maximum)
# (lanes per walker, blocks per cluster) per mode: point mode (one node per
# band) with the Wien merge solve, without it (alpha fixed) for the thick
# and the optically thin model, and response mode. Chosen from
# chip_smoke.py's plan sweep (PERF.md).
PLAN_TABLE = {"point": (8, 8), "point_noalpha_thick": (8, 8),
              "point_noalpha_thin": (1, 1), "response": (32, 8)}
# mbb_stretch_launch's code for a cluster the card cannot place.
ERR_CLUSTER_UNPLACEABLE = -1


@dataclasses.dataclass(frozen=True)
class StretchPlan:
    """The stretch-move kernel's layout: `group` lanes of one warp per
    walker, `cluster` blocks (one thread-block cluster when above 1) of
    `threads` threads, each owning `walkers_per_block` walkers of each half,
    and `smem_bytes` of dynamic shared memory per block."""
    group: int
    cluster: int
    walkers_per_block: int
    threads: int
    smem_bytes: int


def run_smem_bytes(nb, nnodes, half, threads):
    """Dynamic shared memory of one stretch-move block of `threads` threads:
    csrc/stretch.cuh's mbb_run_dyn_bytes (the likelihood's constants and one
    slot per band per thread, then the ensemble's positions, lnprob and
    accepts at half rounded up to 32), which the kernel library exports as
    mbb_run_smem_bytes."""
    consts = 20 + nb * (nb + 2) + 2 * nb * nnodes
    hp = -(-half // 32) * 32
    return 4 * (consts + nb * threads) + 56 * hp


def max_threads(group):
    """Threads per block the kernel of `group` lanes per walker takes."""
    return MAX_THREADS if group == 1 else MAX_GROUP_THREADS


def stretch_plan(group, cluster, nb, nnodes, half):
    """The plan of `group` lanes per walker over `cluster` blocks for an
    ensemble of 2 * half walkers (G = 1, C = 1: one block of
    round_up(half, 32) threads, one per walker)."""
    wpb = -(-half // cluster)
    threads = -(-(wpb * group) // 32) * 32
    return StretchPlan(group, cluster, wpb, threads,
                       run_smem_bytes(nb, nnodes, half, threads))


def plan_stretch_launch(nb, nnodes, half, noalpha=False, opthin=False,
                        smem_limit=H100_SMEM_OPTIN):
    """The layout for nb bands x nnodes nodes, half walkers per half and a
    model with (noalpha=False) or without the Wien merge solve, thick or
    optically thin: PLAN_TABLE's for the mode (swept at 250 walkers), with
    its lanes per walker halved while the block does not fit (max_threads
    and `smem_limit` bytes), and the G = 1, C = 1 layout when no grouped
    one fits."""
    group, cluster = PLAN_TABLE[plan_mode(nnodes, noalpha, opthin)]
    while group in GROUPS[1:]:
        plan = stretch_plan(group, cluster, nb, nnodes, half)
        if plan.threads <= max_threads(group) \
                and plan.smem_bytes <= smem_limit:
            return plan
        group //= 2
    return stretch_plan(1, 1, nb, nnodes, half)


# K2's layouts: (lanes per walker, in a cluster) -> the most threads a
# block of it takes (csrc/sampler.cu instantiates every group with and
# without a cluster).
STRETCH_LAYOUTS = {(g, cl): max_threads(g) for g in GROUPS
                   for cl in (False, True)}


def check_plan(plan, nb, nnodes, half, layouts=STRETCH_LAYOUTS):
    """Raise ValueError unless `plan` is a layout the kernel runs for this
    likelihood and half-ensemble. `layouts` maps (lanes per walker, in a
    cluster) to the most threads a block of that layout takes, for every
    layout the kernel instantiates: K2's STRETCH_LAYOUTS by default (K3
    passes ops/multifit_kernel.py's MULTI_LAYOUTS)."""
    if not isinstance(plan, StretchPlan):
        raise ValueError(f"plan must be a StretchPlan, got {type(plan)}")
    groups = tuple(sorted({g for g, _ in layouts}))
    g, c, wpb, t = (plan.group, plan.cluster, plan.walkers_per_block,
                    plan.threads)
    problems = []
    if g not in groups:
        problems.append(f"group {g} not in {groups}")
    elif (g, c > 1) not in layouts:
        problems.append(f"group {g} runs only "
                        + ("in one block" if c > 1 else "in a cluster"))
    if not 1 <= c <= MAX_CLUSTER:
        problems.append(f"cluster {c} outside 1..{MAX_CLUSTER}")
    if wpb < 1 or wpb * c < half:
        problems.append(f"{c} blocks x {wpb} walkers do not hold {half} "
                        "walkers per half")
    limit = layouts.get((g, c > 1), MAX_THREADS)
    if t % 32 or t > limit or t < wpb * g:
        problems.append(f"{t} threads is not a multiple of 32 in "
                        f"[{wpb} walkers x {g} lanes, {limit}]")
    if g == 1 and c == 1 and t != -(-half // 32) * 32:
        problems.append(f"one block of one thread per walker runs "
                        f"{-(-half // 32) * 32} threads, not {t}")
    if plan.smem_bytes != run_smem_bytes(nb, nnodes, half, t):
        problems.append(f"smem_bytes {plan.smem_bytes} != "
                        f"{run_smem_bytes(nb, nnodes, half, t)} for {t} "
                        "threads")
    if problems:
        raise ValueError("bad stretch-move plan: " + "; ".join(problems))


def check_run_smem(icfg, half, threads, device, what):
    """Refuse a stretch-move launch whose block of `threads` threads (its
    size as csrc/stretch.cuh's mbb_run_dyn_bytes gives it) does not fit the
    card's shared memory."""
    nbytes = build_kernels().mbb_run_smem_bytes(
        int(icfg[3]), int(icfg[4]), int(half), int(threads))
    check_smem(int(nbytes), device, what)


def mbb_stretch_run(state: SamplerState, ops: LnprobOperands, nrec, thin,
                    a=2.0, uniforms=None, plan=None):
    """`nrec` records of `thin` stretch-move steps from `state` under the
    likelihood in `ops`. `uniforms` (nrec, 6 * thin, half) fp32 replaces the
    Philox stream keyed by state.seed at state.step. `plan` (a StretchPlan)
    sets the kernel's layout; None takes plan_stretch_launch's (the plain
    version on the CPU has none, but a bad plan is refused on every device).
    Returns (state, chain (nrec, nwalkers, nfree), lnpchain
    (nrec, nwalkers)).

    Under the profiler its span records the bands and the nodes a band
    (the pack's padded count, 1 for point bands) and counts `sed_evals`:
    steps x walkers x bands x nodes."""
    nb, nodes = int(ops.icfg[3]), int(ops.icfg[4])
    with span("mbb.kernel.k2", steps=nrec * thin, records=nrec, sources=1,
              bands=nb, nodes=nodes):
        count("sed_evals",
              nrec * thin * 2 * state.pos_a.shape[0] * nb * nodes)
        return _mbb_stretch_run(state, ops, nrec, thin, a, uniforms, plan)


def _mbb_stretch_run(state: SamplerState, ops: LnprobOperands, nrec, thin,
                     a=2.0, uniforms=None, plan=None):
    device = state.pos_a.device
    if device != ops.device:
        raise ValueError(f"state on {device}, likelihood operands on "
                         f"{ops.device}")
    half, nfree = state.pos_a.shape
    nb, nnodes = int(ops.icfg[3]), int(ops.icfg[4])
    if plan is not None:
        check_plan(plan, nb, nnodes, half)
    if device.type == "cpu":
        return stretch_run_plain(state, ops.plain, nrec, thin, a, uniforms)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    nw = 2 * half
    if nfree != ops.nfree or tuple(state.pos_b.shape) != (half, nfree):
        raise ValueError("state positions do not match the likelihood's "
                         f"{ops.nfree} free parameters")
    if nw > MAX_WALKERS:
        raise ValueError(f"at most {MAX_WALKERS} walkers per ensemble")
    pos = state.position.to(torch.float32).contiguous()
    nacc = state.naccept.to(torch.int32).contiguous()
    if uniforms is not None:
        if uniforms.device != device or uniforms.dtype != torch.float32 \
                or tuple(uniforms.shape) != (nrec, 6 * thin, half) \
                or not uniforms.is_contiguous():
            raise ValueError(
                f"uniforms must be a contiguous float32 "
                f"({nrec}, {6 * thin}, {half}) tensor on {device}")
    if plan is None:
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        plan = plan_stretch_launch(nb, nnodes, half, bool(ops.icfg[1]),
                                   bool(ops.icfg[0]), smem_optin_bytes(index))
    check_run_smem(ops.icfg, half, plan.threads, device,
                   "the stretch-move kernel")
    lib = build_kernels()
    chain = torch.empty((nrec, nw, nfree), dtype=torch.float32,
                        device=device)
    lnpchain = torch.empty((nrec, nw), dtype=torch.float32, device=device)
    pos_out = torch.empty((nw, nfree), dtype=torch.float32, device=device)
    lnp_out = torch.empty(nw, dtype=torch.float32, device=device)
    nacc_out = torch.empty(nw, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.mbb_stretch_launch(
            pos.data_ptr(), nacc.data_ptr(), ops.consts.data_ptr(),
            0 if uniforms is None else uniforms.data_ptr(),
            chain.data_ptr(), lnpchain.data_ptr(), pos_out.data_ptr(),
            lnp_out.data_ptr(), nacc_out.data_ptr(), half, plan.group,
            plan.cluster, plan.walkers_per_block, plan.threads, nrec, thin,
            float(a), state.seed & (2 ** 64 - 1), state.step,
            ops.icfg.ctypes.data, ops.fcfg.ctypes.data,
            current_stream_handle(device))
    if rc == ERR_CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"mbb_stretch_run: the card cannot place a "
                           f"cluster of {plan.cluster} blocks x "
                           f"{plan.threads} threads ({plan})")
    if rc != 0:
        raise RuntimeError(f"mbb_stretch_run kernel launch failed: CUDA "
                           f"error {rc} ({plan})")
    mbb_stretch_run.launches += 1
    new_state = SamplerState(
        pos_a=pos_out[:half], pos_b=pos_out[half:],
        lnp_a=lnp_out[:half], lnp_b=lnp_out[half:], naccept=nacc_out,
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


mbb_stretch_run.launches = 0


class FusedSampler:
    """Stretch-move sampler whose whole run is one kernel launch, built from
    the likelihood problem (the lnprob is compiled into the kernel), with the
    surface of sampler.EnsembleSampler.

    rng="hw" draws the proposals from the in-kernel Philox stream;
    rng="external" takes them from a `uniforms` argument (replay tests)."""

    def __init__(self, nwalkers, phot, shape, spec, response_pack=None,
                 a=2.0, rng="hw", device="cuda"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if rng not in ("hw", "external"):
            raise ValueError("rng must be 'hw' or 'external'")
        if nwalkers > MAX_WALKERS:
            raise ValueError(f"at most {MAX_WALKERS} walkers per ensemble")
        self.nwalkers = int(nwalkers)
        self.a = float(a)
        self.rng = rng
        self.ops = prepare_lnprob_inputs(phot, shape, spec, response_pack,
                                         device=device)
        self.free_space = self.ops.free_space
        self.ndim = self.free_space.nfree
        if nwalkers < 2 * self.ndim:
            raise ValueError(f"nwalkers={nwalkers} < 2*ndim={2 * self.ndim}")
        self.half = self.nwalkers // 2
        self.lnprob_batch = functools.partial(mbb_lnprob, ops=self.ops)

    reset_counters = staticmethod(EnsembleSampler.reset_counters)
    acceptance_fraction = staticmethod(EnsembleSampler.acceptance_fraction)

    def init_state(self, p0, seed, step=0) -> SamplerState:
        """p0: (nwalkers, ndim) initial positions on the sampler's device;
        lnprob through the lnprob kernel (plain version on the CPU)."""
        p0 = p0.to(torch.float32).contiguous()
        if tuple(p0.shape) != (self.nwalkers, self.ndim):
            raise ValueError(f"p0 shape {tuple(p0.shape)} != "
                             f"({self.nwalkers},{self.ndim})")
        lnp = mbb_lnprob(p0, self.ops)
        h = self.half
        return SamplerState(
            pos_a=p0[:h], pos_b=p0[h:], lnp_a=lnp[:h], lnp_b=lnp[h:],
            naccept=torch.zeros(self.nwalkers, dtype=torch.int32,
                                device=p0.device),
            nsteps=0, seed=int(seed), step=int(step))

    def run_mcmc(self, state: SamplerState, nsteps, thin=1, uniforms=None):
        """Advance `nsteps` updates in one launch, recording every
        `thin`-th. `uniforms` only in rng='external' mode:
        (nsteps // thin, 6 * thin, nwalkers // 2)."""
        _check_run_args(nsteps, thin)
        if uniforms is not None and self.rng != "external":
            raise ValueError(
                "uniforms= requires rng='external'; the Philox sampler "
                "would silently ignore the provided stream")
        if uniforms is None and self.rng == "external":
            raise ValueError("rng='external' requires a uniforms array")
        return mbb_stretch_run(state, self.ops, nsteps // thin, thin, self.a,
                               uniforms)

    def advance(self, state: SamplerState, nsteps, uniforms=None):
        """Advance without keeping the chain (burn-in)."""
        state, _, _ = self.run_mcmc(state, nsteps, thin=nsteps,
                                    uniforms=uniforms)
        return state
