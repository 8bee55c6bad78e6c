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
`FusedSampler` is the sampler surface around it.
"""

from __future__ import annotations

import functools

import torch

from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
    LnprobOperands, check_smem, current_stream_handle, mbb_lnprob,
    prepare_lnprob_inputs)
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, SamplerState, _check_run_args, stretch_run_plain)

# One block holds the ensemble: at most 1024 threads, one per walker pair.
MAX_WALKERS = 2048


def check_run_smem(icfg, half, device, what):
    """Refuse a stretch-move launch whose block (its size as
    csrc/stretch.cuh's mbb_run_dyn_bytes gives it) does not fit the card's
    shared memory."""
    nbytes = build_kernels().mbb_run_smem_bytes(int(icfg[3]), int(icfg[4]),
                                                int(half))
    check_smem(int(nbytes), device, what)


def mbb_stretch_run(state: SamplerState, ops: LnprobOperands, nrec, thin,
                    a=2.0, uniforms=None):
    """`nrec` records of `thin` stretch-move steps from `state` under the
    likelihood in `ops`. `uniforms` (nrec, 6 * thin, half) fp32 replaces the
    Philox stream keyed by state.seed at state.step. Returns
    (state, chain (nrec, nwalkers, nfree), lnpchain (nrec, nwalkers))."""
    device = state.pos_a.device
    if device != ops.device:
        raise ValueError(f"state on {device}, likelihood operands on "
                         f"{ops.device}")
    if device.type == "cpu":
        return stretch_run_plain(state, ops.plain, nrec, thin, a, uniforms)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    half, nfree = state.pos_a.shape
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
    check_run_smem(ops.icfg, half, device, "the stretch-move kernel")
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
            lnp_out.data_ptr(), nacc_out.data_ptr(), half, nrec, thin,
            float(a), state.seed & (2 ** 64 - 1), state.step,
            ops.icfg.ctypes.data, ops.fcfg.ctypes.data,
            current_stream_handle(device))
    if rc != 0:
        raise RuntimeError(f"mbb_stretch_run kernel launch failed: CUDA "
                           f"error {rc}")
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
