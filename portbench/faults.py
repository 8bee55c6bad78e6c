"""Faults planted under the timed path, to show that the check fails them
(the benchmark's tests on the CPU, calibrate.py on the card; the
benchmark's own runs never plant one). Each wraps the port's samplers in
this process and returns a function that undoes it.

- frozen: every sampler run returns its state unchanged (the chain holds
  the start positions at every record);
- half: half of the batch is left out: the second half of the walkers (a
  single fit) or of the sources (a catalog) keeps its start state;
- altered: one stored answer is altered where it is produced: the first
  walker's first parameter at the last record of every source, by 5%;
- no_zfactor: the stretch move's acceptance rule loses its z^(nfree-1)
  factor (accept iff ln u < dlnp). The kernels' own external-uniforms
  path is driven with accept uniforms multiplied by z^(nfree-1), which
  turns their test ln u < (nfree-1) ln z + dlnp into that one; the
  walkers still move and every recorded lnprob still matches its
  position, but the ensemble samples another distribution.
"""

from __future__ import annotations

import dataclasses

NAMES = ("frozen", "half", "altered", "no_zfactor")
# the records of one kernel launch under no_zfactor are cut so that
# its uniforms stay under this many floats
UNIFORMS_MAX = 1 << 28


def _samplers():
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import (
        EnsembleSampler, MultiEnsembleSampler)
    return (EnsembleSampler, FusedSampler, MultiEnsembleSampler,
            FusedMultiSampler)


def _positions(state):
    """(S, nw, nfree) positions and (S, nw) lnprob of a single or multi
    state."""
    if hasattr(state, "pos_a"):
        return state.position[None], state.lnprob[None]
    return state.pos, state.lnp


def _with_positions(state, pos, lnp):
    if hasattr(state, "pos_a"):
        h = state.pos_a.shape[0]
        return dataclasses.replace(state, pos_a=pos[0, :h], pos_b=pos[0, h:],
                                   lnp_a=lnp[0, :h], lnp_b=lnp[0, h:])
    return dataclasses.replace(state, pos=pos, lnp=lnp)


def _freeze(state, new, chain, lnpc, part):
    """`new`, chain and lnp chain with the walkers or sources selected by
    `part` (a slice of (S, nw)) held at `state`'s positions."""
    single = chain.dim() == 3
    pos0, lnp0 = _positions(state)
    pos1, lnp1 = _positions(new)
    pos1, lnp1 = pos1.clone(), lnp1.clone()
    pos1[part], lnp1[part] = pos0[part], lnp0[part]
    ch = chain[None].clone() if single else chain.clone()
    lc = lnpc[None].clone() if single else lnpc.clone()
    s, w = part
    ch[s, :, w] = pos0[s, None, w].to(ch.dtype)
    lc[s, :, w] = lnp0[s, None, w].to(lc.dtype)
    if single:
        ch, lc = ch[0], lc[0]
    return _with_positions(new, pos1, lnp1), ch, lc


def _sampler_fault(name):
    def wrap(run):
        def run_mcmc(self, state, nsteps, thin=1, *a, **kw):
            new, chain, lnpc = run(self, state, nsteps, thin, *a, **kw)
            S, nw = _positions(state)[1].shape
            if name == "frozen":
                part = (slice(None), slice(None))
            elif name == "half":
                part = ((slice(None), slice(nw // 2, None)) if S == 1
                        else (slice(S // 2, None), slice(None)))
            else:
                chain = chain.clone()
                chain[..., -1, 0, 0] *= 1.05
                return new, chain, lnpc
            return _freeze(state, new, chain, lnpc, part)
        return run_mcmc
    return wrap


def _no_zfactor(run):
    """run_mcmc with the accept uniforms scaled by z^(nfree-1), through
    the external-uniforms path of the kernel (or plain sampler) under
    `run`, a record block at a time."""
    import torch
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        FusedMultiSampler, mbb_multi_stretch_run)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        FusedSampler, mbb_stretch_run)

    def call(self, state, nrec, thin, u):
        if isinstance(self, FusedSampler):
            return mbb_stretch_run(state, self.ops, nrec, thin, self.a, u)
        if isinstance(self, FusedMultiSampler):
            return mbb_multi_stretch_run(state, self.ops, nrec, thin,
                                         self.a, u, source0=self.source0)
        return run(self, state, nrec * thin, thin, uniforms=u)

    def run_mcmc(self, state, nsteps, thin=1, *a, **kw):
        pos, _ = _positions(state)
        S, nw, nfree = pos.shape
        single = hasattr(state, "pos_a")
        half = nw // 2
        nrec = nsteps // thin
        g = torch.Generator(device=pos.device)
        g.manual_seed((int(state.seed) * 1000003 + int(state.step))
                      % (2 ** 63))
        per_rec = S * 6 * thin * half
        block = max(1, min(nrec, UNIFORMS_MAX // per_rec))
        chains, lnps = [], []
        for r0 in range(0, nrec, block):
            n = min(block, nrec - r0)
            u = torch.rand((S, n, 6 * thin, half), generator=g,
                           dtype=torch.float32, device=pos.device)
            u = u.clamp_min(2.0 ** -25)
            u = u.view(S, n, thin, 2, 3, half)
            zw = (self.a - 1.0) * u[..., 0, :] + 1.0
            z = zw * zw / self.a
            u[..., 2, :] *= z.pow(nfree - 1)
            u = u.view(S, n, 6 * thin, half)
            state, chain, lnpc = call(self, state, n, thin,
                                      u[0].contiguous() if single else u)
            chains.append(chain)
            lnps.append(lnpc)
        dim = 0 if single else 1
        return state, torch.cat(chains, dim), torch.cat(lnps, dim)
    return run_mcmc


def apply(name):
    """Plant fault `name`; returns its undo."""
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
    saved = [(cls, cls.__dict__["run_mcmc"]) for cls in _samplers()]
    wrap = _no_zfactor if name == "no_zfactor" else _sampler_fault(name)
    for cls, run in saved:
        cls.run_mcmc = wrap(run)

    def undo():
        for cls, run in saved:
            cls.run_mcmc = run
    return undo

