"""Walker-sharded affine-invariant sampler over a device mesh.

Torch twin of mbb_emcee_tpu/parallel/sharded_sampler.py. Each half-
ensemble's walker axis is split over the 1-D mesh in contiguous blocks,
shard d holding walkers d * half_loc .. (d + 1) * half_loc - 1 of each
half on its device. Every half-step, each shard gathers the WHOLE other
half in shard order (its blocks copied device to device: nhalf x ndim fp32,
a few KB at reference scale), proposes and accepts for its own block with
sampler.stretch_half_step_from_uniforms, so a partner index ranges over all
nhalf walkers, and evaluates its proposals with the lnprob bound to its
device (on a card the lnprob kernel, K1). Chains are recorded per shard
and concatenated once at the end of a run, on the mesh's first device;
nothing in the step loop waits on the host.

Randomness: shard d draws its lanes of the single-ensemble Philox stream
(ops/philox.stretch_uniforms with lane0 = d * half_loc; the counter's lane
word is the walker), so a walker-sharded run draws exactly the numbers of
the single-device run with the same seed, and with a likelihood that gives
a walker the same value in any batch its chain is EnsembleSampler's bit
for bit. This differs from the JAX sampler, which folds the mesh index
into its key and agrees with its single-device sampler only statistically.

State: between calls the SamplerState lives whole on the mesh's first
device (EnsembleSampler's layout, so a checkpoint is the same file with or
without a mesh); every call re-shards it (shard_state).
"""

from __future__ import annotations

import torch

from mbb_emcee_tpu_torch.ops.philox import BLOCK_ELEMS, stretch_uniforms
from mbb_emcee_tpu_torch.parallel.mesh import check_mesh
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, SamplerState, _check_run_args,
    stretch_half_step_from_uniforms)


class ShardedEnsembleSampler:
    """Same sampling semantics as sampler.EnsembleSampler, walker axis
    sharded over `mesh` (parallel.walker_mesh). nwalkers / 2 must be a
    multiple of the mesh size.

    lnprob_fn: one batched lnprob ((n, ndim) -> (n,)) that runs on every
    shard's device, or a sequence of them, one per shard, each bound to
    its shard's device (MBBFitter(mesh=) passes the lnprob kernel's
    operands prepared on each device)."""

    def __init__(self, nwalkers, ndim, lnprob_fn, mesh, a=2.0):
        mesh = check_mesh(mesh)
        ndev = mesh.size
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if (nwalkers // 2) % ndev:
            raise ValueError(
                f"the mesh size {ndev} must divide the half-ensemble size "
                f"{nwalkers // 2}")
        if nwalkers < 2 * ndim:
            raise ValueError("need nwalkers >= 2*ndim")
        fns = ([lnprob_fn] * ndev if callable(lnprob_fn)
               else list(lnprob_fn))
        if len(fns) != ndev:
            raise ValueError(f"need one lnprob per shard ({ndev}); got "
                             f"{len(fns)}")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self.mesh = mesh
        self.lnprob_shards = fns
        self.half_loc = self.nwalkers // 2 // ndev

    # -- state ------------------------------------------------------------------
    def _blocks(self, x):
        """Shard d's rows of a half-sized x, on its device."""
        h = self.half_loc
        return [x[d * h:(d + 1) * h].to(dev)
                for d, dev in enumerate(self.mesh.devices)]

    def _whole(self, blocks):
        """The blocks joined in shard order on the mesh's first device."""
        first = self.mesh.devices[0]
        return torch.cat([b.to(first) for b in blocks])

    def _eval(self, blocks):
        return [f(x) for f, x in zip(self.lnprob_shards, blocks)]

    def init_state(self, p0, seed, step=0) -> SamplerState:
        """p0: (nwalkers, ndim) fp32 initial positions (free space); each
        shard evaluates its blocks' lnprob on its device."""
        if tuple(p0.shape) != (self.nwalkers, self.ndim):
            raise ValueError("p0 shape mismatch")
        p0 = p0.to(self.mesh.devices[0], torch.float32)
        half = self.nwalkers // 2
        pos_a, pos_b = p0[:half], p0[half:]
        return SamplerState(
            pos_a=pos_a, pos_b=pos_b,
            lnp_a=self._whole(self._eval(self._blocks(pos_a))),
            lnp_b=self._whole(self._eval(self._blocks(pos_b))),
            naccept=torch.zeros(self.nwalkers, dtype=torch.int32,
                                device=p0.device),
            nsteps=0, seed=int(seed), step=int(step))

    reset_counters = staticmethod(EnsembleSampler.reset_counters)

    def shard_state(self, state: SamplerState):
        """The per-shard SamplerStates of a whole one (init_state's, a run's
        or a checkpoint's loaded on any device): shard d's walker blocks of
        both halves on its device, its accept counters [half A block, half
        B block], the shared counters and stream position."""
        half = self.nwalkers // 2
        acc = state.naccept.to(torch.int32)
        parts = zip(*(self._blocks(x.to(torch.float32)) for x in (
            state.pos_a, state.pos_b, state.lnp_a, state.lnp_b)),
            self._blocks(acc[:half]), self._blocks(acc[half:]))
        return [SamplerState(pos_a=pa, pos_b=pb, lnp_a=la, lnp_b=lb,
                             naccept=torch.cat([na, nb]),
                             nsteps=state.nsteps, seed=state.seed,
                             step=state.step)
                for pa, pb, la, lb, na, nb in parts]

    # -- run --------------------------------------------------------------------
    def _half_step(self, u, row, active, passive, lnp):
        """Every shard's block of one half updated against the gathered
        other half (one gather per distinct device, all of them queued
        before any shard's update: a copy off a device waits for the work
        queued there, so a gather made after a shard's update would hold
        the other cards until that update ended)."""
        gathered = {dev: None for dev in self.mesh.devices}
        for dev in gathered:
            gathered[dev] = torch.cat([p.to(dev) for p in passive])
        out = [stretch_half_step_from_uniforms(
            u[d][row:row + 3], active[d], gathered[dev], lnp[d],
            self.lnprob_shards[d], self.a)
            for d, dev in enumerate(self.mesh.devices)]
        return [list(t) for t in zip(*out)]

    def _dispatch(self, state: SamplerState, nrec, thin, record):
        h = self.half_loc
        devs = self.mesh.devices
        shards = self.shard_state(state)
        pa = [s.pos_a for s in shards]
        pb = [s.pos_b for s in shards]
        # both halves' lnprob recomputed first, as every run does
        la, lb = self._eval(pa), self._eval(pb)
        acc_a = [torch.zeros(h, dtype=torch.int32, device=dev)
                 for dev in devs]
        acc_b = [torch.zeros_like(x) for x in acc_a]
        if record:
            ca, cb = ([torch.empty((nrec, h, self.ndim), dtype=torch.float32,
                                   device=dev) for dev in devs]
                      for _ in range(2))
            lca, lcb = ([torch.empty((nrec, h), dtype=torch.float32,
                                     device=dev) for dev in devs]
                        for _ in range(2))
        # each shard's draws for a block of records at once (counter-based:
        # the blocking does not change them)
        per_rec = 6 * thin
        block = max(1, BLOCK_ELEMS // (per_rec * h))
        for r in range(nrec):
            if r % block == 0:
                n = min(block, nrec - r)
                drawn = [stretch_uniforms(state.seed, state.step + r * thin,
                                          n * thin, h, dev, lane0=d * h)
                         for d, dev in enumerate(devs)]
            k = r % block
            u = [x[k * per_rec:(k + 1) * per_rec] for x in drawn]
            for t in range(thin):
                pa, la, ok_a = self._half_step(u, 6 * t, pa, pb, la)
                pb, lb, ok_b = self._half_step(u, 6 * t + 3, pb, pa, lb)
                for d in range(len(devs)):
                    acc_a[d] += ok_a[d]
                    acc_b[d] += ok_b[d]
            if record:
                for d in range(len(devs)):
                    ca[d][r], cb[d][r] = pa[d], pb[d]
                    lca[d][r], lcb[d][r] = la[d], lb[d]
        first = devs[0]
        new_state = SamplerState(
            pos_a=self._whole(pa), pos_b=self._whole(pb),
            lnp_a=self._whole(la), lnp_b=self._whole(lb),
            naccept=state.naccept.to(first) + self._whole(acc_a + acc_b),
            nsteps=state.nsteps + nrec * thin, seed=state.seed,
            step=state.step + nrec * thin)
        if not record:
            return new_state, None, None
        chain = torch.cat([c.to(first) for c in ca + cb], dim=1)
        lnpchain = torch.cat([c.to(first) for c in lca + lcb], dim=1)
        return new_state, chain, lnpchain

    def run_mcmc(self, state: SamplerState, nsteps, thin=1):
        """Advance `nsteps` updates, recording every `thin`-th. Returns
        (state, chain (nsteps // thin, nwalkers, ndim), lnpchain), whole on
        the mesh's first device."""
        _check_run_args(nsteps, thin)
        return self._dispatch(state, nsteps // thin, int(thin), record=True)

    def advance(self, state: SamplerState, nsteps) -> SamplerState:
        """Advance without recording (burn-in): one record of `nsteps`
        thinned-away updates."""
        state, _, _ = self._dispatch(state, 1, int(nsteps), record=False)
        return state

    acceptance_fraction = staticmethod(EnsembleSampler.acceptance_fraction)
