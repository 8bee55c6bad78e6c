"""Affine-invariant ensemble sampler (Goodman & Weare 2010), plain torch.

Torch twin of mbb_emcee_tpu/sampler.py. Move (red-black half-ensemble
update, a = 2 by default):

    split the ensemble into halves A, B
    for each walker k of the active half pick j in the other half,
    draw z ~ g(z) propto 1/sqrt(z) on [1/a, a]: z = ((a-1) u + 1)^2 / a
    propose Y = X_j + z (X_k - X_j)
    accept with min(1, z^(d-1) e^(lnP(Y) - lnP(X_k))),  d = n_free

Half B updates against the already-updated half A, as emcee orders it.

The run loop here (`stretch_run_plain`) is the plain version of the CUDA
stretch-move kernel (ops/sampler_kernel.py): it consumes the kernel's
uniform layout, (nrec, 6 * thin, half) with rows z/partner/accept for half A
then half B, and draws them from the kernel's own Philox-4x32-10 stream
(ops/philox.py) when none are given, so for a given seed both produce the
same chain up to fp32 rounding. `multi_stretch_run_plain` is the same loop
over S independent ensembles in lockstep, the plain version of the
multi-source kernel (ops/multifit_kernel.py), one Philox stream per source.

On a card, EnsembleSampler and MultiEnsembleSampler run those loops on one
captured CUDA graph of one ensemble step (`_StepGraph`: both half-steps
with their Philox draws, the step counter on the device), replayed `thin`
times per record: the chain of the eager loop bit for bit, with one graph
launch per step where the eager step launches every elementwise op of the
lnprob from Python. The JAX package compiles the same loop into one
program. A step that cannot be captured (a model that copies host data to
the device, syncs or branches on a tensor value) runs the eager loop
instead and warns once; `graph_mode` says which ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import warnings

import numpy as np
import torch

from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR
from mbb_emcee_tpu_torch.ops.philox import round_keys, stretch_uniforms


@dataclasses.dataclass
class SamplerState:
    """Ensemble state; positions are in the free-parameter space.

    `seed` is the 64-bit Philox key of the run and `step` the number of
    ensemble steps drawn from it so far (never reset): each launch continues
    the stream where the previous one stopped."""
    pos_a: torch.Tensor      # (half, ndim)
    pos_b: torch.Tensor      # (half, ndim)
    lnp_a: torch.Tensor      # (half,)
    lnp_b: torch.Tensor      # (half,)
    naccept: torch.Tensor    # (nwalkers,) int32 accept counts since reset
    nsteps: int              # steps taken since reset
    seed: int
    step: int = 0

    @property
    def position(self):
        return torch.cat([self.pos_a, self.pos_b], dim=0)

    @property
    def lnprob(self):
        return torch.cat([self.lnp_a, self.lnp_b], dim=0)


@dataclasses.dataclass
class MultiSamplerState:
    """State of S independent ensembles advanced in lockstep (the batch
    tier); positions in the free-parameter space. `seed` and `step` are
    shared: source s draws the Philox stream (seed, step, source s)."""
    pos: torch.Tensor        # (S, nwalkers, ndim)
    lnp: torch.Tensor        # (S, nwalkers)
    naccept: torch.Tensor    # (S, nwalkers) int32 accept counts since reset
    nsteps: int              # steps taken since reset
    seed: int
    step: int = 0


def stretch_half_step_from_uniforms(u3, active, passive, lnp_active,
                                    lnprob_batch, a=2.0):
    """Update one half-ensemble against the frozen other half, consuming
    uniforms u3 of shape (..., 3, n): z draw, partner pick, accept. Leading
    axes are independent ensembles (the batch tier's sources): active and
    passive are (..., n, ndim), lnp_active (..., n), and lnprob_batch maps
    (..., n, ndim) -> (..., n). Returns (new_active, new_lnp, accepted)."""
    ndim = active.shape[-1]
    z = ((a - 1.0) * u3[..., 0, :] + 1.0) ** 2 / a
    npass = passive.shape[-2]
    j = torch.clamp((u3[..., 1, :] * npass).to(torch.int64), max=npass - 1)
    partners = torch.take_along_dim(passive, j[..., None], dim=-2)
    proposal = partners + z[..., None] * (active - partners)
    lnp_prop = lnprob_batch(proposal)
    log_ratio = (ndim - 1) * torch.log(z) + lnp_prop - lnp_active
    # u3[2] can be exactly 0 in fp32 and log(0) = -inf would accept an
    # out-of-box proposal sitting at the finite LNPROB_FLOOR.
    accept = ((torch.log(u3[..., 2, :]) < log_ratio)
              & (lnp_prop > SUPPORT_FLOOR))
    new_active = torch.where(accept[..., None], proposal, active)
    new_lnp = torch.where(accept, lnp_prop, lnp_active)
    return new_active, new_lnp, accept


def _stretch_records(pos_a, pos_b, lnprob_batch, nrec, thin, a, draw):
    """The run loop both plain runs share: `nrec` records of `thin` steps,
    each record's uniforms (..., 6 * thin, half) from draw(r). Both halves'
    lnprob are recomputed first, as the kernels do. Returns the final
    halves, their lnprob, the accepts of each half, chain
    (..., nrec, nw, ndim) and lnpchain (..., nrec, nw)."""
    lead = pos_a.shape[:-2]
    half, ndim = pos_a.shape[-2:]
    device = pos_a.device
    lnp_a, lnp_b = lnprob_batch(pos_a), lnprob_batch(pos_b)
    acc_a = torch.zeros(lead + (half,), dtype=torch.int32, device=device)
    acc_b = torch.zeros_like(acc_a)
    chain = torch.empty(lead + (nrec, 2 * half, ndim), dtype=pos_a.dtype,
                        device=device)
    lnpchain = torch.empty(lead + (nrec, 2 * half), dtype=pos_a.dtype,
                           device=device)
    for r in range(nrec):
        u = draw(r)
        for t in range(thin):
            pos_a, lnp_a, ok_a = stretch_half_step_from_uniforms(
                u[..., 6 * t:6 * t + 3, :], pos_a, pos_b, lnp_a,
                lnprob_batch, a)
            pos_b, lnp_b, ok_b = stretch_half_step_from_uniforms(
                u[..., 6 * t + 3:6 * t + 6, :], pos_b, pos_a, lnp_b,
                lnprob_batch, a)
            acc_a += ok_a
            acc_b += ok_b
        chain[..., r, :half, :] = pos_a
        chain[..., r, half:, :] = pos_b
        lnpchain[..., r, :half] = lnp_a
        lnpchain[..., r, half:] = lnp_b
    return pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain


def stretch_run_plain(state: SamplerState, lnprob_batch, nrec, thin,
                      a=2.0, uniforms=None):
    """`nrec` records of `thin` ensemble steps each, recording after every
    thin block: the plain version of the stretch-move kernel (K2).
    `uniforms` (nrec, 6 * thin, half) replaces the Philox stream.

    Returns (state, chain (nrec, nwalkers, ndim), lnpchain (nrec, nwalkers)).
    """
    stretch_run_plain.runs += 1
    half = state.pos_a.shape[0]

    def draw(r):
        if uniforms is not None:
            return uniforms[r]
        return stretch_uniforms(state.seed, state.step + r * thin, thin,
                                half, state.pos_a.device)

    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = \
        _stretch_records(state.pos_a, state.pos_b, lnprob_batch, nrec,
                         thin, a, draw)
    new_state = SamplerState(
        pos_a=pos_a, pos_b=pos_b, lnp_a=lnp_a, lnp_b=lnp_b,
        naccept=state.naccept + torch.cat([acc_a, acc_b]),
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


stretch_run_plain.runs = 0


def multi_stretch_run_plain(state: MultiSamplerState, lnprob_batch, nrec,
                            thin, a=2.0, uniforms=None, source0=0):
    """The plain version of the multi-source stretch-move kernel (K3): S
    independent ensembles, `nrec` records of `thin` steps each, all sources
    in lockstep. lnprob_batch maps (S, n, ndim) -> (S, n). Source s draws
    the Philox stream of global source source0 + s (a shard of a catalog
    passes its first source's index); `uniforms` (S, nrec, 6 * thin, half)
    replaces the streams.

    Returns (state, chain (S, nrec, nwalkers, ndim),
    lnpchain (S, nrec, nwalkers))."""
    multi_stretch_run_plain.runs += 1
    nsrc, nw = state.pos.shape[:2]
    half = nw // 2
    sources = torch.arange(nsrc, device=state.pos.device) + int(source0)

    def draw(r):
        if uniforms is not None:
            return uniforms[:, r]
        return stretch_uniforms(state.seed, state.step + r * thin, thin,
                                half, state.pos.device, source=sources)

    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = \
        _stretch_records(state.pos[:, :half], state.pos[:, half:],
                         lnprob_batch, nrec, thin, a, draw)
    new_state = MultiSamplerState(
        pos=torch.cat([pos_a, pos_b], dim=1),
        lnp=torch.cat([lnp_a, lnp_b], dim=1),
        naccept=state.naccept + torch.cat([acc_a, acc_b], dim=1),
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


multi_stretch_run_plain.runs = 0


# Eager steps on the capture stream before a capture (the first call of a
# model does its lazy set-up there, outside the graph).
GRAPH_WARMUP_STEPS = 2


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector held off. A collection inside a
    capture can free a dead object's CUDA graph (a fitter in a reference
    cycle, with its sampler's graph), and a graph destroyed while a stream
    captures invalidates the capture (cudaErrorStreamCaptureInvalidated):
    every capture runs in this context."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _StepGraph:
    """One ensemble step of _stretch_records -- half A then half B, each
    with its three rows of Philox draws -- captured as a CUDA graph over
    static buffers: the halves, their lnprob, the accept counts, the
    global step (a 0-d int64 the graph increments) and the round keys.
    `source` (an int64 tensor on the device: 0-d for one ensemble, the
    global source indices for S) keys the streams as stretch_uniforms
    does, so a replay draws the rows of the eager loop's record draw."""

    def __init__(self, lnprob_batch, pos_a, a, source):
        self.lnprob_batch, self.a, self.source = lnprob_batch, a, source
        self.half = pos_a.shape[-2]
        lnp_shape = pos_a.shape[:-1]
        dev = pos_a.device
        self.pos_a = torch.empty_like(pos_a,
                                      memory_format=torch.contiguous_format)
        self.pos_b = torch.empty_like(self.pos_a)
        self.lnp_a = torch.empty(lnp_shape, dtype=pos_a.dtype, device=dev)
        self.lnp_b = torch.empty_like(self.lnp_a)
        self.acc_a = torch.zeros(lnp_shape, dtype=torch.int32, device=dev)
        self.acc_b = torch.zeros_like(self.acc_a)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.keys = round_keys(0, dev)
        self.graph = None

    def load(self, pos_a, pos_b, lnp_a, lnp_b, seed, step):
        """Copy a run's start into the static buffers."""
        for dst, src in ((self.pos_a, pos_a), (self.pos_b, pos_b),
                         (self.lnp_a, lnp_a), (self.lnp_b, lnp_b)):
            dst.copy_(src)
        self.acc_a.zero_()
        self.acc_b.zero_()
        self.step.fill_(int(step))
        self.keys.copy_(round_keys(seed, self.keys.device))

    def step_once(self):
        """The captured body: one step on the static buffers."""
        u = stretch_uniforms(self.keys, self.step, 1, self.half,
                             self.step.device, source=self.source)
        for rows, act, pas, lnp, acc in (
                (slice(0, 3), self.pos_a, self.pos_b, self.lnp_a,
                 self.acc_a),
                (slice(3, 6), self.pos_b, self.pos_a, self.lnp_b,
                 self.acc_b)):
            new, new_lnp, ok = stretch_half_step_from_uniforms(
                u[..., rows, :], act, pas, lnp, self.lnprob_batch, self.a)
            act.copy_(new)
            lnp.copy_(new_lnp)
            acc += ok
        self.step += 1

    def capture(self, graph=None):
        """Warm up on a side stream, then capture step_once into `graph`
        (a new torch.cuda.CUDAGraph by default; one built with
        keep_graph=True keeps its nodes readable). The static buffers must
        hold a run's start: the warm-up steps move them."""
        dev = self.step.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP_STEPS):
                    self.step_once()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph() if graph is None else graph
            with gc_paused(), torch.cuda.graph(graph, stream=side):
                self.step_once()
        self.graph = graph

    def records(self, nrec, thin):
        """`nrec` records of `thin` replays from the loaded start, in
        _stretch_records' return layout. Before a capture (the CPU) each
        step runs step_once eagerly: the body the graph holds."""
        step = self.step_once if self.graph is None else self.graph.replay
        lead, (half, ndim) = self.pos_a.shape[:-2], self.pos_a.shape[-2:]
        chain = torch.empty(lead + (nrec, 2 * half, ndim),
                            dtype=self.pos_a.dtype, device=self.step.device)
        lnpchain = torch.empty(lead + (nrec, 2 * half),
                               dtype=self.pos_a.dtype,
                               device=self.step.device)
        for r in range(nrec):
            for _ in range(thin):
                step()
            chain[..., r, :half, :] = self.pos_a
            chain[..., r, half:, :] = self.pos_b
            lnpchain[..., r, :half] = self.lnp_a
            lnpchain[..., r, half:] = self.lnp_b
        return tuple(t.clone() for t in (
            self.pos_a, self.pos_b, self.lnp_a, self.lnp_b, self.acc_a,
            self.acc_b)) + (chain, lnpchain)


def step_source(pos_a, source0=0):
    """_StepGraph's `source` for the half-ensemble `pos_a`: 0-d (one
    ensemble) or the global indices source0.. of its S sources."""
    lead = pos_a.shape[:-2]
    if not lead:
        return torch.zeros((), dtype=torch.int64, device=pos_a.device)
    return torch.arange(lead[0], dtype=torch.int64,
                        device=pos_a.device) + int(source0)


class _StepGraphs:
    """A sampler's captured steps, one per (leading shape, device) of its
    state (its lnprob and `a` are its own), and the mode of its last run:
    "graph", or "eager" (the CPU, external uniforms, a sampler built with
    capture=False, or a step that raised while being captured or launched
    a hand-written kernel: that warns once, naming the model (_label) and
    the error, and the sampler stays eager on that shape and device)."""

    def __init__(self, lnprob_batch, a):
        self.lnprob_batch, self.a = lnprob_batch, a
        self.graphs = {}
        self.mode = None

    def _graph(self, key, pos_a, source0, start):
        if key not in self.graphs:
            from mbb_emcee_tpu_torch.ops import kernel_launches
            g = _StepGraph(self.lnprob_batch, pos_a, self.a,
                           step_source(pos_a, source0))
            g.load(*start)
            launched = kernel_launches()
            try:
                g.capture()
                if kernel_launches() != launched:
                    # a replay would launch the kernel uncounted
                    raise RuntimeError(
                        "it launches a hand-written kernel (ops."
                        "kernel_launches), which counts its launches in "
                        "its wrapper where a replay would not")
            except Exception as e:  # noqa: BLE001 -- any capture fault
                cause = e.__context__ or e
                warnings.warn(
                    f"the stretch step of {_label(self.lnprob_batch)} "
                    f"could not be captured as a CUDA graph "
                    f"({type(cause).__name__}: {cause}); it runs eagerly, "
                    "one launch per operation (see sed.py's model "
                    "contract)",
                    RuntimeWarning, stacklevel=5)
                torch.cuda.synchronize(pos_a.device)
                g = None
            self.graphs[key] = g
        return self.graphs[key]

    def records(self, pos_a, pos_b, seed, step, nrec, thin, source0=0):
        """_stretch_records on the captured step, drawing from the Philox
        stream (seed, step) as the eager loop does. None (mode "eager")
        when the step could not be captured."""
        key = (tuple(pos_a.shape), pos_a.device)
        if key in self.graphs and self.graphs[key] is None:
            self.mode = "eager"         # refused before: nothing to load
            return None
        start = (pos_a, pos_b, self.lnprob_batch(pos_a),
                 self.lnprob_batch(pos_b), seed, step)
        g = self._graph(key, pos_a, source0, start)
        self.mode = "eager" if g is None else "graph"
        if g is None:
            return None
        g.load(*start)
        return g.records(nrec, thin)


def stretch_run_graphed(state: SamplerState, graphs: _StepGraphs, nrec,
                        thin):
    """stretch_run_plain's run on the sampler's captured step: the same
    chain, lnprob and accept counts bit for bit, one graph replay per
    step. None when the step could not be captured."""
    out = graphs.records(state.pos_a, state.pos_b, state.seed, state.step,
                         nrec, thin)
    if out is None:
        return None
    stretch_run_graphed.runs += 1
    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = out
    new_state = SamplerState(
        pos_a=pos_a, pos_b=pos_b, lnp_a=lnp_a, lnp_b=lnp_b,
        naccept=state.naccept + torch.cat([acc_a, acc_b]),
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


stretch_run_graphed.runs = 0


def multi_stretch_run_graphed(state: MultiSamplerState, graphs: _StepGraphs,
                              nrec, thin, source0=0):
    """multi_stretch_run_plain's run on the sampler's captured step, bit
    for bit (source s on the stream of global source source0 + s). None
    when the step could not be captured."""
    half = state.pos.shape[1] // 2
    out = graphs.records(state.pos[:, :half], state.pos[:, half:],
                         state.seed, state.step, nrec, thin, source0)
    if out is None:
        return None
    multi_stretch_run_graphed.runs += 1
    pos_a, pos_b, lnp_a, lnp_b, acc_a, acc_b, chain, lnpchain = out
    new_state = MultiSamplerState(
        pos=torch.cat([pos_a, pos_b], dim=1),
        lnp=torch.cat([lnp_a, lnp_b], dim=1),
        naccept=state.naccept + torch.cat([acc_a, acc_b], dim=1),
        nsteps=state.nsteps + nrec * thin, seed=state.seed,
        step=state.step + nrec * thin)
    return new_state, chain, lnpchain


multi_stretch_run_graphed.runs = 0


def _check_run_args(nsteps, thin):
    if int(thin) < 1:
        raise ValueError(f"thin={thin} must be >= 1")
    if nsteps <= 0:
        raise ValueError("nsteps must be positive")
    if nsteps % thin:
        raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")


def _label(lnprob_batch):
    """The model's name in a capture warning: the `label` that a fitter's
    likelihood builder sets on the lnprob (or on the object whose method
    it is), else the callable's qualified name."""
    for obj in (lnprob_batch, getattr(lnprob_batch, "__self__", None)):
        label = getattr(obj, "label", None)
        if label:
            return label
    return getattr(lnprob_batch, "__qualname__", repr(lnprob_batch))


class EnsembleSampler:
    """Stretch-move ensemble sampler over any batched lnprob
    ((n, ndim) -> (n,)), with the surface of the JAX package's sampler:
    init_state / run_mcmc / advance / reset_counters / acceptance_fraction.
    On a card a run replays one captured step (stretch_run_graphed), and
    `graph_mode` is "graph" or "eager" after a run. capture=False keeps
    the eager loop: for an lnprob whose work spans several cards (a graph
    records one card's stream), as HierarchicalFitter's over a mesh of
    several cards.
    """

    def __init__(self, nwalkers, ndim, lnprob_batch, a=2.0, capture=True):
        if nwalkers < 2 * ndim:
            raise ValueError(
                f"nwalkers={nwalkers} < 2*ndim={2 * ndim}: the stretch move "
                "needs at least twice the dimension (prefer many more)")
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self.lnprob_batch = lnprob_batch
        self.capture = bool(capture)
        self._graphs = _StepGraphs(lnprob_batch, self.a)

    @property
    def graph_mode(self):
        return self._graphs.mode

    def init_state(self, p0, seed, step=0) -> SamplerState:
        """p0: (nwalkers, ndim) fp32 initial positions (free space)."""
        if tuple(p0.shape) != (self.nwalkers, self.ndim):
            raise ValueError(f"p0 shape {tuple(p0.shape)} != "
                             f"({self.nwalkers},{self.ndim})")
        half = self.nwalkers // 2
        lnp = self.lnprob_batch(p0)
        return SamplerState(
            pos_a=p0[:half], pos_b=p0[half:],
            lnp_a=lnp[:half], lnp_b=lnp[half:],
            naccept=torch.zeros(self.nwalkers, dtype=torch.int32,
                                device=p0.device),
            nsteps=0, seed=int(seed), step=int(step))

    @staticmethod
    def reset_counters(state: SamplerState) -> SamplerState:
        """Zero the acceptance and step counters (emcee's reset() between
        burn-in and production); the Philox stream position is kept."""
        return dataclasses.replace(
            state, naccept=torch.zeros_like(state.naccept), nsteps=0)

    def run_mcmc(self, state: SamplerState, nsteps, thin=1, uniforms=None):
        """Advance `nsteps` updates, recording every `thin`-th. Returns
        (state, chain (nsteps//thin, nwalkers, ndim), lnpchain)."""
        _check_run_args(nsteps, thin)
        if uniforms is None and state.pos_a.is_cuda and self.capture:
            out = stretch_run_graphed(state, self._graphs, nsteps // thin,
                                      thin)
            if out is not None:
                return out
        self._graphs.mode = "eager"
        return stretch_run_plain(state, self.lnprob_batch, nsteps // thin,
                                 thin, self.a, uniforms)

    def advance(self, state: SamplerState, nsteps):
        """Advance without keeping the chain (burn-in)."""
        state, _, _ = self.run_mcmc(state, nsteps, thin=nsteps)
        return state

    @staticmethod
    def acceptance_fraction(state: SamplerState):
        """Per-walker acceptance fraction since the last reset."""
        return state.naccept.double().cpu().numpy() / max(state.nsteps, 1)


class MultiEnsembleSampler:
    """S independent stretch-move ensembles in lockstep over a batched
    lnprob ((S, n, ndim) -> (S, n)): the plain multi run
    (multi_stretch_run_plain), source s on the Philox stream of global
    source source0 + s, with the surface the batch tier's run protocol
    drives (batchengine.BatchEngine.run): init_state / run_mcmc / advance /
    reset_counters / acceptance_fraction. The multi-source kernel's sampler
    (ops/multifit_kernel.FusedMultiSampler) is this surface on K3. On a
    card a run replays one captured step (multi_stretch_run_graphed;
    `graph_mode` as EnsembleSampler's)."""

    def __init__(self, nsources, nwalkers, ndim, lnprob_batch, a=2.0,
                 free_space=None, source0=0):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if nwalkers < 2 * ndim:
            raise ValueError(f"nwalkers={nwalkers} < 2*ndim={2 * ndim}")
        self.nsources = int(nsources)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.half = self.nwalkers // 2
        self.a = float(a)
        self.lnprob_batch = lnprob_batch
        self.free_space = free_space
        self.source0 = int(source0)
        self._graphs = _StepGraphs(lnprob_batch, self.a)

    graph_mode = EnsembleSampler.graph_mode

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
        """Advance every source `nsteps` updates, recording every
        `thin`-th; `uniforms` (S, nsteps // thin, 6 * thin, half) replaces
        the Philox streams."""
        _check_run_args(nsteps, thin)
        if uniforms is None and state.pos.is_cuda:
            out = multi_stretch_run_graphed(state, self._graphs,
                                            nsteps // thin, thin,
                                            self.source0)
            if out is not None:
                return out
        self._graphs.mode = "eager"
        return multi_stretch_run_plain(state, self.lnprob_batch,
                                       nsteps // thin, thin, self.a,
                                       uniforms, self.source0)

    def advance(self, state: MultiSamplerState, nsteps, uniforms=None):
        """Advance without keeping the chain (burn-in)."""
        state, _, _ = self.run_mcmc(state, nsteps, thin=nsteps,
                                    uniforms=uniforms)
        return state


def make_initial_ball(generator, center, scatter, nwalkers, lower=None,
                      upper=None, device=None):
    """Gaussian ball of walkers around `center` (free space), REFLECTED at
    the box bounds, as an fp32 (nwalkers, ndim) tensor on `device` (None:
    the card; without one this raises, naming device="cpu").

    The normal draws come from `generator` (a CPU torch.Generator), so a
    seed gives the same ball on every device. Reflection (not clipping)
    keeps the spread in every dimension: a stretch-move ensemble that is
    degenerate in a coordinate can never leave that hyperplane. Only
    out-of-box values are reflected, so in-box values are never rounded to
    the fp32 quantum at the bound.
    """
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    center = torch.as_tensor(np.asarray(center, np.float32))
    scatter = torch.as_tensor(np.asarray(scatter, np.float32))
    eps = torch.randn((nwalkers, center.numel()), generator=generator,
                      dtype=torch.float32)
    ball = center + eps * scatter
    lo = None if lower is None else torch.as_tensor(
        np.asarray(lower, np.float32))
    hi = None if upper is None else torch.as_tensor(
        np.asarray(upper, np.float32))
    if lo is not None or hi is not None:
        if lo is not None and hi is not None:
            tiny = 1e-9 * (hi - lo)
        else:
            # one-sided constraint: still reflect at the bound that exists
            ref = lo if hi is None else hi
            tiny = 1e-9 * torch.clamp(torch.abs(ref), min=1.0)
        if lo is not None:
            lo_m = lo + tiny
            ball = torch.where(ball < lo_m, 2.0 * lo_m - ball, ball)
        if hi is not None:
            hi_m = hi - tiny
            ball = torch.where(ball > hi_m, 2.0 * hi_m - ball, ball)
        # pathological double overshoot
        if lo is not None:
            ball = torch.maximum(ball, lo_m)
        if hi is not None:
            ball = torch.minimum(ball, hi_m)
    return ball.to(device)


def split_rhat(chain):
    """Split-R-hat per dimension (BDA3 sec. 11.4); chain (nsteps, nwalkers,
    ndim) host numpy. A frozen dimension returns NaN."""
    chain = np.asarray(chain, np.float64)
    half = chain.shape[0] // 2
    if half < 2:
        raise ValueError("need at least 4 recorded steps")
    sp = np.concatenate([chain[:half], chain[half:2 * half]], axis=1)
    sp = np.transpose(sp, (1, 0, 2))            # (m, n, ndim)
    n = sp.shape[1]
    means = sp.mean(axis=1)
    w = sp.var(axis=1, ddof=1).mean(axis=0)
    b = n * means.var(axis=0, ddof=1)
    var_post = (n - 1) / n * w + b / n
    rhat = np.sqrt(var_post / np.maximum(w, 1e-30))
    return np.where(var_post <= 1e-30, np.nan, rhat)


# Acklam's rational approximation to the inverse normal CDF
# (|relative error| < 1.2e-9).
_NDTRI_A = (-3.969683028665376e+01, 2.209460984245205e+02,
            -2.759285104469687e+02, 1.383577518672690e+02,
            -3.066479806614716e+01, 2.506628277459239e+00)
_NDTRI_B = (-5.447609879822406e+01, 1.615858368580409e+02,
            -1.556989798598866e+02, 6.680131188771972e+01,
            -1.328068155288572e+01)
_NDTRI_C = (-7.784894002430293e-03, -3.223964580411365e-01,
            -2.400758277161838e+00, -2.549732539343734e+00,
            4.374664141464968e+00, 2.938163982698783e+00)
_NDTRI_D = (7.784695709041462e-03, 3.224671290700398e-01,
            2.445134137142996e+00, 3.754408661907416e+00)


def _poly(coeffs, x):
    out = np.full_like(x, coeffs[0], dtype=np.float64)
    for c in coeffs[1:]:
        out = out * x + c
    return out


def inverse_normal_cdf(p):
    """Phi^-1(p) elementwise, host fp64 (Acklam's approximation)."""
    p = np.asarray(p, np.float64)
    x = np.empty_like(p)
    lo, hi = 0.02425, 1.0 - 0.02425
    low = p < lo
    high = p > hi
    mid = ~(low | high)
    if np.any(mid):
        q = p[mid] - 0.5
        r = q * q
        x[mid] = _poly(_NDTRI_A, r) * q / (_poly(_NDTRI_B, r) * r + 1.0)
    if np.any(low):
        q = np.sqrt(-2.0 * np.log(p[low]))
        x[low] = _poly(_NDTRI_C, q) / (_poly(_NDTRI_D, q) * q + 1.0)
    if np.any(high):
        q = np.sqrt(-2.0 * np.log1p(-p[high]))
        x[high] = -_poly(_NDTRI_C, q) / (_poly(_NDTRI_D, q) * q + 1.0)
    return x


def rank_normalize(x):
    """Rank-normalize samples along all axes jointly (Vehtari et al. 2021
    eq. 14), averaging ranks over ties."""
    x = np.asarray(x, np.float64)
    flat = x.reshape(-1)
    n = flat.size
    order = np.argsort(flat, kind="stable")
    sv = flat[order]
    new_group = np.empty(n, bool)
    new_group[0] = True
    new_group[1:] = sv[1:] != sv[:-1]
    gid = np.cumsum(new_group) - 1
    base = np.arange(1.0, n + 1.0)
    avg = (np.bincount(gid, weights=base) / np.bincount(gid))[gid]
    ranks = np.empty(n, np.float64)
    ranks[order] = avg
    return inverse_normal_cdf(
        ((ranks - 0.375) / (n + 0.25)).reshape(x.shape))


def split_rhat_rank_normalized(chain):
    """Rank-normalized split-R-hat (Vehtari et al. 2021): max of the bulk
    and folded-tail statistics per dimension."""
    chain = np.asarray(chain, np.float64)
    ndim = chain.shape[2]
    bulk = np.empty(ndim)
    tail = np.empty(ndim)
    for d in range(ndim):
        x = chain[:, :, d]
        bulk[d] = split_rhat(rank_normalize(x)[:, :, None])[0]
        folded = np.abs(x - np.median(x))
        tail[d] = split_rhat(rank_normalize(folded)[:, :, None])[0]
    return np.maximum(bulk, tail)


def effective_sample_size(chain, kind="bulk", c=5.0):
    """Per-dimension ESS of the ensemble chain (nsteps, nwalkers, ndim):
    kind="bulk" on the rank-normalized samples, kind="tail" the minimum over
    the 5% and 95% indicator functions. A frozen series reports NaN."""
    chain = np.asarray(chain, np.float64)
    nsteps, nwalkers, ndim = chain.shape
    total = nsteps * nwalkers

    def _ess_of(x):
        tau = autocorrelation_time(x, c=c)   # NaN where variance = 0
        return np.where(np.isfinite(tau),
                        total / np.maximum(np.nan_to_num(tau, nan=1.0),
                                           1.0), np.nan)

    if kind == "bulk":
        z = np.stack([rank_normalize(chain[:, :, d])
                      for d in range(ndim)], axis=2)
        return _ess_of(z)
    if kind == "tail":
        out = np.full(ndim, np.inf)
        for q in (0.05, 0.95):
            quant = np.quantile(chain.reshape(-1, ndim), q, axis=0)
            ind = (chain <= quant[None, None, :]).astype(np.float64)
            out = np.minimum(out, _ess_of(ind))
        return out
    raise ValueError(f"kind must be 'bulk' or 'tail', got {kind!r}")


def autocorrelation_time(chain, c=5.0):
    """Integrated autocorrelation time per dimension, emcee-style (Sokal's
    adaptive window); chain (nsteps, nwalkers, ndim) host numpy."""
    x = np.asarray(chain, dtype=np.float64)
    nsteps, nwalkers, ndim = x.shape
    taus = np.empty(ndim)
    for d in range(ndim):
        xd = x[:, :, d] - x[:, :, d].mean(axis=0, keepdims=True)
        nfft = 1
        while nfft < 2 * nsteps:
            nfft <<= 1
        f = np.fft.rfft(xd, n=nfft, axis=0)
        acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:nsteps].real
        acf = acf.mean(axis=1)
        if acf[0] <= 0:
            taus[d] = np.nan
            continue
        rho = acf / acf[0]
        tau_run = 2.0 * np.cumsum(rho) - 1.0
        window = np.arange(nsteps) < c * tau_run
        idx = np.argmin(window) if not window.all() else nsteps - 1
        taus[d] = tau_run[idx]
    return taus
