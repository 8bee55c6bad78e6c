"""Nested sampling: the Bayesian evidence ln Z for model comparison.

Torch twin of mbb_emcee_tpu/nested.py. Upstream mbb_emcee offers no way to
compare the model variants it fits (optically thin against thick, with or
without the Wien-side power law); the evidence Z = int L(theta) pi(theta)
dtheta of each variant gives the Bayes factor between them.

Each iteration retires the worst B of N live points at once (removing the
k-th lowest while N - k points remain shrinks ln X by 1/(N - k) in
expectation) and evolves B copies of random survivors by K affine-invariant
stretch moves over the surviving ensemble, constrained to L > L*: for a
uniform target over {L > L*} the stretch move accepts with
min(1, z^(d-1)) 1[inside]. Every constrained step is one batched likelihood
call of B points -- on a CUDA device one launch of the lnprob kernel for a
single fit (fitter.compute_evidence) -- and the run loops over iterations
on the host with one sync per iteration for the stopping rule.

`nested_iteration_from_draws` is one iteration with its draws as tensors
(the JAX package's own draws in the cross-package tests); it takes an
optional leading source axis, and a source whose stopping rule has fired
is left exactly as it was, so a batch of sources reproduces each single
run bit for bit. The runs draw from the Philox stream of
ops/philox.nested_draws, counted by the global iteration, so a run on the
card is replayed by the plain likelihood on the same draws.

The evidence error is Skilling's sqrt(H / N). The weighted dead points are
posterior samples (importance weights exp(lnwt - lnZ)).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from mbb_emcee_tpu_torch.fitter import resolve_device
from mbb_emcee_tpu_torch.ops.philox import (
    BLOCK_ELEMS, nested_draws, nested_start, step_blocks)

# At most this many iterations of draws are made at once.
_DRAW_BLOCK_ITERS = 32


@dataclasses.dataclass
class NestedResult:
    """Evidence + weighted posterior samples from one nested run."""
    logz: float                 # ln Z (evidence w.r.t. the box prior)
    logz_err: float             # sqrt(H / nlive)
    h: float                    # information (nats)
    samples: np.ndarray         # (ndead, ndim) dead points, box space
    loglike: np.ndarray         # (ndead,)
    logwt: np.ndarray           # (ndead,) ln(prior mass x L); sums to ~Z
    n_iter: int                 # batch iterations used
    n_like: int                 # likelihood evaluations
    # False iff the run hit max_iter before the termination bound fired:
    # logz is then truncated (biased low).
    converged: bool = True

    def posterior_weights(self):
        """Normalized importance weights over `samples`."""
        w = np.exp(self.logwt - self.logz)
        return w / w.sum()

    def posterior_mean(self):
        w = self.posterior_weights()
        return (w[:, None] * self.samples).sum(axis=0)

    def resample(self, nsamples, seed=0):
        """Equal-weight posterior draws (multinomial resampling)."""
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.samples.shape[0], size=nsamples,
                         p=self.posterior_weights())
        return self.samples[idx]


@dataclasses.dataclass
class NestedBatchResult:
    """Per-source evidences from one batched nested run over S sources.

    Arrays are padded to the slowest source's iteration count; padded
    dead-point slots carry -inf log-weights (zero posterior weight), so
    summaries need no masking. Index with [s] for a per-source
    NestedResult (trimmed to that source's own dead points)."""
    logz: np.ndarray            # (S,)
    logz_err: np.ndarray        # (S,)
    h: np.ndarray               # (S,)
    samples: np.ndarray         # (S, ndead_max + nlive, ndim)
    loglike: np.ndarray         # (S, ndead_max + nlive)
    logwt: np.ndarray           # (S, ndead_max + nlive)
    n_iter: np.ndarray          # (S,)
    n_like: np.ndarray          # (S,)
    nbatch: int
    nlive: int
    # (S,) bool; False = that source hit max_iter (truncated logz)
    converged: np.ndarray | None = None

    @property
    def nsources(self):
        return self.logz.shape[0]

    def __getitem__(self, s):
        s = int(s)
        ndead = int(self.n_iter[s]) * self.nbatch
        keep = np.concatenate([np.arange(ndead),
                               np.arange(self.samples.shape[1] - self.nlive,
                                         self.samples.shape[1])])
        return NestedResult(
            logz=float(self.logz[s]), logz_err=float(self.logz_err[s]),
            h=float(self.h[s]), samples=self.samples[s][keep],
            loglike=self.loglike[s][keep], logwt=self.logwt[s][keep],
            n_iter=int(self.n_iter[s]), n_like=int(self.n_like[s]),
            converged=(True if self.converged is None
                       else bool(self.converged[s])))

    def posterior_weights(self):
        """(S, n) normalized importance weights (padded slots are 0)."""
        w = np.exp(self.logwt - self.logz[:, None])
        return w / w.sum(axis=1, keepdims=True)

    def posterior_mean(self):
        w = self.posterior_weights()
        return (w[:, :, None] * self.samples).sum(axis=1)


@dataclasses.dataclass
class NestedState:
    """A nested run between iterations, with an optional leading source
    axis S: `it` ([S]) iterations done, `done` ([S]) the stopping rule,
    `live` ([S,] nlive, d) and `lnl` ([S,] nlive) the live points, `lnx`
    and `lnz` ([S]) ln of the prior mass left and the evidence so far."""
    it: torch.Tensor
    done: torch.Tensor
    live: torch.Tensor
    lnl: torch.Tensor
    lnx: torch.Tensor
    lnz: torch.Tensor


def init_nested_state(live, lnl):
    """The state before iteration 0 from the start points and their
    log-likelihoods (([S,] nlive, d), ([S,] nlive))."""
    lead = tuple(lnl.shape[:-1])
    dev = lnl.device
    return NestedState(
        it=torch.zeros(lead, dtype=torch.int64, device=dev),
        done=torch.zeros(lead, dtype=torch.bool, device=dev),
        live=live, lnl=lnl,
        lnx=torch.zeros(lead, dtype=lnl.dtype, device=dev),
        lnz=torch.full(lead, -torch.inf, dtype=lnl.dtype, device=dev))


def _shrinkage(nlive, nbatch, dtype, device):
    """(ln of the B batch weights relative to the batch-entry ln X, the ln X
    shrinkage of one iteration): the deterministic expected shrinkage of
    the k-th removal while N - k points remain, a host fp64 table."""
    shr = np.cumsum(1.0 / (nlive - np.arange(nbatch)))
    xk = np.exp(-np.concatenate([[0.0], shr]))
    return (torch.as_tensor(np.log(xk[:-1] - xk[1:]), dtype=dtype,
                            device=device),
            float(np.float32(-shr[-1])))


def _take(x, idx):
    """x (S, n[, d]) gathered at idx (S, m) along the point axis."""
    if x.dim() == 3:
        return torch.take_along_dim(x, idx[..., None], dim=1)
    return torch.take_along_dim(x, idx, dim=1)


def nested_iteration_from_draws(state: NestedState, lnprob_batch, draws,
                                a=2.0, logtol=float(np.log(1e-4))):
    """One nested-sampling iteration on its draws: retire the worst B live
    points into the dead buffers, add their weights to ln Z, replace them
    by K constrained stretch moves of B survivor copies over the survivor
    ensemble, shrink ln X and apply the stopping rule.

    `draws` = (seed (B,), partner (K, B) int64 indices into the survivors,
    uz, ua (K, B) uniforms for z and for accept), each with the state's
    leading source axis if it has one. `lnprob_batch` maps the proposals
    (B, d) -> (B,), or (S, B, d) -> (S, B), in the live points' space
    (the unit cube in nested_sample). A source whose `done` is set is left
    exactly as it was. Returns (new state, (dead_x ([S,] B, d), dead_l,
    dead_w ([S,] B))), the dead entries of a finished source at their
    empty values (0 and -inf)."""
    batched = state.live.dim() == 3
    if not batched:
        state = NestedState(*(getattr(state, f.name)[None] for f in
                              dataclasses.fields(NestedState)))
        draws = tuple(d[None] for d in draws)
        f = lnprob_batch

        def lnprob_batch(y):
            return f(y[0])[None]
    seed, partner, uz, ua = draws
    live, lnl = state.live, state.lnl
    S, nlive, d = live.shape
    nbatch, nsteps = seed.shape[-1], partner.shape[-2]
    dtype, dev = lnl.dtype, lnl.device
    lnw_rel, lnshrink = _shrinkage(nlive, nbatch, dtype, dev)
    inv_a, am1 = 1.0 / a, a - 1.0
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=dev)

    order = torch.argsort(lnl, dim=-1, stable=True)      # ascending
    worst = order[:, :nbatch]
    lstar = _take(lnl, order[:, nbatch - 1:nbatch])     # (S, 1)
    lnw = state.lnx[:, None] + lnw_rel                  # (S, B)
    dead_x, dead_l = _take(live, worst), _take(lnl, worst)
    lnz = torch.logaddexp(state.lnz, torch.logsumexp(lnw + dead_l, dim=-1))

    # replace: B copies of random survivors, K constrained stretch moves
    surv_idx = order[:, nbatch:]
    surv, lsurv = _take(live, surv_idx), _take(lnl, surv_idx)
    x, fx = _take(surv, seed), _take(lsurv, seed)
    for k in range(nsteps):
        p = _take(surv, partner[:, k])
        z = inv_a * (1.0 + uz[:, k] * am1) ** 2
        y = p + z[..., None] * (x - p)
        inbox = torch.all((y >= 0.0) & (y <= 1.0), dim=-1)
        fy = torch.where(inbox, lnprob_batch(y), neg_inf)
        accept = (inbox & (fy > lstar)
                  & (torch.log(ua[:, k]) < (d - 1) * torch.log(z)))
        x = torch.where(accept[..., None], y, x)
        fx = torch.where(accept, fy, fx)
    new_live = live.scatter(1, worst[..., None].expand(S, nbatch, d), x)
    new_lnl = lnl.scatter(1, worst, fx)
    lnx = state.lnx + lnshrink
    # stop when the best live point can no longer move ln Z by tol
    done = (torch.amax(new_lnl, dim=-1) + lnx) < (lnz + logtol)

    old = state.done
    new = NestedState(
        it=torch.where(old, state.it, state.it + 1),
        done=old | done,
        live=torch.where(old[:, None, None], live, new_live),
        lnl=torch.where(old[:, None], lnl, new_lnl),
        lnx=torch.where(old, state.lnx, lnx),
        lnz=torch.where(old, state.lnz, lnz))
    dead = (torch.where(old[:, None, None], torch.zeros_like(dead_x), dead_x),
            torch.where(old[:, None], neg_inf, dead_l),
            torch.where(old[:, None], neg_inf, lnw))
    if not batched:
        new = NestedState(*(getattr(new, f.name)[0] for f in
                            dataclasses.fields(NestedState)))
        dead = tuple(t[0] for t in dead)
    return new, dead


def _check_box(lower, upper, nlive, nbatch):
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    if not (np.all(np.isfinite(lower)) and np.all(np.isfinite(upper))):
        raise ValueError("nested sampling requires a finite prior box")
    if nbatch >= nlive:
        raise ValueError(f"nbatch={nbatch} must be < nlive={nlive}")
    return lower, upper


def _nested_loop(state, ll_unit, seed, sources, nlive, nbatch, nsteps,
                 max_iter, a, tol):
    """Run iterations from `state` (leading source axis S) until every
    source is done or max_iter, drawing iteration t's draws for `sources`
    at Philox counter t. Returns (state, dead_x (S, it_max * B, d), dead_l,
    dead_w)."""
    S, _, d = state.live.shape
    dev = state.live.device
    nsurv = nlive - nbatch
    logtol = float(np.log(tol))
    lanes = max(S * nsteps * nbatch, BLOCK_ELEMS // _DRAW_BLOCK_ITERS)
    blocks = step_blocks(
        lambda t0, n: nested_draws(seed, t0, n, nbatch, nsteps, nsurv, dev,
                                   source=sources), 0, int(max_iter), lanes)
    dx, dl, dw = [], [], []
    for _ in range(int(max_iter)):
        if bool(state.done.all()):
            break
        state, (x, l_, w) = nested_iteration_from_draws(
            state, ll_unit, next(blocks), a, logtol)
        dx.append(x)
        dl.append(l_)
        dw.append(w)
    if not dx:
        return (state, state.live.new_zeros((S, 0, d)),
                state.lnl.new_zeros((S, 0)), state.lnl.new_zeros((S, 0)))
    return (state, torch.cat(dx, dim=1), torch.cat(dl, dim=1),
            torch.cat(dw, dim=1))


def _close_out(state, nlive):
    """Surviving live points get equal shares of the final X: (ln Z with
    them, their ln weights ([S,] nlive))."""
    live_w = state.lnx - float(np.float32(np.log(float(nlive))))
    lnz = torch.logaddexp(
        state.lnz, torch.logsumexp(live_w[:, None] + state.lnl, dim=-1))
    return lnz, live_w[:, None].expand_as(state.lnl)


def _summaries(xs, ls, ws, logz, nlive):
    """(lnwt, H, logz_err) of padded (S, n) dead + live sets, host fp64."""
    lw = ws + ls
    p = np.exp(lw - logz[:, None])
    p = p / p.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.nansum(p * (ls - logz[:, None]), axis=1)
    return lw, h, np.sqrt(np.maximum(h, 0.0) / nlive)


def _run(ll_box, lower, upper, seed, sources, nlive, nbatch, nsteps,
         max_iter, a, tol, device, data):
    """The start and the loop for S sources (`sources` a 1-D tensor):
    host fp64 arrays (it, done, lnz, xs, ls, ws) with xs in box space."""
    lo = torch.as_tensor(np.asarray(lower, np.float32), device=device)
    wd = torch.as_tensor(np.asarray(upper - lower, np.float32),
                         device=device)

    def ll_unit(u):
        return ll_box(lo + wd * u, *data)

    u0 = nested_start(seed, nlive, lower.size, device, source=sources)
    state = init_nested_state(u0, ll_unit(u0))
    state, dead_x, dead_l, dead_w = _nested_loop(
        state, ll_unit, seed, sources, nlive, nbatch, nsteps, max_iter, a,
        tol)
    lnz, live_w = _close_out(state, nlive)
    ndead = int(state.it.max()) * nbatch

    def host(*ts):
        return np.concatenate([t.cpu().numpy() for t in ts], axis=1)

    xs = host(dead_x[:, :ndead], state.live).astype(np.float64)
    ls = host(dead_l[:, :ndead], state.lnl).astype(np.float64)
    ws = host(dead_w[:, :ndead], live_w).astype(np.float64)
    return (state.it.cpu().numpy().astype(np.int64),
            state.done.cpu().numpy().astype(bool),
            lnz.cpu().numpy().astype(np.float64),
            lower + (upper - lower) * xs, ls, ws)


def nested_sample(lnprob_batch, lower, upper, seed, nlive=512, nbatch=32,
                  nsteps=32, max_iter=3000, a=2.0, tol=1e-4, device=None,
                  source=0) -> NestedResult:
    """The evidence of `lnprob_batch` against a uniform prior over the
    finite box [lower, upper].

    lnprob_batch maps (n, d) fp32 points in BOX space on `device` to (n,)
    log-likelihoods (on a CUDA device the lnprob kernel, for a fit).
    `seed` is the 64-bit Philox key of the run's draws and `source` the
    stream's source index (a batch run's source s equals the single run
    with source=s on the same data). device: "cuda" (the default; raises
    without a card) or "cpu". The evidence is w.r.t. the normalized uniform
    box prior (the 1/V factor is included by sampling in the unit cube).
    Returns a NestedResult; converged=False (with a warning) when the run
    hit max_iter before the termination bound fired."""
    lower, upper = _check_box(lower, upper, nlive, nbatch)
    device = resolve_device(device)
    sources = torch.tensor([int(source)], device=device)

    def ll(x):
        return lnprob_batch(x[0])[None]

    it, done, lnz, xs, ls, ws = _run(
        ll, lower, upper, int(seed), sources, int(nlive), int(nbatch),
        int(nsteps), int(max_iter), float(a), float(tol), device, ())
    converged = bool(done[0])
    if not converged:
        warnings.warn(
            f"nested sampling hit max_iter={max_iter} before the "
            f"termination bound (tol={tol}) fired: logz is truncated "
            "(biased low). Raise max_iter or loosen tol; the result "
            "carries converged=False.", UserWarning, stacklevel=2)
    lw, h, err = _summaries(xs, ls, ws, lnz, nlive)
    n = int(it[0])
    return NestedResult(
        logz=float(lnz[0]), logz_err=float(err[0]), h=float(h[0]),
        samples=xs[0], loglike=ls[0], logwt=lw[0], n_iter=n,
        n_like=int(nlive) + n * int(nbatch) * int(nsteps),
        converged=converged)


def _join_runs(parts, nlive, lower):
    """_run's results of consecutive source blocks as one batch's: the dead
    sets padded to the longest block's, as an unsharded run pads a source
    that finished early (x at the box's lower corner, -inf lnL and
    weight), the live points after them."""
    if len(parts) == 1:
        return parts[0]
    ndead = max(p[3].shape[1] for p in parts) - nlive

    def pad(a, fill):
        k = ndead + nlive - a.shape[1]
        gap = np.broadcast_to(fill, (a.shape[0], k) + a.shape[2:])
        return np.concatenate([a[:, :-nlive], gap, a[:, -nlive:]], axis=1)

    fills = (lower, -np.inf, -np.inf)
    return tuple(
        np.concatenate([p[i] for p in parts]) if i < 3 else
        np.concatenate([pad(p[i], fills[i - 3]) for p in parts])
        for i in range(6))


def make_nested_batch_runner(lnprob_batch, lower, upper, nlive=512,
                             nbatch=32, nsteps=32, max_iter=3000, a=2.0,
                             tol=1e-4, device=None, mesh=None):
    """Batched nested-sampling runner: returns ``run_batch(seed, data) ->
    NestedBatchResult`` for S-source data tuples. `lnprob_batch(theta
    (S, n, d), *data) -> (S, n)` in box space, `data` a non-empty tuple of
    tensors with leading source axis S on `device`. Source s draws the
    Philox stream of source index s under `seed`.

    With `mesh` (a parallel.walker_mesh; `device` is then its first) the
    sources split into mesh.size contiguous blocks, each run on its shard's
    device with its global source indices, and the results join in source
    order: every source's result is the unsharded run's. `lnprob_batch` is
    then one function that runs on every device of the mesh, or a sequence
    of them, one per shard, each bound to its shard's device."""
    lower, upper = _check_box(lower, upper, nlive, nbatch)
    if mesh is not None:
        from mbb_emcee_tpu_torch.parallel.mesh import mesh_blocks, mesh_device
        device = mesh_device(mesh, device)
        fns = ([lnprob_batch] * mesh.size if callable(lnprob_batch)
               else list(lnprob_batch))
        if len(fns) != mesh.size:
            raise ValueError(f"need one lnprob_batch per shard ({mesh.size})"
                             f"; got {len(fns)}")
    device = resolve_device(device)

    def run_block(fn, seed, sources, dev, data):
        return _run(fn, lower, upper, int(seed), sources, int(nlive),
                    int(nbatch), int(nsteps), int(max_iter), float(a),
                    float(tol), dev, data)

    def run_batch(seed, data):
        data = tuple(data)
        if not data:
            raise ValueError(
                "data must be a non-empty tuple of (S, ...) arrays")
        data = tuple(torch.as_tensor(t, device=device) for t in data)
        S = data[0].shape[0]
        if mesh is None:
            parts = [run_block(lnprob_batch, seed, torch.arange(
                S, device=device), device, data)]
        else:
            # each block's run is launched after the previous one ended:
            # _run waits on its device once per iteration
            parts = [run_block(fn, seed, torch.arange(lo, hi, device=dev),
                               dev, tuple(t[lo:hi].to(dev) for t in data))
                     for fn, (lo, hi, dev) in zip(fns, mesh_blocks(mesh, S))]
        it, done, lnz, xs, ls, ws = _join_runs(parts, int(nlive), lower)
        if not done.all():
            bad = int((~done).sum())
            warnings.warn(
                f"{bad}/{done.size} sources hit max_iter={max_iter} "
                f"before the termination bound (tol={tol}) fired: their "
                "logz is truncated (biased low); see result.converged.",
                UserWarning, stacklevel=2)
        lw, h, err = _summaries(xs, ls, ws, lnz, nlive)
        return NestedBatchResult(
            logz=lnz, logz_err=err, h=h, samples=xs, loglike=ls, logwt=lw,
            n_iter=it, n_like=int(nlive) + it * int(nbatch) * int(nsteps),
            nbatch=int(nbatch), nlive=int(nlive), converged=done)

    return run_batch


def nested_sample_batch(lnprob_batch, lower, upper, seed, data, nlive=512,
                        nbatch=32, nsteps=32, max_iter=3000, a=2.0,
                        tol=1e-4, device=None) -> NestedBatchResult:
    """Evidence for S independent sources sharing one likelihood form,
    `lnprob_batch(theta (S, n, d), *data) -> (S, n)` with `data` a tuple
    of (S, ...) tensors (per-source flux and 1/sigma, say). The S runs
    advance in lockstep, every constrained step one (S, B) likelihood
    call, and each source freezes at its own termination iteration, so a
    batched run reproduces each single run exactly. The prior box is shared
    across sources. Returns NestedBatchResult with (S,) summaries and padded
    per-source sample sets."""
    return make_nested_batch_runner(
        lnprob_batch, lower, upper, nlive=nlive, nbatch=nbatch,
        nsteps=nsteps, max_iter=max_iter, a=a, tol=tol,
        device=device)(seed, data)
