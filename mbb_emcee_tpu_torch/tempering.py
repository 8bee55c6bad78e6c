"""Parallel tempering (replica exchange) over the ensemble sampler.

Torch twin of mbb_emcee_tpu/tempering.py. Upstream mbb_emcee runs one
emcee ensemble at temperature 1, which mixes poorly on the real
T-lambda0 bimodality of optically thick fits (DESIGN.md); here K
temperature rungs x W walkers advance together: each rung takes the
Goodman-Weare half-ensemble update of sampler.py with its inverse
temperature in the acceptance, then each adjacent rung pair of the step's
parity (even pairs one step, odd the next) proposes W independent swaps,
accepted with probability min(1, exp((b_i - b_j)(lnp_j - lnp_i))).

Every function takes leading batch axes in front of the rung axis, so the
batch tier (batchengine.run_pt) runs S sources' ladders in lockstep with
the same code: positions (..., K, W, d), betas (..., K). `lnprob_batch`
maps (..., n, d) to (...) -- the single fit's (n, d) -> (n,) (the lnprob
kernel on the card, its plain version on the CPU) or the batch tier's
(S, n, d) -> (S, n).

Randomness: the step's uniforms come from the Philox stream of
ops/philox.pt_uniforms, counted by the run's global step (PTState.step,
never reset), so a segmented or resumed run is the uninterrupted one bit
for bit and a run on the card is replayed by the plain likelihood on the
same draws. pt_step_from_uniforms takes the draws as tensors (the JAX
package's draws in the cross-package tests).

The tempered run yields the evidence two ways:

* STEPPING-STONE (headline, `logz`): ln Z = sum_k ln E_{beta_{k+1}}
  [exp((beta_k - beta_{k+1}) lnL)], each ratio estimated from the hotter
  rung's samples with a streaming log-sum-exp (ss_stream_update), robust
  on wide prior boxes where lnL reaches ~-1e18 at the corners.
* THERMODYNAMIC INTEGRATION (diagnostic, `logz_ti`): trapezoid of the
  per-rung <lnprob> over beta; the beta ~ 0 end can be unresolvable on
  wide priors -- compare against `logz` before trusting it.

Z is taken against the normalized uniform box prior times any Gaussian
prior factors, as the likelihood applies them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Support threshold: lnprob below this is "outside the box" (LNPROB_FLOOR is
# -1e30). The box indicator is enforced untempered: at beta = 0 the rung
# samples uniform-on-box, not uniform-on-everything (beta * FLOOR is 0
# there).
from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR as _SUPPORT_FLOOR
from mbb_emcee_tpu_torch.ops.philox import pt_uniforms, step_blocks


@dataclasses.dataclass
class PTState:
    """Tempered ensemble state. lnp is the untempered lnprob (tempering
    lives in the acceptance rules). `seed` is the run's Philox key and
    `step` the global step its next draws are counted at (never reset);
    `nsteps` counts steps since the last reset and sets the swap parity."""
    pos: torch.Tensor         # (..., K, W, d)
    lnp: torch.Tensor         # (..., K, W)
    naccept: torch.Tensor     # (..., K, W) int32 move acceptances
    nswap: torch.Tensor       # (..., K-1) int32 accepted swaps per pair
    nswap_prop: torch.Tensor  # (..., K-1) int32 proposed swaps per pair
    nsteps: int
    seed: int
    step: int = 0


def auto_ladder_batch(worst_lnl, nrungs_min=12, nrungs_max=48, target=3.0):
    """Batched auto_ladder: per-source geometric ladders (S, K) sharing
    ONE rung count K -- the largest any source needs -- so a whole batch of
    tempered fits stays one fixed shape while each source gets a beta_min
    matched to ITS likelihood scale."""
    worst = np.clip(np.abs(np.asarray(worst_lnl, np.float64)),
                    1.0, 1e25).ravel()
    beta_min = np.minimum(1e-2, target / worst)          # (S,)
    decades = np.log10(1.0 / beta_min)
    nrungs = int(np.clip(2 + np.ceil(2.0 * decades.max()),
                         nrungs_min, nrungs_max))
    expo = np.linspace(0.0, 1.0, nrungs - 1)[None, :]    # 1 -> beta_min
    b = np.power(beta_min[:, None], expo)                # (S, K-1)
    return np.concatenate([b, np.zeros((b.shape[0], 1))], axis=1)


class SSStats(NamedTuple):
    """Streaming stepping-stone accumulators per adjacent rung pair
    (K-1,): running max M of v = dbeta * lnL over the hotter rung's
    recorded samples, scaled sums S1 = sum exp(v - M) and
    S2 = sum exp(2(v - M)), and the sample count n."""
    m: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    n: float

    def merge(self, other):
        m = np.maximum(self.m, other.m)
        sa, sb = np.exp(self.m - m), np.exp(other.m - m)
        return SSStats(m, self.s1 * sa + other.s1 * sb,
                       self.s2 * sa ** 2 + other.s2 * sb ** 2,
                       self.n + other.n)

    def logz(self):
        """(lnZ, naive MC error): sum of per-pair log ratios over the
        LAST axis (so (K-1,) accumulators give scalars and batched
        (S, K-1) accumulators give per-source (S,) vectors); the error
        propagates each ratio's variance-of-the-mean in quadrature
        (walker/step autocorrelation not corrected -- treat as a lower
        bound)."""
        m1 = self.s1 / self.n
        ln_r = self.m + np.log(self.s1) - np.log(self.n)
        var_mean = np.maximum(self.s2 / self.n - m1 ** 2, 0.0) / self.n
        rel = np.sqrt(var_mean) / m1
        return ln_r.sum(axis=-1), np.sqrt(np.sum(rel ** 2, axis=-1))


def ss_stream_update(m, s1, s2, dbeta, lnp_hot):
    """One streaming-logsumexp update of the stepping-stone accumulators,
    fp32: v = dbeta * lnL over the HOTTER rung's walkers; (m, s1, s2) are
    the running per-pair max / sum(e) / sum(e^2) that SSStats consumes.
    Shapes: dbeta (..., K-1), lnp_hot (..., K-1, W), accumulators
    (..., K-1). Shared by the single fit and the batch tier."""
    v = dbeta[..., None] * lnp_hot.to(torch.float32)
    newm = torch.maximum(m, v.amax(dim=-1))
    scale = torch.where(torch.isfinite(m), torch.exp(m - newm),
                        torch.zeros_like(m))
    e = torch.exp(v - newm[..., None])
    s1 = s1 * scale + e.sum(dim=-1)
    s2 = s2 * scale ** 2 + (e * e).sum(dim=-1)
    return newm, s1, s2


@dataclasses.dataclass
class PTResult:
    """Cold-chain samples + evidence (stepping-stone headline, TI check)."""
    chain: torch.Tensor          # (nrec, W, d) cold (beta=1) rung
    lnprob: torch.Tensor         # (nrec, W)
    betas: np.ndarray            # (K,) descending, betas[0] = 1, betas[-1]=0
    acceptance_fraction: np.ndarray   # (K, W)
    swap_fraction: np.ndarray    # (K-1,) accepted/proposed per pair
    mean_lnp: np.ndarray         # (K,) production <lnprob> per rung
    logz: float                  # stepping-stone evidence (robust)
    logz_err: float              # its naive MC error
    logz_ti: float               # trapezoid of mean_lnp over beta (check)
    logz_ti_err: float           # half the |trap - left-Riemann| spread


def geometric_ladder(nrungs, beta_min=1e-3):
    """(K,) descending inverse temperatures: 1 -> beta_min geometrically,
    plus an exact beta = 0 rung (the uniform-box prior end the TI
    quadrature needs)."""
    if nrungs < 3:
        raise ValueError("nrungs must be >= 3 (cold, >=1 warm, beta=0)")
    b = np.geomspace(1.0, beta_min, nrungs - 1)
    return np.concatenate([b, [0.0]])


def auto_ladder(worst_lnl, nrungs_min=12, nrungs_max=48, target=3.0):
    """Ladder sized so the evidence path is resolvable: beta_min such
    that beta_min * |worst sampled lnL| ~= `target` (the hottest nonzero
    rung still overlaps the uniform-box rung), and enough rungs that each
    geometric stone spans ~half a decade of beta. A FIXED beta_min leaves
    the beta ~ 0 end of a wide prior box unbridgeable and the
    stepping-stone estimate biased low by thousands of nats."""
    worst = float(np.clip(abs(float(worst_lnl)), 1.0, 1e25))
    beta_min = float(min(1e-2, target / worst))
    decades = np.log10(1.0 / beta_min)
    nrungs = int(np.clip(2 + np.ceil(2.0 * decades),
                         nrungs_min, nrungs_max))
    return geometric_ladder(nrungs, beta_min)


def _check_betas(betas):
    betas = np.asarray(betas, np.float64)
    if betas[0] != 1.0 or np.any(np.diff(betas) >= 0):
        raise ValueError("betas must start at 1.0 and strictly decrease")
    if betas[-1] != 0.0:
        # The stepping-stone sum telescopes to ln Z(1) - ln Z(beta_min);
        # only a terminal beta = 0 rung makes the reference term vanish
        # (Z(0) = 1 for the normalized box prior), which is the contract
        # PTResult.logz documents. A ladder stopping above 0 would be
        # silently biased by ln Z(beta_min) -- many nats on wide priors.
        raise ValueError(
            "betas must end at exactly 0.0 (the uniform-box prior rung "
            "the evidence is measured against); append a 0 rung or use "
            "geometric_ladder()/auto_ladder()")
    return betas


def _flat_lnprob(lnprob_batch, x):
    """lnprob of (..., K, n, d) positions as one (..., K * n, d) batch."""
    lead, (K, n, d) = x.shape[:-3], x.shape[-3:]
    return lnprob_batch(x.reshape(lead + (K * n, d))).reshape(lead + (K, n))


def _tempered_half(u3, active, passive, lnp_active, lnprob_batch, betas, a):
    """Per-rung stretch half-step with tempered acceptance. Shapes:
    u3 (..., 3, K, n), active/passive (..., K, n, d), lnp_active (..., K, n),
    betas (..., K). beta * lnp is the tempered log-density; the z^(d-1)
    factor is temperature-independent."""
    ndim = active.shape[-1]
    npass = passive.shape[-2]
    z = ((a - 1.0) * u3[..., 0, :, :] + 1.0) ** 2 / a    # (..., K, n)
    j = torch.clamp((u3[..., 1, :, :] * npass).to(torch.int64),
                    max=npass - 1)
    partners = torch.take_along_dim(passive, j[..., None], dim=-2)
    proposal = partners + z[..., None] * (active - partners)
    lnp_prop = _flat_lnprob(lnprob_batch, proposal)
    log_ratio = ((ndim - 1) * torch.log(z)
                 + betas[..., None] * (lnp_prop - lnp_active))
    accept = ((torch.log(u3[..., 2, :, :]) < log_ratio)
              & (lnp_prop > _SUPPORT_FLOOR))
    new_active = torch.where(accept[..., None], proposal, active)
    new_lnp = torch.where(accept, lnp_prop, lnp_active)
    return new_active, new_lnp, accept


def _swap(pos, lnp, betas, us, swap_parity):
    """Replica exchange between rungs (i, i+1) with i of the step's parity:
    all W walkers of each active pair propose independent swaps. Returns
    (pos, lnp, accepted (..., K-1, W), pair_on (K-1,))."""
    K = pos.shape[-3]
    dbeta = betas[..., :-1] - betas[..., 1:]                 # (..., K-1)
    dlnp = lnp[..., 1:, :] - lnp[..., :-1, :]                # (..., K-1, W)
    pair_on = (torch.arange(K - 1, device=pos.device) % 2) == (
        swap_parity % 2)
    accept = (torch.log(us) < dbeta[..., None] * dlnp) & pair_on[:, None]
    # only non-overlapping pairs are active, so a rung takes part in at
    # most one exchange: rung i takes from i+1 (up), rung i+1 from i (down)
    off = torch.zeros_like(accept[..., :1, :])
    take_up = torch.cat([accept, off], dim=-2)
    take_dn = torch.cat([off, accept], dim=-2)
    pos_up = torch.cat([pos[..., 1:, :, :], pos[..., -1:, :, :]], dim=-3)
    pos_dn = torch.cat([pos[..., :1, :, :], pos[..., :-1, :, :]], dim=-3)
    lnp_up = torch.cat([lnp[..., 1:, :], lnp[..., -1:, :]], dim=-2)
    lnp_dn = torch.cat([lnp[..., :1, :], lnp[..., :-1, :]], dim=-2)
    pos = torch.where(take_up[..., None], pos_up,
                      torch.where(take_dn[..., None], pos_dn, pos))
    lnp = torch.where(take_up, lnp_up, torch.where(take_dn, lnp_dn, lnp))
    return pos, lnp, accept, pair_on


def pt_step_from_uniforms(state: PTState, lnprob_batch, betas, u, us,
                          a=2.0, swap_parity=None) -> PTState:
    """One tempered ensemble update (both half-ensembles across all rungs)
    followed by one replica-exchange phase over the adjacent rung pairs of
    `swap_parity` (default: state.nsteps), consuming the move uniforms u
    (..., 3, K, W) and the swap uniforms us (..., K-1, W)."""
    W = state.pos.shape[-2]
    half = W // 2
    pos_a, lnp_a, acc_a = _tempered_half(
        u[..., :half], state.pos[..., :half, :], state.pos[..., half:, :],
        state.lnp[..., :half], lnprob_batch, betas, a)
    pos_b, lnp_b, acc_b = _tempered_half(
        u[..., half:], state.pos[..., half:, :], pos_a,
        state.lnp[..., half:], lnprob_batch, betas, a)
    pos = torch.cat([pos_a, pos_b], dim=-2)
    lnp = torch.cat([lnp_a, lnp_b], dim=-1)
    naccept = state.naccept + torch.cat([acc_a, acc_b], dim=-1).to(
        torch.int32)
    parity = state.nsteps if swap_parity is None else int(swap_parity)
    pos, lnp, acc_s, pair_on = _swap(pos, lnp, betas, us, parity)
    return PTState(
        pos=pos, lnp=lnp, naccept=naccept,
        nswap=state.nswap + acc_s.sum(dim=-1).to(torch.int32),
        nswap_prop=state.nswap_prop + pair_on.to(torch.int32) * W,
        nsteps=state.nsteps + 1, seed=state.seed, step=state.step + 1)


def _draws(state, nsteps, source):
    """Each of the next `nsteps` steps' (u, us) from the run's stream."""
    K, W = state.pos.shape[-3:-1]
    dev = state.pos.device
    return step_blocks(
        lambda s0, n: pt_uniforms(state.seed, s0, n, K, W, dev, source),
        state.step, nsteps, K * W * max(int(torch.as_tensor(source).numel()),
                                        1))


def pt_step(state: PTState, lnprob_batch, betas, a=2.0, swap_parity=None,
            source=0) -> PTState:
    """pt_step_from_uniforms on the run's own draws at state.step
    (`source`: an index, or the S indices of a batch's leading axis)."""
    u, us = next(_draws(state, 1, source))
    return pt_step_from_uniforms(state, lnprob_batch, betas, u, us, a,
                                 swap_parity)


def init_pt_state(p0, lnprob_batch, seed, step=0) -> PTState:
    """PTState at positions p0 (..., K, W, d), every rung populated."""
    K, W = p0.shape[-3:-1]
    lead = p0.shape[:-3]
    dev = p0.device
    return PTState(
        pos=p0, lnp=_flat_lnprob(lnprob_batch, p0),
        naccept=torch.zeros(lead + (K, W), dtype=torch.int32, device=dev),
        nswap=torch.zeros(lead + (K - 1,), dtype=torch.int32, device=dev),
        nswap_prop=torch.zeros(lead + (K - 1,), dtype=torch.int32,
                               device=dev),
        nsteps=0, seed=int(seed), step=int(step))


def reset_counters(state: PTState) -> PTState:
    """Zero the move, swap and step counters; the stream position stays."""
    return dataclasses.replace(
        state, naccept=torch.zeros_like(state.naccept),
        nswap=torch.zeros_like(state.nswap),
        nswap_prop=torch.zeros_like(state.nswap_prop), nsteps=0)


def pt_advance(state, lnprob_batch, betas, nsteps, a=2.0, source=0):
    """`nsteps` tempered steps without recording (burn-in)."""
    for u, us in _draws(state, int(nsteps), source):
        state = pt_step_from_uniforms(state, lnprob_batch, betas, u, us, a)
    return state


def pt_segment(state, lnprob_batch, betas, nrec, thin=1, a=2.0, source=0):
    """`nrec` records of `thin` tempered steps, recording the cold rung and
    accumulating the per-rung <lnprob> and the stepping-stone sums (fp32 on
    the device, ss_stream_update) after each record. Returns (state, chain
    (..., nrec, W, d), lnpchain (..., nrec, W), per-rung lnprob sums
    (..., K) host fp64, SSStats of the segment (host fp64, n = nrec * W)).
    Segments merge with SSStats.merge: the batch tier's checkpointed
    production is a sequence of them."""
    K, W, d = state.pos.shape[-3:]
    lead = state.pos.shape[:-3]
    dev = state.pos.device
    dbeta = (betas[..., :-1] - betas[..., 1:]).to(torch.float32)
    m = torch.full(lead + (K - 1,), -torch.inf, dtype=torch.float32,
                   device=dev)
    s1 = torch.zeros(lead + (K - 1,), dtype=torch.float32, device=dev)
    s2 = torch.zeros_like(s1)
    lnp_sum = torch.zeros(lead + (K,), dtype=torch.float32, device=dev)
    chain = torch.empty(lead + (nrec, W, d), dtype=state.pos.dtype,
                        device=dev)
    lnpch = torch.empty(lead + (nrec, W), dtype=state.lnp.dtype, device=dev)
    draws = _draws(state, int(nrec) * int(thin), source)
    for r in range(int(nrec)):
        for _ in range(int(thin)):
            u, us = next(draws)
            state = pt_step_from_uniforms(state, lnprob_batch, betas, u, us,
                                          a)
        chain[..., r, :, :] = state.pos[..., 0, :, :]
        lnpch[..., r, :] = state.lnp[..., 0, :]
        lnp_sum = lnp_sum + state.lnp.mean(dim=-1).to(torch.float32)
        m, s1, s2 = ss_stream_update(m, s1, s2, dbeta, state.lnp[..., 1:, :])
    host = [t.double().cpu().numpy() for t in (lnp_sum, m, s1, s2)]
    return (state, chain, lnpch, host[0],
            SSStats(host[1], host[2], host[3], float(nrec * W)))


class ParallelTemperingSampler:
    """The tempered run over one ladder: K rungs x `nwalkers` walkers in
    `ndim` free parameters, `lnprob_batch` a batched callable (n, ndim) ->
    (n,)."""

    def __init__(self, nwalkers, ndim, lnprob_batch, betas, a=2.0):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        betas = _check_betas(betas)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.nrungs = betas.size
        self.betas = betas
        self.a = float(a)
        self.lnprob_batch = lnprob_batch

    def init_state(self, p0, seed, step=0) -> PTState:
        """p0: (K, W, d) initial positions, every rung populated."""
        if tuple(p0.shape) != (self.nrungs, self.nwalkers, self.ndim):
            raise ValueError(
                f"p0 shape {tuple(p0.shape)} != "
                f"({self.nrungs},{self.nwalkers},{self.ndim})")
        return init_pt_state(p0.to(torch.float32).contiguous(),
                             self.lnprob_batch, seed, step)

    reset_counters = staticmethod(reset_counters)

    def set_betas(self, betas):
        """Swap the temperature ladder; the rung count must match (for a
        different K build a new sampler)."""
        betas = np.asarray(betas, np.float64)
        if betas.size != self.nrungs:
            raise ValueError(
                f"betas size {betas.size} != nrungs {self.nrungs}")
        self.betas = _check_betas(betas)

    def _betas_dev(self, device):
        return torch.as_tensor(self.betas, dtype=torch.float32, device=device)

    def run_mcmc(self, state: PTState, nsteps, thin=1):
        """Advance `nsteps` tempered updates recording every `thin`-th cold
        state; returns (state, chain, lnpchain, (lnp_mean_per_rung,
        SSStats))."""
        if nsteps % thin:
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        if nsteps <= 0:
            raise ValueError("nsteps must be positive")
        nrec = nsteps // thin
        state, chain, lnp, lnp_sum, ss = pt_segment(
            state, self.lnprob_batch, self._betas_dev(state.pos.device),
            nrec, thin, self.a)
        return state, chain, lnp, (lnp_sum / nrec, ss)

    def advance(self, state: PTState, nsteps):
        return pt_advance(state, self.lnprob_batch,
                          self._betas_dev(state.pos.device), nsteps, self.a)


def thermodynamic_logz(betas, mean_lnp):
    """Trapezoid of E_beta[lnprob] d(beta) over the descending ladder
    (last axis; batched leading axes broadcast, so (S, K) inputs give
    per-source (S,) results). Error proxy: |trapezoid - left-Riemann|
    / 2 per interval, summed -- a discretization-scale bound, not an
    MC error."""
    b = np.asarray(betas, np.float64)[..., ::-1]     # ascending 0 -> 1
    m = np.asarray(mean_lnp, np.float64)[..., ::-1]
    db = np.diff(b, axis=-1)
    per_trap = 0.5 * (m[..., 1:] + m[..., :-1]) * db
    trap = np.sum(per_trap, axis=-1)
    # Sum of PER-INTERVAL |trap - left| (as documented): summing first and
    # differencing lets opposite-signed interval errors cancel.
    err = np.sum(np.abs(per_trap - m[..., :-1] * db), axis=-1) / 2.0
    return trap, err


def nearest_rungs(new_betas, old_betas):
    """Index of the old rung nearest each new rung in log10(beta) (a
    rung at beta = 0 counts as 1e-30): the seed of a rebuilt ladder."""
    lb_new = np.log10(np.maximum(new_betas, 1e-30))
    lb_old = np.log10(np.maximum(old_betas, 1e-30))
    return np.abs(lb_new[..., :, None] - lb_old[..., None, :]).argmin(-1)


def pt_sample(lnprob_batch, p0, seed, betas=None, nrungs=12, beta_min="auto",
              nburn=200, nsteps=1000, thin=1, a=2.0) -> PTResult:
    """Temper the batched `lnprob_batch` ((n, d) -> (n,), free space) over
    a geometric ladder, burn, then sample. p0: (W, d) cold-start positions
    (a tensor on the device to run on) replicated to every rung (hot rungs
    disperse during burn-in); `seed` the Philox key of the run.

    beta_min="auto" (default) sizes the ladder from the data in two phases:
    burn on a scouting ladder, read the worst lnL the hot rungs visit,
    rebuild via auto_ladder() so the beta ~ 0 end of the evidence path is
    resolvable, re-burn, then sample. Pass a float to pin beta_min (nrungs
    then fixed too)."""
    p0 = torch.as_tensor(p0, dtype=torch.float32)
    W, d = p0.shape
    adapt = betas is None and beta_min == "auto"
    if betas is None:
        betas = geometric_ladder(nrungs, 1e-2 if adapt else beta_min)
    samp = ParallelTemperingSampler(W, d, lnprob_batch, betas, a=a)
    state = samp.init_state(p0.expand(samp.nrungs, W, d), seed)
    state = samp.advance(state, int(nburn))
    if adapt:
        lnp = state.lnp.double().cpu().numpy()
        inside = lnp[lnp > _SUPPORT_FLOOR]
        # every walker at or below the support floor: a conservative ladder
        # instead of an empty .min() (the batch tier's guard)
        worst = inside.min() if inside.size else -1e6
        new_betas = auto_ladder(worst, nrungs_min=nrungs)
        if new_betas.size == samp.nrungs:
            samp.set_betas(new_betas)
            betas = new_betas
        else:
            # K changed: seed each new rung from the nearest old rung's
            # walkers (~equilibrated at a nearby temperature); the stream
            # continues and a short re-burn settles the rest
            near = torch.as_tensor(nearest_rungs(new_betas, samp.betas),
                                   device=state.pos.device)
            betas = new_betas
            samp = ParallelTemperingSampler(W, d, lnprob_batch, betas, a=a)
            state = samp.init_state(state.pos[near], state.seed, state.step)
        state = samp.advance(state, max(int(nburn) // 2, 50))
    state = samp.reset_counters(state)
    state, chain, lnp, (mean_lnp, ss) = samp.run_mcmc(state, int(nsteps),
                                                      thin)
    logz_ss, dz_ss = ss.logz()
    logz_ti, dz_ti = thermodynamic_logz(betas, mean_lnp)
    denom = np.maximum(state.nswap_prop.cpu().numpy(), 1)
    return PTResult(
        chain=chain, lnprob=lnp, betas=np.asarray(betas),
        acceptance_fraction=state.naccept.double().cpu().numpy()
        / max(state.nsteps, 1),
        swap_fraction=state.nswap.cpu().numpy() / denom,
        mean_lnp=np.asarray(mean_lnp), logz=float(logz_ss),
        logz_err=float(dz_ss), logz_ti=float(logz_ti),
        logz_ti_err=float(dz_ti))
