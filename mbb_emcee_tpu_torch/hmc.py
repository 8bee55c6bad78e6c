"""Gradient-based (Hamiltonian) MCMC over the MBB posterior.

Torch twin of mbb_emcee_tpu/hmc.py. Upstream mbb_emcee samples with emcee's
gradient-free stretch move because its NumPy/SciPy model is not
differentiable; here the whole lnprob -- greybody, Wien-merge root solve,
band quadrature, priors -- is a plain torch function, so torch.autograd
gives the forces (mapfit._value_and_grad, the oracle MAP fitting uses).
For the curved, correlated T-lambda0 posteriors of optically thick fits
HMC decorrelates in far fewer likelihood evaluations per effective sample
than the stretch move. The lnprob kernel K1 has no backward pass (nor has
the JAX package's Pallas kernel), so HMC runs the plain likelihood on the
fitter's device: the JAX package's own route (jax.grad of its XLA
likelihood), not a fallback.

Correctness notes:
- Sampling runs in an UNCONSTRAINED space: the free-parameter box (always
  finite) maps to R^nfree via the logit transform of mapfit.py with its
  log-Jacobian added to the target, so the box bounds never reject a
  trajectory.
- Leapfrog + Metropolis-Hastings stays an exact MCMC scheme even where
  autograd through the fixed-iteration merge solve is approximate: any
  deterministic force field gives a reversible, volume-preserving
  integrator, and acceptance uses true target evaluations.
- Step size is dual-averaged (Hoffman & Gelman 2014, Alg. 5) to a target
  acceptance statistic during warmup; a diagonal mass matrix is estimated
  from the late warmup samples (two-phase warmup). Per-step step-size
  jitter (+/-20%) breaks trajectory-length resonances.

The chains are independent, so every function takes leading batch axes in
front of the chain axis: u (..., nchains, nfree), step size (...,), mass
(..., nfree). The batch tier (batchengine.run_hmc) runs S sources at once,
each adapting its own step size and metric. Randomness: ops/philox.hmc_draws,
counted by the run's global step, so a checkpointed production run is the
uninterrupted one bit for bit; the step (_make_stepper's
hmc_step_from_draws) takes the draws as tensors (the JAX package's draws in
the cross-package tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# The logit transform and the gradient oracle MAP fitting uses (mapfit is
# the single definition: init='map' seeding assumes the tiers share it).
from mbb_emcee_tpu_torch.mapfit import _to_unconstrained, _value_and_grad
from mbb_emcee_tpu_torch.ops.philox import hmc_draws, step_blocks

# Dual-averaging constants (Hoffman & Gelman 2014).
_DA_T0 = 10.0
_DA_GAMMA = 0.05
_DA_KAPPA = 0.75


@dataclasses.dataclass
class HMCResult:
    """Production output: thinned chain in the ORIGINAL free space."""
    chain: torch.Tensor         # (nrec, nchains, nfree)
    lnprob: torch.Tensor        # (nrec, nchains) target lnprob (no Jacobian)
    acceptance_fraction: np.ndarray  # (nchains,)
    step_size: float
    mass: np.ndarray            # (nfree,) diagonal metric in u-space


def _make_lnpost(lnprob, lower, width):
    """u-space target: lnprob(x(u)) + log|dx/du|, plus the raw lnprob."""
    log_width = torch.sum(torch.log(width))

    def lnpost(u):
        x = lower + width * torch.sigmoid(u)
        logjac = log_width + torch.sum(F.logsigmoid(u) + F.logsigmoid(-u),
                                       dim=-1)
        lp = lnprob(x)
        return lp + logjac, lp

    return lnpost


def _make_stepper(lnprob, lower, width, n_leapfrog):
    """(vg, hmc_step_from_draws): the value-and-gradient oracle and one
    MH-corrected leapfrog transition on given draws, shared by the warmup
    and production cores so a checkpointed production segment advances
    exactly the chain the uninterrupted run would."""
    lnpost = _make_lnpost(lnprob, lower, width)

    def vg(u):
        """(lnpost, raw lnprob, gradient of lnpost) at every chain."""
        raw = []

        def f(x):
            val, lp = lnpost(x)
            raw.append(lp)
            return val

        val, g, _ = _value_and_grad(f, u)
        return val.detach(), raw[0].detach(), g

    def leapfrog(u, g, p, eps, inv_mass):
        # eps (..., nchains, 1) jittered per chain; inv_mass (..., 1, nfree)
        p = p + 0.5 * eps * g
        for _ in range(int(n_leapfrog) - 1):
            u = u + eps * inv_mass * p
            _, _, g = vg(u)
            p = p + eps * g
        u = u + eps * inv_mass * p
        lp, raw, g = vg(u)
        p = p + 0.5 * eps * g
        return u, g, lp, raw, p

    def hmc_step_from_draws(draws, u, g, lp, raw, eps, mass):
        """draws: (normals (..., nchains, nfree), jitter (..., nchains, 1),
        accept uniforms (..., nchains)); eps (...,), mass (..., nfree).
        Returns (u, g, lp, raw, accepted, mean acceptance statistic (...))."""
        normals, jitter, ua = draws
        inv_mass = (1.0 / mass)[..., None, :]
        p = normals * torch.sqrt(mass)[..., None, :]
        u2, g2, lp2, raw2, p2 = leapfrog(u, g, p, eps[..., None, None]
                                         * jitter, inv_mass)
        k_old = 0.5 * torch.sum(p * p * inv_mass, dim=-1)
        k_new = 0.5 * torch.sum(p2 * p2 * inv_mass, dim=-1)
        logr = (lp2 - k_new) - (lp - k_old)
        logr = torch.where(torch.isnan(logr), -torch.inf, logr)
        alpha = torch.exp(torch.clamp(logr, max=0.0))  # per-chain statistic
        acc = ua < alpha
        u = torch.where(acc[..., None], u2, u)
        g = torch.where(acc[..., None], g2, g)
        lp = torch.where(acc, lp2, lp)
        raw = torch.where(acc, raw2, raw)
        return u, g, lp, raw, acc, alpha.mean(dim=-1)

    return vg, hmc_step_from_draws


def _draws(seed, step, nsteps, u, source):
    """Each of the next `nsteps` transitions' draws for chains like u."""
    nchains, nfree = u.shape[-2:]
    nsrc = max(int(torch.as_tensor(source).numel()), 1)
    return step_blocks(
        lambda s0, n: hmc_draws(seed, s0, n, nchains, nfree, u.device,
                                source),
        step, nsteps, nchains * nsrc)


def da_update(da, m, alpha_mean, target_accept):
    """Dual averaging on ln eps (Hoffman & Gelman 2014, Alg. 5), fp32; `da`
    = (log_eps, log_eps_bar, h_bar, mu) and m the 1-based iteration."""
    log_eps, log_eps_bar, h_bar, mu = da
    # the iteration's scalars in fp32 on the host (no device round trip)
    f32 = np.float32
    mf = f32(m)
    t = mf + f32(_DA_T0)
    h_bar = (float(f32(1.0) - f32(1.0) / t) * h_bar
             + (target_accept - alpha_mean) / float(t))
    log_eps = mu - float(np.sqrt(mf) / f32(_DA_GAMMA)) * h_bar
    eta = mf ** f32(-_DA_KAPPA)
    log_eps_bar = float(eta) * log_eps + float(f32(1.0) - eta) * log_eps_bar
    return (log_eps, log_eps_bar, h_bar, mu)


def hmc_warmup_core(lnprob, lower, width, u0, nwarmup, n_leapfrog,
                    target_accept, seed, step=0, source=0):
    """Warmup phases only: dual-averaged step size (+ diagonal mass from
    the late phase-A samples), from u-space starts u0 (..., nchains,
    nfree) and the run's Philox stream from `step`. Returns the complete
    post-warmup production state (u, g, lp, raw, eps (...,), mass
    (..., nfree), step): everything hmc_prod_core needs, and everything a
    mid-production checkpoint must persist."""
    lead = u0.shape[:-2]
    nchains, nfree = u0.shape[-2:]
    dev = u0.device
    vg, hmc_step = _make_stepper(lnprob, lower, width, n_leapfrog)

    def warmup_phase(step, u, g, lp, raw, mass, eps0, niter, collect):
        draws = _draws(seed, step, niter, u, source)
        mu = torch.log(10.0 * eps0)
        da = (torch.log(eps0), torch.log(eps0),
              torch.zeros(lead, dtype=torch.float32, device=dev), mu)
        # moment accumulators for the diagonal mass (second half only)
        n = torch.zeros(lead, dtype=torch.float32, device=dev)
        s1 = torch.zeros(lead + (nfree,), dtype=torch.float32, device=dev)
        s2 = torch.zeros_like(s1)
        for m in range(1, int(niter) + 1):
            eps = torch.exp(da[0])
            u, g, lp, raw, _, alpha_mean = hmc_step(next(draws), u, g, lp,
                                                    raw, eps, mass)
            da = da_update(da, m, alpha_mean, target_accept)
            if collect and m > niter // 2:
                n = n + nchains
                s1 = s1 + torch.sum(u, dim=-2)
                s2 = s2 + torch.sum(u * u, dim=-2)
        eps_bar = torch.exp(da[1])
        step += int(niter)
        if not collect:
            return step, u, g, lp, raw, eps_bar, None
        n = torch.clamp(n, min=2.0)[..., None]
        var = torch.clamp(s2 / n - (s1 / n) ** 2, min=1e-8)
        return step, u, g, lp, raw, eps_bar, var

    lp, raw, g = vg(u0)
    u = u0
    mass0 = torch.ones(lead + (nfree,), dtype=torch.float32, device=dev)
    eps0 = torch.full(lead, 0.1, dtype=torch.float32, device=dev)

    if nwarmup <= 0:
        # "no warmup" literally: fixed eps0 + unit mass (for users supplying
        # pre-tuned expectations), not 2 noisy adaptation steps
        eps_b, mass = eps0, mass0
    elif nwarmup < 4:
        # too few samples for a variance-based metric; adapt eps only
        step, u, g, lp, raw, eps_b, _ = warmup_phase(
            step, u, g, lp, raw, mass0, eps0, int(nwarmup), collect=False)
        mass = mass0
    else:
        # Phase A: unit metric; adapt eps, estimate u-space variances.
        na = int(0.6 * nwarmup)
        nb = nwarmup - na
        step, u, g, lp, raw, eps_a, var = warmup_phase(
            step, u, g, lp, raw, mass0, eps0, na, collect=True)
        # Phase B: mass = 1/var (metric ~ inverse posterior covariance), so
        # momenta p ~ N(0, mass) give position updates eps * var * p with
        # the posterior's per-dimension scales; re-adapt eps under it.
        mass = 1.0 / var
        step, u, g, lp, raw, eps_b, _ = warmup_phase(
            step, u, g, lp, raw, mass, eps_a, nb, collect=False)
    return u, g, lp, raw, eps_b, mass, step


def hmc_prod_core(lnprob, lower, width, u, g, lp, raw, nacc, eps, mass,
                  nsteps, thin, n_leapfrog, seed, step, source=0):
    """Production at fixed (eps, mass), recording every thin-th state. A
    function of the carried state and the stream position alone, so a run
    segmented for checkpointing advances exactly the chain an
    uninterrupted run would. Returns (chain (..., nrec, nchains, nfree),
    lnp_chain (..., nrec, nchains), u, g, lp, raw, nacc, step)."""
    _, hmc_step = _make_stepper(lnprob, lower, width, n_leapfrog)
    nrec = int(nsteps) // int(thin)
    lead = u.shape[:-2]
    chain = torch.empty(lead + (nrec,) + u.shape[-2:], dtype=u.dtype,
                        device=u.device)
    lnpch = torch.empty(lead + (nrec, u.shape[-2]), dtype=raw.dtype,
                        device=u.device)
    draws = _draws(seed, step, nrec * int(thin), u, source)
    for r in range(nrec):
        for _ in range(int(thin)):
            u, g, lp, raw, acc, _ = hmc_step(next(draws), u, g, lp, raw,
                                             eps, mass)
            nacc = nacc + acc.to(torch.int32)
        chain[..., r, :, :] = lower + width * torch.sigmoid(u)
        lnpch[..., r, :] = raw
    return chain, lnpch, u, g, lp, raw, nacc, step + nrec * int(thin)


def hmc_core(lnprob, lower, width, u0, nwarmup, nsteps, thin, n_leapfrog,
             target_accept, seed, source=0):
    """Both warmup phases + production from u0 (..., nchains, nfree).
    Returns (chain, lnp_chain, nacc, eps, mass)."""
    u, g, lp, raw, eps, mass, step = hmc_warmup_core(
        lnprob, lower, width, u0, nwarmup, n_leapfrog, target_accept, seed,
        0, source)
    nacc = torch.zeros(u.shape[:-1], dtype=torch.int32, device=u.device)
    chain, lnp_chain, _, _, _, _, nacc, _ = hmc_prod_core(
        lnprob, lower, width, u, g, lp, raw, nacc, eps, mass, nsteps, thin,
        n_leapfrog, seed, step, source)
    return chain, lnp_chain, nacc, eps, mass


def check_box(lower, upper):
    if not (np.all(np.isfinite(np.asarray(lower)))
            and np.all(np.isfinite(np.asarray(upper)))):
        raise ValueError("HMC requires finite box bounds on every free "
                         "parameter (the defaults are finite; see "
                         "set_lowlim/set_uplim)")


def hmc_sample(lnprob, lower, upper, x0, seed, nwarmup=500, nsteps=1000,
               thin=1, n_leapfrog=16, target_accept=0.8) -> HMCResult:
    """Run HMC chains on the batched `lnprob` ((n, nfree) -> (n,)) over the
    finite box [lower, upper]. x0: (nchains, nfree) initial positions
    strictly inside the box, a tensor on the device to run on; `seed` the
    Philox key of the run. Returns the thinned production chain in the
    original (constrained) space plus diagnostics."""
    check_box(lower, upper)
    if int(nsteps) <= 0:
        # 0 % thin == 0 would pass the divisibility check and produce an
        # empty chain with a divide-by-zero acceptance fraction
        raise ValueError(f"nsteps={nsteps} must be positive")
    if int(nsteps) % max(int(thin), 1):
        raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    lo = torch.as_tensor(np.asarray(lower, np.float32), device=x0.device)
    width = torch.as_tensor(np.asarray(upper, np.float32),
                            device=x0.device) - lo
    u0 = _to_unconstrained(x0, lo, width)
    chain, lnp, nacc, eps, mass = hmc_core(
        lnprob, lo, width, u0, int(nwarmup), int(nsteps),
        max(int(thin), 1), int(n_leapfrog), float(target_accept), seed)
    return HMCResult(
        chain=chain, lnprob=lnp,
        acceptance_fraction=nacc.double().cpu().numpy() / int(nsteps),
        step_size=float(eps), mass=mass.double().cpu().numpy())
