"""Batched MAP + Laplace quick fits: survey triage before MCMC.

Torch twin of mbb_emcee_tpu/mapfit.py. The posterior is a differentiable
torch function, so a MAP fit is a few hundred gradient steps and the
Laplace approximation (inverse Hessian at the mode) gives error bars, for
every source and every start of a catalog in one batched computation:

1. an Adam approach phase (fixed step count) from each start;
2. a damped-Newton polish with a parallel damping ladder: each iteration
   solves (H + lambda_k I) d_k = -g for a fixed ladder of lambdas,
   evaluates the objective at every candidate and keeps the best of
   {current, candidates}. Monotone by construction, quadratic near the
   mode, branchless, fixed shape.

Optimization runs in the logit-unconstrained space of the prior box, so
hard bounds can never be violated; the MAP point and its Laplace
covariance are reported in the original parameter space (covariance from
the x-space Hessian at the mode, inverted host-side in fp64 with an
eigenvalue floor).

Gradients come from torch.autograd in fp32, like the reference's. The
Hessian is taken by double backward: one gradient pass with
create_graph=True, then one backward pass per free parameter (nfree <= 5)
of that batched gradient. Every row of a batch (a start of a source) is
independent of the others, so the summed passes give each row's own
gradient and Hessian exactly.

The likelihood is any batched function lnprob(x (..., n, nfree)) ->
(..., n): build_lnprob's for one source (no leading dims) or
build_lnprob_data's for a catalog (a leading source axis).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch.ops.smalllinalg import spd_solve_small

# Damping ladder for the Newton polish (relative to the mean Hessian
# diagonal): from near-undamped Newton to an almost gradient-descent step.
_LAMBDAS = (1e-4, 1e-2, 1.0)


def _to_unconstrained(x, lower, width):
    frac = torch.clamp((x - lower) / width, 1e-6, 1.0 - 1e-6)
    return torch.log(frac) - torch.log1p(-frac)


def _to_box(u, lower, width):
    return lower + width * torch.sigmoid(u)


@dataclasses.dataclass
class MAPResult:
    """One source's MAP fit (free-parameter space unless noted)."""
    x: np.ndarray            # (nfree,) MAP point
    lnprob: float            # posterior log-density at the mode
    cov: np.ndarray          # (nfree, nfree) Laplace covariance
    sigma: np.ndarray        # (nfree,) sqrt(diag(cov))
    interior: bool           # mode safely inside the box (Laplace valid)
    grad_norm: float         # |grad lnprob| at the mode (x-space)


def _value_and_grad(fn, x, create_graph=False):
    """(fn(x), d sum(fn(x)) / dx, x as the graph's leaf): each row's own
    gradient, since rows do not interact."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fn(x)
        g, = torch.autograd.grad(f.sum(), x, create_graph=create_graph)
    return f, g, x


def _hessian(fn, x):
    """(f, g, H) of fn at every row of x (..., nfree): H[..., j, :] is the
    gradient of g[..., j], one backward pass of the batched gradient per
    free parameter."""
    with torch.enable_grad():
        f, g, leaf = _value_and_grad(fn, x, create_graph=True)
        rows = []
        for j in range(x.shape[-1]):
            if g.requires_grad:
                r, = torch.autograd.grad(g[..., j].sum(), leaf,
                                         retain_graph=True, allow_unused=True)
            else:
                r = None
            rows.append(torch.zeros_like(x) if r is None else r)
    return f.detach(), g.detach(), torch.stack(rows, dim=-2).detach()


def map_core(lnprob, lower, width, u0, n_adam, n_newton, adam_lr):
    """The optimizer: u0 (..., nstarts, nfree) -> each batch row's best
    start (u_map (..., nfree), lnp (...)). `lnprob` maps x-space
    (..., nstarts, nfree) to (..., nstarts)."""
    nfree = u0.shape[-1]

    def neg(u):
        return -lnprob(_to_box(u, lower, width))

    # -- Adam approach phase (fixed iterations, decayed lr); the scalar
    # factors are formed in fp32 like the reference's
    u = u0.detach()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    f32 = np.float32
    for i in range(int(n_adam)):
        _, g, _ = _value_and_grad(neg, u)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t = f32(i) + f32(1.0)
        mhat = m / float(f32(1.0) - f32(0.9) ** t)
        vhat = v / float(f32(1.0) - f32(0.999) ** t)
        lr = float(f32(adam_lr) / (f32(1.0) + f32(0.01) * f32(i)))
        u = u - lr * mhat / (torch.sqrt(vhat) + 1e-8)

    # -- damped-Newton polish with a parallel damping ladder
    eye = torch.eye(nfree, dtype=u.dtype, device=u.device)
    for _ in range(int(n_newton)):
        f0, g, H = _hessian(neg, u)
        scale = torch.clamp(torch.mean(torch.abs(
            torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1), min=1e-8)
        scale = scale[..., None, None]
        best_u, best_f = u, f0
        with torch.no_grad():
            for lam in _LAMBDAS:
                # the pivot floor of the unrolled Cholesky regularizes an
                # indefinite Hessian; a non-finite step falls back to a
                # damped gradient step
                d = -spd_solve_small(H + lam * scale * eye, g)
                d = torch.where(
                    torch.all(torch.isfinite(d), dim=-1, keepdim=True), d,
                    -g / (lam * scale[..., 0] + 1.0))
                cand = u + d
                fc = neg(cand)
                better = (fc < best_f) & torch.isfinite(fc)
                best_u = torch.where(better[..., None], cand, best_u)
                best_f = torch.where(better, fc, best_f)
        u = best_u
    with torch.no_grad():
        f = neg(u)
    k = torch.argmin(f, dim=-1, keepdim=True)
    u_map = torch.gather(u, -2, k[..., None].expand(
        k.shape + (nfree,)))[..., 0, :]
    return u_map, -torch.gather(f, -1, k)[..., 0]


def neg_hessian(lnprob, x_map):
    """(-hessian(lnprob) symmetrized, grad lnprob) at the modes x_map
    (..., nfree). The tiny Hessians go to the host in fp64 for the Laplace
    inversion (laplace_cov_host): a truly degenerate mode (the
    exactly-determined 5-parameter/5-band fit with its T-lambda0 ridge) has
    condition numbers ~1e10+ that an fp32 inversion turns to NaN."""
    def one(x):
        return lnprob(x[..., None, :])[..., 0]
    _, g, H = _hessian(one, x_map)
    H = -H
    return 0.5 * (H + H.transpose(-1, -2)), g


def map_fit(lnprob, lower, upper, x0, n_adam, n_newton, adam_lr):
    """MAP fits from x-space starts x0 (..., nstarts, nfree) on x0's
    device. Returns (x_map (..., nfree), lnp (...), -Hessian
    (..., nfree, nfree), |grad| (...)) as host fp64 arrays."""
    dev = x0.device
    lo = torch.as_tensor(np.asarray(lower, np.float32), device=dev)
    width = torch.as_tensor(np.asarray(np.asarray(upper) - np.asarray(lower),
                                       np.float32), device=dev)
    u0 = _to_unconstrained(x0.to(torch.float32), lo, width)
    u_map, lnp_map = map_core(lnprob, lo, width, u0, n_adam, n_newton,
                              adam_lr)
    x_map = lo + width * torch.sigmoid(u_map)
    H, g = neg_hessian(lnprob, x_map)
    gn = torch.sqrt(torch.sum(g * g, dim=-1))
    return tuple(t.double().cpu().numpy() for t in (x_map, lnp_map, H, gn))


def laplace_cov_host(H, floor=1e-10):
    """fp64 host Laplace covariance from -hessian values (any leading batch
    dims): eigendecompose, floor eigenvalues at floor * max|w| (a
    degenerate or boundary mode gets a huge but finite variance along its
    flat direction), invert.

    Returns (cov, ok): a source whose fp32 Hessian came back non-finite
    (saturated model at an extreme in-box corner) gets ok=False and an
    identity covariance, so one pathological source does not abort the
    triage of a whole catalog; the caller flags it untrustworthy."""
    H = np.asarray(H, np.float64)
    ok = np.all(np.isfinite(H), axis=(-2, -1))
    n = H.shape[-1]
    H = np.where(ok[..., None, None], H, np.eye(n))
    w, V = np.linalg.eigh(H)
    scale = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 1e-300)
    w = np.maximum(w, floor * scale)
    return np.einsum("...ij,...j,...kj->...ik", V, 1.0 / w, V), ok


def interior_mask(x, sigma, lower, upper, k=2.0):
    """Per-point flag: mode at least k Laplace sigmas inside every bound,
    i.e. the Gaussian approximation puts negligible mass outside the box."""
    x = np.asarray(x, np.float64)
    sigma = np.asarray(sigma, np.float64)
    return np.all((x - lower > k * sigma) & (upper - x > k * sigma),
                  axis=-1)
