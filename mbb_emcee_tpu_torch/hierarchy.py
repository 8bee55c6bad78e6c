"""Hierarchical population inference over fitted catalogs.

Torch twin of mbb_emcee_tpu/hierarchy.py. Upstream mbb_emcee fits every
source on its own; a survey asks next what POPULATION of T, beta, ... the
catalog was drawn from. This module answers it by reweighting the stored
per-source posterior samples (Hogg, Myers & Bovy 2010; Thrane & Talbot
2019):

    ln L(phi) = sum_s ln [ (1/N) sum_n  p(theta_sn | phi) / pi0(theta_sn) ]

where theta_sn are the batch's per-source posterior draws (MultiFitter's
chains, K3's on the card, or SEDMultiFitter's) under the interim per-source prior pi0. For the
hyper-ensemble's W walkers the likelihood is one (W, S, N) evaluation plus
a logsumexp over the samples, on the fitter's device, and the hyper-sampler
is the plain stretch-move EnsembleSampler over that lnprob.

The importance construction is only as good as its weights; the effective
sample size per source, ESS_s = (sum_n w_sn)^2 / sum_n w_sn^2, is the
published diagnostic, and reweight_ess() reports it at any phi (by default
the hyper-posterior median).

Population models: ln_dist(phi, theta) takes hyper vectors phi (P,) or
(W, P) and points theta (..., K), and returns (...) or (W, ...).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from mbb_emcee_tpu_torch.fitter import philox_key, resolve_device
from mbb_emcee_tpu_torch.likelihood import (
    FreeSpace, LikelihoodSpec, LNPROB_FLOOR, spec_arrays)
from mbb_emcee_tpu_torch.paramspace import ParamSpaceMixin
from mbb_emcee_tpu_torch.sampler import (
    EnsembleSampler, autocorrelation_time, make_initial_ball, split_rhat)

__all__ = [
    "TruncatedGaussianPopulation", "CorrelatedGaussianPopulation",
    "Selection", "build_hier_lnprob", "HierarchicalFitter",
    "fit_population",
]

# Elements of the largest (W, S, N, K) intermediate one lnprob call makes:
# a call with more hyper vectors is cut into chunks along W.
_CHUNK_ELEMS = 1 << 26
_LN_2PI = math.log(2.0 * math.pi)


def _const(a, like):
    """Host array `a` as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device)


def _hyper(phi, theta, ncols):
    """Columns [0, ncols) of phi (*B, P), shaped (*B, 1 x theta's point
    axes, ncols) to broadcast against theta (*T, K)."""
    lead = phi.shape[:-1]
    return phi[..., :ncols].reshape(lead + (1,) * (theta.dim() - 1)
                                    + (ncols,))


@functools.lru_cache(maxsize=None)
def _gauss_legendre(n):
    """(nodes, weights) of the n-point Gauss-Legendre rule on [-1, 1]
    (host fp64; the eigen-solve costs ~2 ms, so once per n)."""
    return np.polynomial.legendre.leggauss(n)


def _inside(theta, lo, hi):
    return torch.all((theta >= _const(lo, theta))
                     & (theta <= _const(hi, theta)), dim=-1)


@dataclasses.dataclass(frozen=True)
class TruncatedGaussianPopulation:
    """Independent truncated normals per population parameter.

    The population density for the K selected parameters is a product of
    normals N(mu_k, sigma_k) truncated to the interim sampling box
    [lo_k, hi_k] and renormalized there: the truncation term
    ln(Phi(b) - Phi(a)) matters whenever the population presses against a
    box edge, and dropping it biases sigma low.

    Hyper-parameter vector layout: phi = (mu_1..mu_K, sigma_1..sigma_K).
    The default hyper box keeps mu inside the interim box and sigma in
    [width/200, width]; `sigma_log_uniform=True` adds the scale-invariant
    -sum ln(sigma) hyper-prior.

    Any object with `hyper_names`, `lower`, `upper`, `default_init`,
    `default_scatter`, `ln_dist(phi, theta)` and `ln_hyper_prior(phi)` (on
    phi of shape (P,) or (W, P)) plugs into HierarchicalFitter the same way.
    """
    param_names: tuple
    box_lower: np.ndarray      # (K,) interim sampling box of the params
    box_upper: np.ndarray      # (K,)
    sigma_min: np.ndarray      # (K,)
    sigma_max: np.ndarray      # (K,)
    sigma_log_uniform: bool = False

    @classmethod
    def for_box(cls, param_names, lower, upper,
                sigma_min=None, sigma_max=None, sigma_log_uniform=False):
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        if lower.ndim != 1 or lower.shape != upper.shape:
            raise ValueError("lower/upper must be matching 1-D arrays")
        if len(param_names) != lower.size:
            raise ValueError("param_names length must match the box")
        if np.any(lower >= upper):
            raise ValueError("each lower limit must be < its upper limit")
        width = upper - lower
        smin = (width / 200.0 if sigma_min is None
                else np.broadcast_to(np.asarray(sigma_min, np.float64),
                                     width.shape).copy())
        smax = (width if sigma_max is None
                else np.broadcast_to(np.asarray(sigma_max, np.float64),
                                     width.shape).copy())
        if np.any(smin <= 0) or np.any(smax <= smin):
            raise ValueError("need 0 < sigma_min < sigma_max per parameter")
        return cls(param_names=tuple(param_names), box_lower=lower.copy(),
                   box_upper=upper.copy(), sigma_min=np.asarray(smin),
                   sigma_max=np.asarray(smax),
                   sigma_log_uniform=bool(sigma_log_uniform))

    @property
    def nparams(self):
        return len(self.param_names)

    @property
    def hyper_names(self):
        return tuple(f"mu_{p}" for p in self.param_names) + tuple(
            f"sigma_{p}" for p in self.param_names)

    @property
    def lower(self):
        return np.concatenate([self.box_lower, self.sigma_min])

    @property
    def upper(self):
        return np.concatenate([self.box_upper, self.sigma_max])

    @property
    def default_init(self):
        width = self.box_upper - self.box_lower
        return np.concatenate([0.5 * (self.box_lower + self.box_upper),
                               np.minimum(0.25 * width, self.sigma_max)])

    @property
    def default_scatter(self):
        width = self.box_upper - self.box_lower
        return np.concatenate([0.1 * width, 0.05 * width])

    def ln_dist(self, phi, theta):
        """ln p(theta | phi), normalized over the truncation box.

        phi: (2K,) or (W, 2K); theta: (..., K) -> (...) or (W, ...)."""
        k = self.nparams
        phi = phi.to(theta.dtype)
        mu = _hyper(phi, theta, k)
        sigma = _hyper(phi[..., k:], theta, k)
        lo, hi = _const(self.box_lower, theta), _const(self.box_upper, theta)
        # truncation normalization Phi((hi-mu)/s) - Phi((lo-mu)/s); mu is
        # box-bounded and sigma >= sigma_min, clamped against underflow
        trunc = (torch.special.ndtr((hi - mu) / sigma)
                 - torch.special.ndtr((lo - mu) / sigma))
        ln_norm = (-torch.log(sigma) - 0.5 * _LN_2PI
                   - torch.log(torch.clamp(trunc, min=1e-30)))
        # ln_norm - z^2 / 2 with z = (theta - mu) / sigma, in as few passes
        # over the (W, S, N, K) points as torch's eager ops allow
        z = (theta - mu) / sigma
        ln_p = torch.addcmul(ln_norm, z, z, value=-0.5)
        ln_p = ln_p[..., 0] if k == 1 else torch.sum(ln_p, dim=-1)
        # a truncated density is ZERO outside its box
        return ln_p.masked_fill(
            ~_inside(theta, self.box_lower, self.box_upper), -1e30)

    def ln_hyper_prior(self, phi):
        if not self.sigma_log_uniform:
            return torch.zeros(phi.shape[:-1], dtype=phi.dtype,
                               device=phi.device)
        return -torch.sum(torch.log(phi[..., self.nparams:]), dim=-1)

    def marginal_pdf(self, phi, k, x):
        """Exact box-truncated marginal density of parameter k at grid `x`,
        host numpy (1-D truncated normals)."""
        from scipy.special import ndtr as _ndtr
        phi = np.asarray(phi, np.float64)
        x = np.asarray(x, np.float64)
        mu, sig = phi[k], phi[self.nparams + k]
        lo, hi = self.box_lower[k], self.box_upper[k]
        z = (x - mu) / sig
        trunc = _ndtr((hi - mu) / sig) - _ndtr((lo - mu) / sig)
        pdf = (np.exp(-0.5 * z * z)
               / (sig * np.sqrt(2 * np.pi) * max(trunc, 1e-30)))
        return np.where((x >= lo) & (x <= hi), pdf, 0.0)


@dataclasses.dataclass(frozen=True)
class CorrelatedGaussianPopulation:
    """Bivariate normal population with a free correlation: is a survey's
    T-beta anticorrelation a population property or just the per-source
    degeneracy?

    Hyper vector: phi = (mu_a, mu_b, sigma_a, sigma_b, rho). The density is
    normalized over the truncation rectangle; Z(phi) = P(box | mu, Sigma)
    has no closed form and is a 64-node Gauss-Legendre rule in the
    STANDARDIZED coordinate of the first parameter,

        Z = int phi(u) [Phi(h2(u)) - Phi(h1(u))] du,

    with the conditional-normal limits h(u) of the second, which keeps the
    integrand O(1)-scaled for any sigma.
    """
    param_names: tuple
    box_lower: np.ndarray       # (2,)
    box_upper: np.ndarray       # (2,)
    sigma_min: np.ndarray       # (2,)
    sigma_max: np.ndarray       # (2,)
    rho_max: float = 0.95
    sigma_log_uniform: bool = False

    _GL_NODES = 64

    @classmethod
    def for_box(cls, param_names, lower, upper, sigma_min=None,
                sigma_max=None, rho_max=0.95, sigma_log_uniform=False):
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        if lower.shape != (2,) or upper.shape != (2,):
            raise ValueError(
                "CorrelatedGaussianPopulation is the two-parameter "
                "family; give 2-element boxes (use "
                "TruncatedGaussianPopulation or a custom model for "
                "other dimensionalities)")
        if len(param_names) != 2:
            raise ValueError("param_names must name exactly 2 parameters")
        if np.any(lower >= upper):
            raise ValueError("each lower limit must be < its upper limit")
        if not 0.0 < rho_max < 1.0:
            raise ValueError("rho_max must be in (0, 1)")
        width = upper - lower
        smin = (width / 100.0 if sigma_min is None
                else np.broadcast_to(np.asarray(sigma_min, np.float64),
                                     (2,)).copy())
        smax = (width if sigma_max is None
                else np.broadcast_to(np.asarray(sigma_max, np.float64),
                                     (2,)).copy())
        if np.any(smin <= 0) or np.any(smax <= smin):
            raise ValueError("need 0 < sigma_min < sigma_max per parameter")
        return cls(param_names=tuple(param_names), box_lower=lower.copy(),
                   box_upper=upper.copy(), sigma_min=smin, sigma_max=smax,
                   rho_max=float(rho_max),
                   sigma_log_uniform=bool(sigma_log_uniform))

    @property
    def hyper_names(self):
        a, b = self.param_names
        return (f"mu_{a}", f"mu_{b}", f"sigma_{a}", f"sigma_{b}",
                f"rho_{a}_{b}")

    @property
    def lower(self):
        return np.concatenate([self.box_lower, self.sigma_min,
                               [-self.rho_max]])

    @property
    def upper(self):
        return np.concatenate([self.box_upper, self.sigma_max,
                               [self.rho_max]])

    @property
    def default_init(self):
        width = self.box_upper - self.box_lower
        return np.concatenate([0.5 * (self.box_lower + self.box_upper),
                               np.minimum(0.25 * width, self.sigma_max),
                               [0.0]])

    @property
    def default_scatter(self):
        width = self.box_upper - self.box_lower
        return np.concatenate([0.1 * width, 0.05 * width, [0.2]])

    def _ln_z(self, mu, sigma, rho):
        """ln P(box | mu, Sigma) for mu, sigma (*B, 2) and rho (*B,) ->
        (*B,), by the 64-node rule in the standardized first coordinate
        (see the class docstring)."""
        nodes, weights = (_const(a, mu)
                          for a in _gauss_legendre(self._GL_NODES))
        lo, hi = _const(self.box_lower, mu), _const(self.box_upper, mu)
        a1 = torch.clamp((lo[0] - mu[..., 0]) / sigma[..., 0], -8.0, 8.0)
        a2 = torch.clamp((hi[0] - mu[..., 0]) / sigma[..., 0], -8.0, 8.0)
        a1, a2 = a1[..., None], a2[..., None]
        u = 0.5 * (a2 - a1) * nodes + 0.5 * (a2 + a1)     # (*B, n)
        # the second parameter conditional on the first = mu_a + sigma_a u
        cmean = mu[..., 1:] + rho[..., None] * sigma[..., 1:] * u
        csd = sigma[..., 1:] * torch.sqrt(
            torch.clamp(1.0 - rho * rho, min=1e-6))[..., None]
        inner = (torch.special.ndtr((hi[1] - cmean) / csd)
                 - torch.special.ndtr((lo[1] - cmean) / csd))
        dens = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
        z = 0.5 * (a2[..., 0] - a1[..., 0]) * torch.sum(
            weights * dens * inner, dim=-1)
        return torch.log(torch.clamp(z, min=1e-30))

    def ln_dist(self, phi, theta):
        """ln p(theta | phi), normalized over the truncation rectangle.
        phi: (5,) or (W, 5); theta: (..., 2) -> (...) or (W, ...)."""
        phi = phi.to(theta.dtype)
        ntheta = theta.dim() - 1
        lead = phi.shape[:-1]

        def col(i):
            return phi[..., i].reshape(lead + (1,) * ntheta)

        mu0, mu1, s0, s1, rho = (col(i) for i in range(5))
        om = torch.clamp(1.0 - rho * rho, min=1e-6)
        ln_z = self._ln_z(phi[..., :2], phi[..., 2:4], phi[..., 4])
        c = (-torch.log(s0) - torch.log(s1) - 0.5 * torch.log(om) - _LN_2PI
             - ln_z.reshape(lead + (1,) * ntheta))
        # -q / (2 om) with q = za^2 - 2 rho za zb + zb^2, written as
        # -(za - rho zb)^2 / (2 om) - (1 - rho^2) zb^2 / (2 om): a few
        # passes over the (W, S, N) points, the per-hyper-vector factors
        # folded into the scales
        za = (theta[..., 0] - mu0) / s0
        zb = (theta[..., 1] - mu1) / s1
        u = (za - rho * zb) * torch.sqrt(0.5 / om)
        v = zb * torch.sqrt(0.5 * (1.0 - rho * rho) / om)
        ln_p = torch.addcmul(torch.addcmul(c, u, u, value=-1.0), v, v,
                             value=-1.0)
        return ln_p.masked_fill(
            ~_inside(theta, self.box_lower, self.box_upper), -1e30)

    def ln_hyper_prior(self, phi):
        if not self.sigma_log_uniform:
            return torch.zeros(phi.shape[:-1], dtype=phi.dtype,
                               device=phi.device)
        return -torch.sum(torch.log(phi[..., 2:4]), dim=-1)

    def marginal_pdf(self, phi, k, x):
        """Exact box-truncated marginal of parameter k: the normal marginal
        in k times the conditional box probability of the other coordinate,
        over Z (from the same rule ln_dist divides by). Host numpy."""
        from scipy.special import ndtr as _ndtr
        phi = np.asarray(phi, np.float64)
        x = np.asarray(x, np.float64)
        j = 1 - k
        mu, sig, rho = phi[:2], phi[2:4], phi[4]
        lo, hi = self.box_lower, self.box_upper
        u = (x - mu[k]) / sig[k]
        cmean = mu[j] + rho * sig[j] * u
        csd = sig[j] * np.sqrt(max(1.0 - rho * rho, 1e-6))
        inner = (_ndtr((hi[j] - cmean) / csd)
                 - _ndtr((lo[j] - cmean) / csd))
        t = torch.as_tensor(np.asarray(phi, np.float32))
        z_norm = float(torch.exp(self._ln_z(t[:2], t[2:4], t[4])))
        pdf = (np.exp(-0.5 * u * u) * inner
               / (sig[k] * np.sqrt(2 * np.pi) * max(z_norm, 1e-30)))
        return np.where((x >= lo[k]) & (x <= hi[k]), pdf, 0.0)


@dataclasses.dataclass(frozen=True)
class Selection:
    """Survey selection function in Monte-Carlo form (the injection-campaign
    construction of Mandel, Farr & Gair 2019; Farr 2019's N_eff
    diagnostic): the detection fraction under population phi,

        alpha(phi) ~ (1/n_total) sum_m P_det(theta_m) p(theta_m|phi)
                                        / p_draw(theta_m),

    enters the hyper-likelihood as -S ln alpha(phi) and corrects the
    Malmquist bias a flux-limited catalog imprints on the population.

    injections: (M, K) reference draws theta_m; ln_pdet: (M,)
    ln P_det(theta_m) (0 = the found-injection convention where only
    detected injections are listed and n_total counts ALL draws);
    ln_draw: (M,) ln p_draw(theta_m); n_total: total draws including
    undetected ones.
    """
    injections: np.ndarray
    ln_pdet: np.ndarray
    ln_draw: np.ndarray
    n_total: int

    @classmethod
    def from_injections(cls, injections, pdet=None, ln_draw=None,
                        n_total=None, box=None):
        """Build from an injection campaign: injections (M, K); pdet (M,)
        detection probabilities in [0, 1] (omit for found-only lists);
        ln_draw (M,) ln p_draw, or box=(lower, upper) for draws uniform over
        it (the constant -ln V); n_total defaults to M."""
        injections = np.asarray(injections, np.float64)
        if injections.ndim != 2:
            raise ValueError(
                f"injections must be (M, K); got {injections.shape}")
        m = injections.shape[0]
        if pdet is None:
            ln_pdet = np.zeros(m)
        else:
            pdet = np.asarray(pdet, np.float64)
            if pdet.shape != (m,):
                raise ValueError(f"pdet must be (M,)=({m},)")
            if np.any(pdet < 0) or np.any(pdet > 1):
                raise ValueError("pdet values must be in [0, 1]")
            with np.errstate(divide="ignore"):
                ln_pdet = np.where(pdet > 0, np.log(np.maximum(pdet,
                                                               1e-300)),
                                   -745.0)   # exp(-745) underflows to 0
        if ln_draw is None:
            if box is None:
                raise ValueError(
                    "give ln_draw (per-draw ln p_draw) or box=(lower, "
                    "upper) for uniform draws")
            lo = np.asarray(box[0], np.float64)
            hi = np.asarray(box[1], np.float64)
            ln_draw = np.full(m, -float(np.sum(np.log(hi - lo))))
        else:
            ln_draw = np.asarray(ln_draw, np.float64)
            if ln_draw.shape != (m,):
                raise ValueError(f"ln_draw must be (M,)=({m},)")
        n_total = m if n_total is None else int(n_total)
        if n_total < m:
            raise ValueError(
                f"n_total={n_total} < number of listed injections {m}")
        return cls(injections=injections, ln_pdet=np.asarray(ln_pdet),
                   ln_draw=ln_draw, n_total=n_total)


def build_hier_lnprob(samples, population, spec: LikelihoodSpec,
                      ln_interim=None, selection=None, dtype=torch.float32,
                      device=None, mesh=None):
    """The hierarchical lnprob over the FREE hyper-parameter space.

    samples: (S, N, K) per-source posterior draws of the K population
    parameters; ln_interim: optional (S, N) interim ln-prior values at
    those draws (phi-independent offsets cancel; flat-box interim priors
    pass None). device: "cuda" (the default; raises without a card) or
    "cpu". Returns (lnprob_fn, free_space); lnprob_fn maps hyper vectors
    (W, nfree) -> (W,) (or (nfree,) -> a 0-dim tensor) with the package's
    box-floor / clip-widening / reduced-space conventions
    (likelihood.build_lnprob).

    Under `mesh` (a parallel.walker_mesh, whose size must divide S; the
    device is its first) the samples split over the mesh's devices in
    contiguous source blocks: each shard sums its sources' terms on its
    device and the partial sums add on the first device, so the result
    differs from the unsharded one only in the order of that sum."""
    if mesh is not None:
        from mbb_emcee_tpu_torch.parallel.mesh import (
            WALKER_AXIS, check_mesh, mesh_blocks, mesh_device)
        device = mesh_device(mesh, device)
    device = resolve_device(device)
    host = np.asarray(samples)
    if host.ndim != 3:
        raise ValueError(f"samples must be (S, N, K); got {host.shape}")
    S, N, K = host.shape
    nhyper = spec.lower.size
    if np.asarray(population.lower).size != nhyper:
        raise ValueError(
            f"spec is sized for {nhyper} hyper-parameters; population "
            f"model declares {np.asarray(population.lower).size}")
    samples = torch.as_tensor(host, dtype=dtype, device=device)
    if ln_interim is not None:
        ln_interim = torch.as_tensor(np.asarray(ln_interim), dtype=dtype,
                                     device=device)
        if tuple(ln_interim.shape) != (S, N):
            raise ValueError(
                f"ln_interim must be (S, N)={S, N}; got "
                f"{tuple(ln_interim.shape)}")

    # A source whose stored chain lies ENTIRELY outside the population's
    # truncation box would floor the hyper-lnprob for every phi, freezing
    # the sampler with acceptance 0 and no error: refuse it here.
    pop_lo = getattr(population, "box_lower", None)
    pop_hi = getattr(population, "box_upper", None)
    if pop_lo is not None and pop_hi is not None:
        inside = np.all((host >= np.asarray(pop_lo))
                        & (host <= np.asarray(pop_hi)), axis=-1)  # (S, N)
        dead = np.nonzero(~inside.any(axis=1))[0]
        if dead.size:
            raise ValueError(
                f"source(s) {dead.tolist()} have NO samples inside the "
                f"population truncation box [{np.asarray(pop_lo)}, "
                f"{np.asarray(pop_hi)}]; every hyper vector would get "
                "zero weight there. Widen the population box or drop "
                "those sources")
        if selection is not None:
            inj_host = np.asarray(selection.injections)
            inj_in = np.all((inj_host >= np.asarray(pop_lo))
                            & (inj_host <= np.asarray(pop_hi)), axis=-1)
            if not inj_in.any():
                raise ValueError(
                    "no selection injections fall inside the population "
                    "truncation box; alpha(phi) would underflow for "
                    "every phi (and its log-penalty would blow up the "
                    "hyper-lnprob). Draw injections over the population "
                    "box")

    if mesh is None:
        blocks = [(samples, ln_interim)]
    else:
        n_shard = check_mesh(mesh).size
        if S % n_shard:
            raise ValueError(
                f"mesh axis {WALKER_AXIS!r} size {n_shard} must divide the "
                f"source count {S}")
        blocks = [(samples[lo:hi].to(dev), None if ln_interim is None
                   else ln_interim[lo:hi].to(dev))
                  for lo, hi, dev in mesh_blocks(mesh, S)]

    def source_sum(phi_safe):
        """sum_s ln (1/N) sum_n p(theta_sn | phi) / pi(theta_sn): each
        block's on its device, the blocks' partial sums added here (phi
        copied to every block's device before any block's work is queued:
        a copy waits for the work queued on its source device)."""
        phis = [phi_safe.to(smp.device) for smp, _ in blocks]
        parts = []
        for (smp, lni), phi in zip(blocks, phis):
            lw = population.ln_dist(phi, smp)  # (W,s,N)
            if lni is not None:
                lw = lw - lni
            parts.append(torch.sum(torch.logsumexp(lw, dim=-1) - log_n,
                                   dim=-1).to(device))
        lnl = parts[0]
        for p in parts[1:]:
            lnl = lnl + p
        return lnl

    sa = spec_arrays(spec)
    free_space = sa.free_space
    free_idx = torch.as_tensor(free_space.free_idx, device=device)
    template, lo_free, hi_free, lo_full, hi_full, prior_mean, prior_isig = (
        torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        for a in sa[1:])
    log_n = float(np.log(N))
    if selection is not None:
        inj = torch.as_tensor(np.asarray(selection.injections), dtype=dtype,
                              device=device)
        if inj.dim() != 2 or inj.shape[1] != K:
            raise ValueError(
                f"selection.injections must be (M, {K}); got "
                f"{tuple(inj.shape)}")
        inj_lnw = torch.as_tensor(
            np.asarray(selection.ln_pdet - selection.ln_draw),
            dtype=dtype, device=device)
        log_m = float(np.log(selection.n_total))
    chunk = max(1, _CHUNK_ELEMS // (S * N * K))

    def one(phi_free):
        phi = template.expand(phi_free.shape[0], nhyper).clone()
        phi[:, free_idx] = phi_free
        inbox = torch.all((phi_free >= lo_free) & (phi_free <= hi_free),
                          dim=-1)
        phi_safe = torch.minimum(torch.maximum(phi, lo_full), hi_full)
        lnl = source_sum(phi_safe)
        if selection is not None:
            # -S ln alpha(phi): one more (W, M) reduction
            ln_alpha = torch.logsumexp(
                population.ln_dist(phi_safe, inj) + inj_lnw, dim=-1) - log_m
            lnl = lnl - S * ln_alpha
        dp = (phi - prior_mean) * prior_isig
        lnpri = (-0.5 * torch.sum(dp * dp, dim=-1)
                 + population.ln_hyper_prior(phi_safe))
        return torch.where(inbox, lnl + lnpri,
                           torch.full_like(lnl, LNPROB_FLOOR))

    def lnprob(phi_free):
        phi_free = torch.as_tensor(phi_free, device=device).to(dtype)
        if phi_free.dim() == 1:
            return one(phi_free[None])[0]
        return torch.cat([one(phi_free[i:i + chunk])
                          for i in range(0, phi_free.shape[0], chunk)])

    return lnprob, free_space


class HierarchicalFitter(ParamSpaceMixin):
    """Hyper-parameter sampler over a catalog's stored posteriors.

    Construct directly from an (S, N, K) sample tensor + population model,
    or via `from_batch(mf, params=...)` on a finished batch run. The
    run protocol, the setters (set_lowlim/set_uplim/fix_param/
    set_gaussian_prior/set_param_init on HYPER-parameters, addressed by the
    population model's names), extend() and the summaries mirror the other
    fitters. device: "cuda" (the default; raises without a card) or "cpu";
    the hyper-lnprob and the hyper-sampler run there. mesh: a
    parallel.walker_mesh whose size divides S; the hyper-lnprob's source
    sum is then split over its devices (build_hier_lnprob) and the device
    is its first.
    """

    def __init__(self, samples, population, ln_interim=None, nwalkers=64,
                 seed=3033, a=2.0, dtype=torch.float32, device=None,
                 mesh=None):
        if mesh is not None:
            from mbb_emcee_tpu_torch.parallel.mesh import mesh_device
            device = mesh_device(mesh, device)
        self.mesh = mesh
        self.device = resolve_device(device)
        # samples keep the fitter's dtype on the host (no fp32 rounding of
        # a float64 fit)
        host_dt = np.float64 if dtype == torch.float64 else np.float32
        self.samples = np.asarray(samples, host_dt)
        if self.samples.ndim != 3:
            raise ValueError(
                f"samples must be (S, N, K); got {self.samples.shape}")
        self.population = population
        self.ln_interim = (None if ln_interim is None
                           else np.asarray(ln_interim, host_dt))
        self.nwalkers = int(nwalkers)
        self.seed = int(seed)
        self.a = float(a)
        self.dtype = dtype
        self._spec = LikelihoodSpec.for_box(population.lower,
                                            population.upper)
        self._init = np.asarray(population.default_init, np.float64).copy()
        self._scatter = np.asarray(population.default_scatter,
                                   np.float64).copy()
        self._user_init = np.zeros(self._init.size, bool)
        self._user_scatter = np.zeros(self._init.size, bool)
        self.free_space = None
        self.chain_free = None     # (nrec, nwalkers, nfree) host numpy
        self.lnprobability = None  # (nrec, nwalkers)
        self.thin = 1
        self._state = None
        self._sampler = None
        self._acceptance = None
        self.evidence = None       # NestedResult, compute_evidence()
        self.selection = None      # Selection, set_selection()

    # -- ParamSpaceMixin plumbing ------------------------------------------
    def _param_index(self, param):
        if isinstance(param, (int, np.integer)):
            i = int(param)
            if not 0 <= i < len(self.population.hyper_names):
                raise ValueError(f"hyper-parameter index {i} out of range")
            return i
        names = [n.lower() for n in self.population.hyper_names]
        try:
            return names.index(str(param).lower())
        except ValueError:
            raise ValueError(
                f"unknown hyper-parameter {param!r}; "
                f"known: {self.population.hyper_names}") from None

    def _effective_spec(self):
        return self._spec

    @classmethod
    def from_batch(cls, batch, params, population=None, max_samples=4096,
                   sigma_log_uniform=False, correlated=False, **kw):
        """Build the hyper-fitter from a finished batch run (MultiFitter or
        SEDMultiFitter) on the batch's device (unless device= is given).

        `params` names the population parameters (free in the fit). The
        per-source chains are flattened and strided down to at most
        `max_samples` draws per source (deterministic stride). Gaussian
        interim priors on the selected parameters are divided out, shared
        ones and an SEDMultiFitter's per-source ones alike; the flat-box
        factor is phi-independent and cancels. The default family is
        independent truncated normals; `correlated=True` (exactly two
        params) switches to the bivariate family with a free rho.
        """
        if getattr(batch, "chain_free", None) is None:
            raise RuntimeError("from_batch needs a finished run()")
        chain = batch.chain_free            # (S, nrec, nw, nfree)
        free_names = [n.lower() for n in batch.free_param_names]
        cols = []
        for p in params:
            key = str(p).lower()
            if key not in free_names:
                raise ValueError(
                    f"population parameter {p!r} is not free in the fit; "
                    f"free parameters: {batch.free_param_names}")
            cols.append(free_names.index(key))
        cols = np.asarray(cols)
        S = chain.shape[0]
        flat = chain.reshape(S, -1, chain.shape[-1])
        nsamp = flat.shape[1]
        if nsamp > max_samples:
            stride = int(np.ceil(nsamp / max_samples))
            flat = flat[:, ::stride][:, :max_samples]
        flat = flat[..., torch.as_tensor(cols, device=flat.device)]
        flat = flat.cpu().numpy()           # (S, nsamp, K)

        spec = batch.spec
        free_idx = spec.free_indices[cols]
        lo = spec.lower[free_idx]
        hi = spec.upper[free_idx]
        if population is None:
            names = tuple(str(p) for p in params)
            if correlated:
                if len(names) != 2:
                    raise ValueError(
                        "correlated=True uses the bivariate family; give "
                        "exactly 2 params (or pass a custom population)")
                population = CorrelatedGaussianPopulation.for_box(
                    names, lo, hi, sigma_log_uniform=sigma_log_uniform)
            else:
                population = TruncatedGaussianPopulation.for_box(
                    names, lo, hi, sigma_log_uniform=sigma_log_uniform)
        elif correlated:
            raise ValueError("correlated=True conflicts with an explicit "
                             "population model")

        # interim Gaussian priors on the selected params: the quadratic
        # term varies per sample and is divided out of the weights (the
        # normalization constants are phi-independent and drop)
        isig = spec.prior_isigma[free_idx]
        if np.any(isig > 0):
            mu0 = spec.prior_mean[free_idx]
            d = (flat - mu0) * isig
            ln_interim = -0.5 * np.sum(d * d, axis=-1)
        else:
            ln_interim = None
        # ... and per-source interim priors (SEDMultiFitter's
        # set_gaussian_prior with (S,) arrays, spec-z anchors say): the
        # same division, the mean and 1/sigma varying along the source axis
        per_source = batch._per_source_priors()
        for k, p in enumerate(params):
            entry = per_source.get(str(p).lower())
            if entry is not None:
                m_s, i_s = entry
                d = (flat[..., k] - m_s[:, None]) * i_s[:, None]
                q = -0.5 * d * d
                ln_interim = q if ln_interim is None else ln_interim + q
        kw.setdefault("device", batch.device)
        return cls(flat, population, ln_interim=ln_interim, **kw)

    def set_selection(self, injections, pdet=None, ln_draw=None,
                      n_total=None, box=None):
        """Attach the survey selection function as an injection campaign
        (Selection.from_injections); the hyper-likelihood gains the
        -S ln alpha(phi) Malmquist correction. `box` defaults to the
        population's truncation box when the draws are uniform. A Selection
        passed as `injections` is kept as it is."""
        if isinstance(injections, Selection):
            self.selection = injections
        else:
            if ln_draw is None and box is None:
                box = (self.population.box_lower, self.population.box_upper)
            self.selection = Selection.from_injections(
                injections, pdet=pdet, ln_draw=ln_draw, n_total=n_total,
                box=box)
        return self

    def _phi(self, phi):
        """A full hyper vector as a tensor on the fitter's device (default:
        the hyper-posterior median)."""
        if phi is None:
            self._require_run()
            phi = self.free_space.expand(np.median(self.flatchain, axis=0))
        return torch.as_tensor(np.asarray(phi, np.float64), dtype=self.dtype,
                               device=self.device)

    def selection_neff(self, phi=None):
        """Effective number of injections behind alpha(phi) (Farr 2019):
        N_eff = (sum w)^2 / sum w^2 with w_m = P_det p(theta_m|phi) /
        p_draw. The rule of thumb wants N_eff >= 4 S (otherwise run more
        injections). Default phi = the hyper-posterior median."""
        if self.selection is None:
            raise RuntimeError("set_selection() first")
        phi = self._phi(phi)
        inj = torch.as_tensor(self.selection.injections, dtype=self.dtype,
                              device=self.device)
        lw = (self.population.ln_dist(phi, inj)
              + torch.as_tensor(self.selection.ln_pdet
                                - self.selection.ln_draw, dtype=self.dtype,
                                device=self.device))
        lw = lw - torch.logsumexp(lw, dim=-1)
        return float(torch.exp(-torch.logsumexp(2.0 * lw, dim=-1)))

    # -- sampling -----------------------------------------------------------
    def build(self):
        """(lnprob, free_space, sampler) of the current hyper spec."""
        lnprob, free_space = build_hier_lnprob(
            self.samples, self.population, self._effective_spec(),
            ln_interim=self.ln_interim, selection=self.selection,
            dtype=self.dtype, device=self.device, mesh=self.mesh)
        sampler = EnsembleSampler(self.nwalkers, free_space.nfree, lnprob,
                                  a=self.a)
        return lnprob, free_space, sampler

    def run(self, nburn=200, nsteps=1000, thin=1, p0=None,
            recenter_burn=True, verbose=False):
        """Burn -> re-center on the best burn-in sample -> re-burn ->
        reset -> production, over the hyper space. The walker balls come
        from a CPU torch.Generator seeded with `seed`, the proposals from
        the Philox stream of fitter.philox_key(seed). Returns self."""
        if int(thin) < 1:
            raise ValueError(f"thin={thin} must be >= 1")
        if int(nsteps) % int(thin):
            raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
        thin = int(thin)
        _, free_space, sampler = self.build()
        self.free_space = free_space
        self.thin = thin
        idx = free_space.free_idx

        gen = torch.Generator().manual_seed(self.seed)
        if p0 is None:
            p0 = make_initial_ball(gen, self._init[idx], self._scatter[idx],
                                   self.nwalkers, free_space.lower,
                                   free_space.upper, device=self.device)
        else:
            p0 = torch.as_tensor(np.asarray(p0, np.float32),
                                 device=self.device)
            if p0.shape[-1] == self._spec.lower.size:
                p0 = p0[..., torch.as_tensor(idx, device=self.device)]
        state = sampler.init_state(p0, seed=philox_key(self.seed))
        if nburn > 0:
            state, bchain, blnp = sampler.run_mcmc(state, nburn)
            if recenter_burn:
                flat = bchain.reshape(-1, free_space.nfree)
                best = flat[int(torch.argmax(blnp.reshape(-1)))]
                p0b = make_initial_ball(
                    gen, best.double().cpu().numpy(),
                    self._scatter[idx] * 0.1, self.nwalkers,
                    free_space.lower, free_space.upper, device=self.device)
                state = sampler.init_state(p0b, seed=state.seed,
                                           step=state.step)
                state = sampler.advance(state, nburn)
            state = sampler.reset_counters(state)

        state, chain, lnp = sampler.run_mcmc(state, nsteps, thin)
        self.chain_free = chain.cpu().numpy()
        self.lnprobability = lnp.cpu().numpy()
        self._state = state
        self._sampler = sampler
        self._acceptance = EnsembleSampler.acceptance_fraction(state)
        if verbose:
            # R-hat needs >= 4 records; a tiny verbose run must not crash
            # after the sampling finished
            rhat = (float(self.gelman_rubin()[1].max())
                    if self.chain_free.shape[0] >= 4 else float("nan"))
            print(f"HierarchicalFitter: acceptance "
                  f"{float(np.mean(self._acceptance)):.3f}, max split-R-hat "
                  f"{rhat:.3f}")
        return self

    def extend(self, nsteps):
        """Continue production (the same Philox stream) and append."""
        if self._state is None:
            raise RuntimeError("extend() needs a finished run()")
        if int(nsteps) % self.thin:
            raise ValueError(
                f"nsteps={nsteps} not divisible by thin={self.thin}")
        state, chain, lnp = self._sampler.run_mcmc(
            self._state, int(nsteps), self.thin)
        self.chain_free = np.concatenate(
            [self.chain_free, chain.cpu().numpy()], axis=0)
        self.lnprobability = np.concatenate(
            [self.lnprobability, lnp.cpu().numpy()], axis=0)
        self._state = state
        self._acceptance = EnsembleSampler.acceptance_fraction(state)
        return self

    # -- summaries ----------------------------------------------------------
    def _require_run(self):
        if self.chain_free is None:
            raise RuntimeError("run() first")

    def free_hyper_names(self):
        names = self.population.hyper_names
        self._require_run()
        return [names[i] for i in self.free_space.free_idx]

    @property
    def flatchain(self):
        """(nsamp, nfree) flattened hyper chain."""
        self._require_run()
        return self.chain_free.reshape(-1, self.chain_free.shape[-1])

    def hyper_chain(self, param):
        self._require_run()
        i = self._param_index(param)
        cols = list(self.free_space.free_idx)
        if i not in cols:
            raise ValueError(
                f"hyper-parameter {param!r} is fixed; no chain for it")
        return self.flatchain[:, cols.index(i)]

    def par_cen(self, param, percentile=68.3):
        """(central, +err, -err) hyper-posterior summary (the package's
        par_cen convention)."""
        c = self.hyper_chain(param)
        q = 0.5 * (100.0 - percentile)
        lo, med, hi = np.percentile(c, [q, 50.0, 100.0 - q])
        return np.array([med, hi - med, med - lo])

    def best_fit(self):
        """(phi_full, lnprob) at the maximum-lnprob hyper sample."""
        self._require_run()
        flat_lnp = self.lnprobability.reshape(-1)
        i = int(np.argmax(flat_lnp))
        phi = self.free_space.expand(self.flatchain[i])
        return phi, float(flat_lnp[i])

    @property
    def acceptance_fraction(self):
        self._require_run()
        return self._acceptance

    def gelman_rubin(self):
        self._require_run()
        return self.free_hyper_names(), split_rhat(self.chain_free)

    def autocorrelation_time(self):
        self._require_run()
        return autocorrelation_time(self.chain_free)

    def compute_evidence(self, nlive=512, nbatch=32, nsteps=32,
                         max_iter=3000, tol=1e-4, seed=None, verbose=False):
        """Bayesian evidence ln Z of THIS population model by nested
        sampling over the hyper box (nested.py): difference two runs on the
        same catalog for the Bayes factor between, e.g., the independent
        and correlated families, or free against fixed sigma. The prior is
        the normalized uniform over the free hyper box times any Gaussian
        hyper-priors and the model's ln_hyper_prior. Returns a NestedResult
        with samples in the full hyper space; also stored as
        self.evidence."""
        from mbb_emcee_tpu_torch.nested import nested_sample

        lnprob, free_space = build_hier_lnprob(
            self.samples, self.population, self._effective_spec(),
            ln_interim=self.ln_interim, selection=self.selection,
            dtype=self.dtype, device=self.device, mesh=self.mesh)
        res = nested_sample(
            lambda x: lnprob(x).to(torch.float32), free_space.lower,
            free_space.upper,
            philox_key(self.seed if seed is None else int(seed)),
            nlive=nlive, nbatch=nbatch, nsteps=nsteps, max_iter=max_iter,
            tol=tol, device=self.device)
        res = dataclasses.replace(res,
                                  samples=free_space.expand(res.samples))
        self.evidence = res
        if verbose:
            print(f"HierarchicalFitter ln Z = {res.logz:.4f} "
                  f"+- {res.logz_err:.4f}")
        return res

    # -- importance-weight diagnostics --------------------------------------
    def reweight_ess(self, phi=None):
        """(S,) effective sample size of the per-source importance weights
        at hyper vector `phi` (full, nhyper-sized; default = the
        hyper-posterior median). ESS_s near N means the reweighting is
        benign; ESS_s of a few means source s's stored chain barely covers
        the population there (refit it with a tighter interim prior or more
        samples)."""
        phi = self._phi(phi)
        samples = torch.as_tensor(self.samples, dtype=self.dtype,
                                  device=self.device)
        lw = self.population.ln_dist(phi, samples)
        if self.ln_interim is not None:
            lw = lw - torch.as_tensor(self.ln_interim, dtype=self.dtype,
                                      device=self.device)
        lw = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
        return torch.exp(-torch.logsumexp(2.0 * lw, dim=-1)).cpu().numpy()

    def plot_population(self, param, **kw):
        """Population band + per-source-median histogram for one
        parameter (see plotting.plot_population)."""
        from mbb_emcee_tpu_torch.plotting import plot_population
        self._require_run()
        return plot_population(self, param, **kw)

    # -- persistence ---------------------------------------------------------
    def writeToHDF5(self, path):
        """Persist the whole tier: hyper chain, the (S, N, K) sample tensor
        and interim-prior values, the hyper spec, the selection and the
        population configuration (the JAX package's layout; from_h5
        restores the built-in families, a custom model is passed back)."""
        self._require_run()
        import h5py
        pop = self.population
        with h5py.File(path, "w") as f:
            f.attrs["kind"] = "hierarchy"
            f.attrs["hyper_names"] = np.array(
                [n.encode() for n in pop.hyper_names])
            f.attrs["free_idx"] = self.free_space.free_idx
            f.attrs["nwalkers"] = self.nwalkers
            f.attrs["seed"] = self.seed
            f.attrs["a"] = self.a
            f.attrs["thin"] = self.thin
            f.create_dataset("chain_free", data=self.chain_free)
            f.create_dataset("lnprobability", data=self.lnprobability)
            f.create_dataset("hyper_lower", data=np.asarray(pop.lower))
            f.create_dataset("hyper_upper", data=np.asarray(pop.upper))
            f.create_dataset("reweight_ess", data=self.reweight_ess())
            f.create_dataset("samples", data=self.samples,
                             compression="gzip")
            if self.ln_interim is not None:
                f.create_dataset("ln_interim", data=self.ln_interim,
                                 compression="gzip")
            spec = self._spec
            g = f.create_group("Spec")
            for name in ("lower", "upper", "fixed", "fixed_values",
                         "prior_mean", "prior_isigma"):
                g.create_dataset(name, data=np.asarray(getattr(spec, name)))
            if self.selection is not None:
                g = f.create_group("Selection")
                g.create_dataset("injections",
                                 data=self.selection.injections,
                                 compression="gzip")
                g.create_dataset("ln_pdet", data=self.selection.ln_pdet)
                g.create_dataset("ln_draw", data=self.selection.ln_draw)
                g.attrs["n_total"] = self.selection.n_total
            if isinstance(pop, (TruncatedGaussianPopulation,
                                CorrelatedGaussianPopulation)):
                g = f.create_group("Population")
                g.attrs["class"] = type(pop).__name__
                g.attrs["param_names"] = np.array(
                    [n.encode() for n in pop.param_names])
                g.attrs["sigma_log_uniform"] = pop.sigma_log_uniform
                g.create_dataset("box_lower", data=pop.box_lower)
                g.create_dataset("box_upper", data=pop.box_upper)
                g.create_dataset("sigma_min", data=pop.sigma_min)
                g.create_dataset("sigma_max", data=pop.sigma_max)
                if isinstance(pop, CorrelatedGaussianPopulation):
                    g.attrs["rho_max"] = pop.rho_max
        return self

    @classmethod
    def from_h5(cls, path, population=None, device=None):
        """Reload a persisted population fit (either package's file):
        summaries and ESS work at once; run()/compute_evidence() re-fit
        from the stored samples (extend() needs a fresh run: the sampler
        state is not stored). Built-in families rebuild themselves; a
        custom model is passed back via `population`. device: as the
        constructor's."""
        import h5py
        with h5py.File(path, "r") as f:
            if f.attrs.get("kind") != "hierarchy":
                raise ValueError(f"{path} is not a hierarchy HDF5 file")
            if population is None:
                if "Population" not in f:
                    raise ValueError(
                        "this file was written with a custom population "
                        "model; pass it back via population=")
                g = f["Population"]
                names = tuple(n.decode() for n in g.attrs["param_names"])
                kw = dict(sigma_min=g["sigma_min"][...],
                          sigma_max=g["sigma_max"][...],
                          sigma_log_uniform=bool(
                              g.attrs["sigma_log_uniform"]))
                if g.attrs["class"] == "CorrelatedGaussianPopulation":
                    population = CorrelatedGaussianPopulation.for_box(
                        names, g["box_lower"][...], g["box_upper"][...],
                        rho_max=float(g.attrs["rho_max"]), **kw)
                else:
                    population = TruncatedGaussianPopulation.for_box(
                        names, g["box_lower"][...], g["box_upper"][...],
                        **kw)
            ln_interim = (f["ln_interim"][...] if "ln_interim" in f
                          else None)
            hf = cls(f["samples"][...], population,
                     ln_interim=ln_interim,
                     nwalkers=int(f.attrs["nwalkers"]),
                     seed=int(f.attrs["seed"]), a=float(f.attrs["a"]),
                     device=device)
            g = f["Spec"]
            hf._spec = LikelihoodSpec(
                lower=g["lower"][...], upper=g["upper"][...],
                fixed=g["fixed"][...].astype(bool),
                fixed_values=g["fixed_values"][...],
                prior_mean=g["prior_mean"][...],
                prior_isigma=g["prior_isigma"][...])
            hf.free_space = FreeSpace.from_spec(hf._spec)
            hf.chain_free = f["chain_free"][...]
            hf.lnprobability = f["lnprobability"][...]
            hf.thin = int(f.attrs["thin"])
            if "Selection" in f:
                g = f["Selection"]
                hf.selection = Selection(
                    injections=g["injections"][...],
                    ln_pdet=g["ln_pdet"][...],
                    ln_draw=g["ln_draw"][...],
                    n_total=int(g.attrs["n_total"]))
        return hf


def fit_population(batch, params, nburn=200, nsteps=1000, thin=1,
                   verbose=False, **kw):
    """One-call population fit over a finished batch run: build the
    hyper-fitter with `HierarchicalFitter.from_batch(batch, params, **kw)`
    and run it. Returns the fitted HierarchicalFitter."""
    hf = HierarchicalFitter.from_batch(batch, params, **kw)
    return hf.run(nburn=nburn, nsteps=nsteps, thin=thin, verbose=verbose)


def run_population_stage(mf, args, outfile):
    """The batch CLI's --population stage: fit the hyper-posterior over the
    just-finished batch, write the hyper chain (the caller has already
    written the batch file, so a failure here loses nothing), save the
    --plot-population figures (headless; one per parameter, suffixed for
    more than one) and return the report text to print. `args` carries the
    CLI's population_* and plot_population fields."""
    hf = fit_population(
        mf, params=tuple(args.population),
        nburn=args.population_burn, nsteps=args.population_steps,
        nwalkers=args.population_walkers,
        sigma_log_uniform=args.population_sigma_log_uniform,
        correlated=args.population_correlated,
        verbose=args.verbose)
    ess = hf.reweight_ess()
    lines = [f"population ({mf.nsources} sources, "
             f"{hf.samples.shape[1]} samples/source):"]
    for p in args.population:
        mu = hf.par_cen(f"mu_{p}")
        sig = hf.par_cen(f"sigma_{p}")
        lines.append(f"  {p}: mu {mu[0]:.4g} +{mu[1]:.2g} -{mu[2]:.2g}"
                     f"   sigma {sig[0]:.4g} +{sig[1]:.2g} -{sig[2]:.2g}")
    if args.population_correlated:
        a, b = args.population
        rho = hf.par_cen(f"rho_{a}_{b}")
        lines.append(f"  rho({a},{b}) {rho[0]:.3f} +{rho[1]:.2g} "
                     f"-{rho[2]:.2g}")
    lines.append(f"  reweight ESS min {ess.min():.0f} / median "
                 f"{np.median(ess):.0f} of {hf.samples.shape[1]}")
    popfile = getattr(args, "population_out", None)
    if popfile is None:
        base = outfile[:-3] if outfile.endswith(".h5") else outfile
        popfile = base + ".pop.h5"
    hf.writeToHDF5(popfile)
    lines.append(f"  hyper chain written to {popfile}")
    plot_spec = getattr(args, "plot_population", None)
    if plot_spec:
        import matplotlib
        matplotlib.use("Agg")
        base, ext = (plot_spec.rsplit(".", 1) if "." in plot_spec
                     else (plot_spec, "png"))
        for p in args.population:
            path = (f"{base}.{ext}" if len(args.population) == 1
                    else f"{base}_{p}.{ext}")
            hf.plot_population(p, savefig=path)
            lines.append(f"  population figure -> {path}")
    return "\n".join(lines)
