"""Modified (grey) blackbody SED, batched over a leading theta dimension.

Torch twin of mbb_emcee_tpu/models/modified_blackbody.py, same physics and
the same fp32 log-space formulas:

    S_nu(lambda) propto (1 - e^-tau) * x^3 / (e^x - 1)
        tau = (lambda0 / lambda)^beta,   x = h c / (lambda k T)
    optically thin limit:  S_nu propto x^(3+beta) / (e^x - 1)
    Wien-side power law:   for x > x_merge, S propto x^-alpha, where
        x_merge solves  d ln S / d ln x = -alpha   (slope continuity)
    Normalization: S(wavenorm) = fnorm (default wavenorm = 500 um).

The merge solve is 6 bisections plus 2 clamped Newton steps on the analytic
bracket x_m in (2 + alpha, 3 + alpha + beta). Parameters are observer frame:
theta = (T/(1+z), beta, lambda0*(1+z), alpha, fnorm). The CUDA lnprob kernel
(csrc/lnprob.cuh) evaluates these formulas per walker.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import HCOK_UM_K, C_UM_HZ
from mbb_emcee_tpu_torch.ops.special import log_expm1, log1mexp, xoexpm1x
from mbb_emcee_tpu_torch.ops.rootfind import (
    bisect_newton_decreasing, golden_max)
from mbb_emcee_tpu_torch.ops.quadrature import loglam_nodes

MERGE_BISECT = 6
MERGE_NEWTON = 2
# Above TAU_BIG, tau/(e^tau - 1) is numerically zero.
TAU_BIG = 60.0
LOG_C2 = math.log(HCOK_UM_K)


@dataclasses.dataclass(frozen=True)
class MBBShape:
    """Model-shape switches."""
    opthin: bool = False
    noalpha: bool = False
    wavenorm: float = 500.0


def _log_s_mbb(log_x, beta, log_x0, opthin: bool):
    """Unnormalized ln S of the pure greybody (no Wien merge) at u = ln x."""
    x = torch.exp(log_x)
    log_planck = 3.0 * log_x - log_expm1(x)
    if opthin:
        return beta * log_x + log_planck
    tau = torch.exp(beta * (log_x - log_x0))
    return log1mexp(tau) + log_planck


def _merge_g_and_gp(log_x, beta, log_x0, alpha, opthin: bool):
    """(g, g') for the merge solve, g(u) = d ln S / d ln u + alpha, with
    g' from q(x) = x + h(x), dq/du = q (1 - h), h(y) = y/(e^y - 1)."""
    x = torch.exp(log_x)
    q = x / (-torch.expm1(-torch.clamp(x, min=1e-30)))
    gp_planck = -q * (1.0 - q + x)
    if opthin:
        return 3.0 + beta - q + alpha, gp_planck
    tau = torch.exp(beta * (log_x - log_x0))
    ht = xoexpm1x(tau)
    # clamp tau in the product: for huge tau ht is exactly 0 and inf*0 = NaN
    tau_c = torch.clamp(tau, max=TAU_BIG)
    gp = beta * beta * ht * (1.0 - tau_c - ht) + gp_planck
    return 3.0 + beta * ht - q + alpha, gp


def merge_bracket(beta, alpha):
    """(lo, hi) in ln x bracketing the merge point: (2 + alpha, 3 + alpha +
    beta). Finite floors keep it valid for unphysical alpha <= -2 or
    beta < 0 reachable through user-set limits."""
    lo_arg = torch.clamp(2.0 + alpha, min=1e-3)
    return (torch.log(lo_arg),
            torch.log(torch.maximum(3.0 + alpha + beta, 1.01 * lo_arg)))


def merge_log_x(beta, log_x0, alpha, opthin: bool):
    """ln x_merge where d ln S / d ln x = -alpha (Wien-side merge point)."""
    return bisect_newton_decreasing(
        lambda u: _merge_g_and_gp(u, beta, log_x0, alpha, opthin),
        *merge_bracket(beta, alpha), bisect_iters=MERGE_BISECT,
        newton_iters=MERGE_NEWTON)


def log_mbb_fnu_params(T, beta, lambda0, alpha, fnorm, wave,
                       shape: MBBShape = MBBShape()):
    """ln f_nu with the five parameters given as separate tensors that
    broadcast against `wave` (observer-frame micron). This is the core the
    batched entry points below and the peak finder share."""
    log_T = torch.log(T)
    log_x = LOG_C2 - torch.log(wave) - log_T
    log_x0 = LOG_C2 - torch.log(lambda0) - log_T

    if shape.noalpha:
        def log_s(u):
            return _log_s_mbb(u, beta, log_x0, shape.opthin)
    else:
        u_m = merge_log_x(beta, log_x0, alpha, shape.opthin)
        ls_m = _log_s_mbb(u_m, beta, log_x0, shape.opthin)

        def log_s(u):
            # Power law S propto x^-alpha blueward of the merge point,
            # continuous in value and slope at u_m.
            return torch.where(u > u_m, ls_m - alpha * (u - u_m),
                               _log_s_mbb(u, beta, log_x0, shape.opthin))

    # (LOG_C2 - ln wavenorm) is formed in fp64 and rounded once; the
    # kernel receives the same fp32 constant.
    log_x_norm = (LOG_C2 - math.log(shape.wavenorm)) - log_T
    return torch.log(fnorm) + log_s(log_x) - log_s(log_x_norm)


def log_mbb_fnu(theta, wave, shape: MBBShape = MBBShape()):
    """ln f_nu at observer-frame wavelengths, in the units of fnorm.

    theta: (..., 5) parameter rows (T, beta, lambda0, alpha, fnorm);
    wave: tensor of wavelengths shared by every row. Returns
    theta.shape[:-1] + wave.shape."""
    wave = torch.as_tensor(wave, dtype=theta.dtype, device=theta.device)
    bshape = theta.shape[:-1] + (1,) * wave.dim()
    p = [theta[..., i].reshape(bshape) for i in range(5)]
    return log_mbb_fnu_params(*p, wave, shape)


def mbb_fnu(theta, wave, shape: MBBShape = MBBShape()):
    """f_nu at observer-frame wavelengths (micron); units of fnorm."""
    return torch.exp(log_mbb_fnu(theta, wave, shape))


class ModifiedBlackbody:
    """Object surface of one greybody, mirroring the reference class
    (T, beta, lambda0, alpha, fnorm, wavenorm=500, noalpha, opthin);
    mbb(wave) -> f_nu. Evaluates on the CPU in fp32."""

    def __init__(self, T, beta, lambda0, alpha, fnorm,
                 wavenorm=500.0, noalpha=False, opthin=False):
        self._params = torch.tensor([T, beta, lambda0, alpha, fnorm],
                                    dtype=torch.float32)
        self._shape = MBBShape(opthin=bool(opthin), noalpha=bool(noalpha),
                               wavenorm=float(wavenorm))

    T = property(lambda self: float(self._params[0]))
    beta = property(lambda self: float(self._params[1]))
    lambda0 = property(lambda self: float(self._params[2]))
    alpha = property(lambda self: float(self._params[3]))
    fnorm = property(lambda self: float(self._params[4]))
    wavenorm = property(lambda self: self._shape.wavenorm)
    optically_thin = property(lambda self: self._shape.opthin)
    has_alpha = property(lambda self: not self._shape.noalpha)

    def __call__(self, wave):
        wave = torch.atleast_1d(torch.as_tensor(np.asarray(wave),
                                                dtype=torch.float32))
        return mbb_fnu(self._params, wave, self._shape)

    def freq_integrate(self, minwave, maxwave, nnodes=128):
        """Integral of f_nu d nu over observer-frame wavelengths in
        [minwave, maxwave] micron, in units of fnorm * Hz: fixed-node
        Gauss-Legendre in ln-lambda with the large c applied in fp64."""
        lam, w = loglam_nodes(int(nnodes), float(minwave), float(maxwave))
        f = self(lam.astype(np.float32)).double().numpy()
        return float(C_UM_HZ * np.sum(w / lam ** 2 * f))

    def peak_lambda(self, lo=1.0, hi=5.0e4, iters=64):
        """Observer-frame wavelength (micron) of the f_nu maximum, by the
        fixed-iteration golden-section the results layer batches."""
        p = self._params

        def log_flux(u):
            return log_mbb_fnu_params(p[0], p[1], p[2], p[3], p[4],
                                      torch.exp(u), self._shape)

        um, _ = golden_max(log_flux, torch.tensor(math.log(lo)),
                           torch.tensor(math.log(hi)), iters=int(iters))
        return float(torch.exp(um))

    def merge_x(self):
        """x value of the Wien-side merge point (None if noalpha)."""
        if self._shape.noalpha:
            return None
        p = self._params
        log_x0 = LOG_C2 - torch.log(p[2]) - torch.log(p[0])
        return float(torch.exp(merge_log_x(p[1], log_x0, p[3],
                                           self._shape.opthin)))

    def __repr__(self):
        kind = "optically-thin" if self._shape.opthin else "optically-thick"
        merge = "no Wien merge" if self._shape.noalpha else \
            f"alpha={self.alpha:.3g}"
        return (f"ModifiedBlackbody({kind}, T={self.T:.4g}K, "
                f"beta={self.beta:.4g}, lambda0={self.lambda0:.4g}um, "
                f"{merge}, fnorm={self.fnorm:.4g} @ {self.wavenorm:.4g}um)")
