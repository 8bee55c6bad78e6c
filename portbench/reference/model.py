"""The plain reference of the benchmark: the modified blackbody, its
posterior density and the derived quantities, vectorised over samples in
plain PyTorch.

In float64 on the CPU this is the reference that decides `correct`; the
same functions in bfloat16 are the control (the precision below the
port's float32). It is written from the physics, as oracle.py is, and
shares no code or number with the program: the Wien merge is a bisection
over the whole bracket of oracle.py (not the port's analytic bracket), the
L_IR integral is split at the merge point, and the SED peak is the root of
the SED's slope (not a golden-section search).

Parameters are observer frame, theta = (T, beta, lambda0, alpha, fnorm);
S(x) propto (1 - exp(-tau)) x^3 / (e^x - 1), tau = (x / x0)^beta,
x = hc / (lambda k T), x0 = hc / (lambda0 k T); blueward of the point where
d ln S / d ln x = -alpha the SED is the power law x^-alpha, continuous in
value and slope; S(wavenorm) = fnorm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HCOK = 14387.768775039337          # h c / k, micron K
C_UM_HZ = 2.99792458e14            # c, micron Hz
C_KM_S = 299792.458
C_M_S = 2.99792458e8
H_JS = 6.62607015e-34
MPC_M = 3.0856775814913673e22
MJY_WM2HZ = 1e-29                  # 1 mJy in W m^-2 Hz^-1
# The unit conventions the configuration states for L_IR and the dust
# mass (the IAU nominal solar luminosity; the solar mass of the upstream
# package's astropy constants).
LSUN_W = 3.828e26
MSUN_KG = 1.98892e30

# The merge and the peak lie in x in [1e-3, 1e4] (oracle.py's bracket).
LOGX_LO, LOGX_HI = math.log(1e-3), math.log(1e4)
BISECT_ITERS = 80
# The port's search window for the observed peak wavelength (micron); a
# peak outside it is reported at the window's edge.
PEAK_WINDOW = (1.0, 5.0e4)


def _log_expm1(x):
    """ln(e^x - 1) for x > 0, without overflow."""
    big = x > 20.0
    xs = torch.where(big, torch.ones_like(x), x)
    return torch.where(big, x + torch.log1p(-torch.exp(-x)),
                       torch.log(torch.expm1(xs)))


def _log1mexp(t):
    """ln(1 - e^-t) for t > 0."""
    small = t < math.log(2.0)
    return torch.where(small, torch.log(-torch.expm1(-t)),
                       torch.log1p(-torch.exp(-t)))


class Shape:
    """Model switches of a configuration."""

    def __init__(self, opthin=False, noalpha=False, wavenorm=500.0):
        self.opthin = bool(opthin)
        self.noalpha = bool(noalpha)
        self.wavenorm = float(wavenorm)


def free_indices(shape):
    """The parameters the density depends on: lambda0 (index 2) only where
    the dust can be optically thick, alpha (3) only with the Wien-side
    power law. A fit holds the others fixed."""
    return [i for i in range(5)
            if not (i == 2 and shape.opthin) and not (i == 3 and shape.noalpha)]


def _split(theta):
    return [theta[..., i] for i in range(5)]


def _log_s_grey(u, beta, logx0, shape):
    """Unnormalised ln S of the greybody at u = ln x."""
    x = torch.exp(u)
    log_planck = 3.0 * u - _log_expm1(x)
    if shape.opthin:
        return beta * u + log_planck
    return _log1mexp(torch.exp(beta * (u - logx0))) + log_planck


def _slope(u, beta, logx0, shape):
    """d ln S / d ln x of the greybody at u = ln x."""
    x = torch.exp(u)
    q = x / -torch.expm1(-x)
    if shape.opthin:
        return 3.0 + beta - q
    tau = torch.exp(beta * (u - logx0))
    tiny = tau < 1e-12
    ts = torch.where(tiny, torch.ones_like(tau), tau)
    h = torch.where(tiny, 1.0 - tau / 2.0, ts / torch.expm1(ts))
    h = torch.where(tau > 700.0, torch.zeros_like(h), h)
    return 3.0 + beta * h - q


def _bisect_decreasing(fn, lo, hi, iters=BISECT_ITERS):
    """The root of a decreasing fn on [lo, hi], elementwise."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = fn(mid) > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def merge_logx(theta, shape):
    """ln x of the Wien merge point, per sample."""
    T, beta, lam0, alpha, _ = _split(theta)
    logx0 = math.log(HCOK) - torch.log(lam0) - torch.log(T)
    lo = torch.full_like(T, LOGX_LO)
    hi = torch.full_like(T, LOGX_HI)
    return _bisect_decreasing(
        lambda u: _slope(u, beta, logx0, shape) + alpha, lo, hi)


def log_fnu(theta, wave, shape):
    """ln f_nu (units of fnorm) of samples theta (n, 5) at observed
    wavelengths wave (n, m) or (m,) in micron: (n, m)."""
    T, beta, lam0, alpha, fnorm = (p[:, None] for p in _split(theta))
    logT = torch.log(T)
    logx0 = math.log(HCOK) - torch.log(lam0) - logT
    u = math.log(HCOK) - torch.log(wave) - logT
    unorm = math.log(HCOK) - math.log(shape.wavenorm) - logT
    if shape.noalpha:
        def log_s(v):
            return _log_s_grey(v, beta, logx0, shape)
    else:
        um = merge_logx(theta, shape)[:, None]
        lsm = _log_s_grey(um, beta, logx0, shape)

        def log_s(v):
            return torch.where(v > um, lsm - alpha * (v - um),
                               _log_s_grey(torch.minimum(v, um), beta,
                                           logx0, shape))
    return torch.log(fnorm) + log_s(u) - log_s(unorm)


def lnprob(theta, wave, flux, unc, lower, upper, prior_mean, prior_sigma,
           shape, pack=None):
    """The posterior density the fit samples, up to a constant, at samples
    theta (n, 5): Gaussian band residuals (a band with a non-finite flux
    or uncertainty is missing and left out), Gaussian priors where
    prior_sigma is finite, and -inf outside the box [lower, upper].

    A band's model flux is f_nu at its wavelength, or with a filter-response
    pack (waves, weights), each (nbands, nnodes) (response.py), the
    quadrature sum_i W_i f_nu(lambda_i) over its curve; the pack is
    rounded to theta's dtype like every other input."""
    dt = theta.dtype
    dev = theta.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt)

    flux = np.asarray(flux, np.float64)
    unc = np.asarray(unc, np.float64)
    ok = np.isfinite(flux) & np.isfinite(unc)
    if pack is None:
        f = torch.exp(log_fnu(theta, t(np.asarray(wave)[ok]), shape))
    else:
        waves, weights = (np.asarray(a, np.float64)[ok] for a in pack)
        s = torch.exp(log_fnu(theta, t(waves.reshape(-1)), shape))
        f = torch.sum(s.reshape(-1, *waves.shape) * t(weights), dim=-1)
    r = (f - t(flux[ok])) / t(unc[ok])
    out = -0.5 * torch.sum(r * r, dim=-1)
    sig = np.asarray(prior_sigma, np.float64)
    has = np.isfinite(sig)
    if has.any():
        d = (theta[:, torch.as_tensor(np.nonzero(has)[0], device=dev)]
             - t(np.asarray(prior_mean)[has])) / t(sig[has])
        out = out - 0.5 * torch.sum(d * d, dim=-1)
    inbox = torch.all((theta >= t(lower)) & (theta <= t(upper)), dim=-1)
    return torch.where(inbox, out, torch.full_like(out, -math.inf))


# -- derived quantities ------------------------------------------------------
def _gauss_legendre(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


def luminosity_distance_mpc(z, h0, om0):
    """D_L in Mpc of a flat Lambda-CDM universe without radiation, fp64:
    (1 + z) c / H0 int_0^z dz' / sqrt(Om (1 + z')^3 + 1 - Om)."""
    z = np.asarray(z, np.float64)
    x, w = _gauss_legendre(200)
    zz = 0.5 * z[..., None] * (x + 1.0)
    e = np.sqrt(om0 * (1.0 + zz) ** 3 + (1.0 - om0))
    dc = C_KM_S / h0 * 0.5 * z * np.sum(w / e, axis=-1)
    return (1.0 + z) * dc


def _panel_integral(fn, a, b, n):
    """int_a^b fn(u) du per sample by n-node Gauss-Legendre; a, b (ns,)."""
    x, w = _gauss_legendre(n)
    x = torch.as_tensor(x, dtype=a.dtype, device=a.device)
    w = torch.as_tensor(w, dtype=a.dtype, device=a.device)
    half = 0.5 * (b - a)
    u = a[:, None] + half[:, None] * (x + 1.0)
    return half * torch.sum(w * fn(u), dim=-1)


def lir_lsun(theta, z, shape, h0, om0, wavemin=8.0, wavemax=1000.0,
             nodes=256):
    """L_IR in L_sun per sample: 4 pi D_L^2 int f_nu dnu over rest
    wavelengths [wavemin, wavemax], i.e. observed [wavemin, wavemax](1+z),
    with f_nu in mJy; the integral in ln lambda is split at the Wien merge
    point, where the SED's second derivative jumps. z (n,) per sample."""
    dt = theta.dtype
    opz = 1.0 + np.asarray(z, np.float64)
    a = torch.as_tensor(np.log(wavemin * opz), device=theta.device).to(dt)
    b = torch.as_tensor(np.log(wavemax * opz), device=theta.device).to(dt)

    def fn(u):
        # f_nu dnu = f_nu c / lambda dln(lambda)
        return torch.exp(log_fnu(theta, torch.exp(u), shape) - u) * C_UM_HZ

    if shape.noalpha:
        total = _panel_integral(fn, a, b, nodes)
    else:
        # the merge point in ln(observed wavelength)
        um = (math.log(HCOK) - merge_logx(theta, shape)
              - torch.log(theta[:, 0]))
        cut = torch.minimum(torch.maximum(um, a), b)
        total = _panel_integral(fn, a, cut, nodes) + _panel_integral(
            fn, cut, b, nodes)
    dl_m = luminosity_distance_mpc(z, h0, om0) * MPC_M
    prefac = 4.0 * np.pi * dl_m ** 2 * MJY_WM2HZ / LSUN_W
    return total.double().cpu().numpy() * prefac


def dustmass_msun(theta, z, shape, h0, om0, kappa=2.64, kappa_wave=125.0):
    """Dust mass in M_sun per sample: D_L^2 S_nu(obs) / ((1 + z) kappa
    B_nu(T_rest)) at the rest wavelength kappa_wave, kappa in m^2/kg.
    Observed and rest-frame x = h nu / k T agree, so B_nu's exponent is
    x = hc / (kappa_wave (1 + z) k T_obs)."""
    dt = theta.dtype
    opz = 1.0 + np.asarray(z, np.float64)
    lam = torch.as_tensor(kappa_wave * opz, device=theta.device).to(dt)
    s_mjy = torch.exp(log_fnu(theta, lam[:, None], shape))[:, 0]
    x = HCOK / (lam * theta[:, 0])
    g = (s_mjy * torch.expm1(x)).double().cpu().numpy()
    nu = C_M_S / (kappa_wave * 1e-6)
    bamp = 2.0 * H_JS * nu ** 3 / C_M_S ** 2
    dl_m = luminosity_distance_mpc(z, h0, om0) * MPC_M
    return dl_m ** 2 * MJY_WM2HZ * g / (opz * kappa * bamp) / MSUN_KG


def peak_lambda_um(theta, shape):
    """Observed wavelength (micron) of the f_nu maximum per sample: the root
    of the greybody's d ln S / d ln x (the power law blueward of the merge
    only falls), in the window PEAK_WINDOW."""
    T, beta, lam0, alpha, _ = _split(theta)
    logx0 = math.log(HCOK) - torch.log(lam0) - torch.log(T)
    lo = torch.full_like(T, LOGX_LO)
    hi = (torch.full_like(T, LOGX_HI) if shape.noalpha
          else merge_logx(theta, shape))
    u = _bisect_decreasing(lambda v: _slope(v, beta, logx0, shape), lo, hi)
    lam = HCOK / (torch.exp(u) * T)
    return torch.clamp(lam, *PEAK_WINDOW).double().cpu().numpy()


def percentile_summary(samples, percentile=68.3):
    """(median, +err, -err) along the last axis, numpy's linear
    percentiles in fp64."""
    p = float(percentile)
    lo, mid, hi = np.percentile(np.asarray(samples, np.float64),
                                [50.0 - p / 2, 50.0, 50.0 + p / 2], axis=-1)
    return np.stack([mid, hi - mid, mid - lo], axis=-1)
