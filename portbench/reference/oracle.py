"""fp64 NumPy/SciPy modified blackbody: scipy.optimize.brentq for the Wien
merge, scipy.integrate.quad for frequency integration.

Frozen copy of tests/reference_impl/mbb_oracle.py (the whole file, lines
1-117, as of the commit that added this benchmark), kept here so that the
benchmark's yardstick cannot move with the repository's test helpers. It
makes the benchmark's mock photometry (mockdata.py) and anchors the
vectorised reference (model.py) in the benchmark's tests.
"""

import numpy as np
from scipy import integrate, optimize

HCOK = 14387.768775039337  # h c / k, micron K
C_UM_HZ = 2.99792458e14


class ModifiedBlackbodyOracle:
    def __init__(self, T, beta, lambda0, alpha, fnorm,
                 wavenorm=500.0, noalpha=False, opthin=False):
        self.T = float(T)
        self.beta = float(beta)
        self.lambda0 = float(lambda0)
        self.alpha = float(alpha)
        self.fnorm = float(fnorm)
        self.wavenorm = float(wavenorm)
        self.noalpha = bool(noalpha)
        self.opthin = bool(opthin)

        self._x0 = HCOK / (self.lambda0 * self.T)

        if not self.noalpha:
            # Solve d ln S / d ln x = -alpha with Brent's method.
            self._x_merge = optimize.brentq(
                lambda x: self._dlns_dlnx(x) + self.alpha, 1e-3, 1e4,
                xtol=1e-12, rtol=8.9e-16)
            self._s_merge = self._s_mbb(self._x_merge)
            # Power-law amplitude from value continuity: A x^-alpha.
            self._pl_amp = self._s_merge * self._x_merge ** self.alpha
        else:
            self._x_merge = np.inf
            self._pl_amp = None

        self._norm = self.fnorm / self._s(HCOK / (self.wavenorm * self.T))

    # -- pure-shape pieces (unnormalized), linear space fp64 ----------------
    def _s_mbb(self, x):
        x = np.asarray(x, dtype=np.float64)
        planck = x ** 3 / np.expm1(x)
        if self.opthin:
            return x ** self.beta * planck
        tau = (x / self._x0) ** self.beta
        return -np.expm1(-tau) * planck

    def _dlns_dlnx(self, x):
        q = x / -np.expm1(-x)
        if self.opthin:
            return 3.0 + self.beta - q
        tau = (x / self._x0) ** self.beta
        if tau > 700:
            opac = 0.0
        else:
            opac = self.beta * tau / np.expm1(tau) if tau > 1e-12 \
                else self.beta * (1 - tau / 2)
        return 3.0 + opac - q

    def _s(self, x):
        x = np.asarray(x, dtype=np.float64)
        mbb = self._s_mbb(np.minimum(x, self._x_merge)
                          if not self.noalpha else x)
        if self.noalpha:
            return mbb
        pl = self._pl_amp * x ** (-self.alpha)
        return np.where(x > self._x_merge, pl, mbb)

    # -- public surface ------------------------------------------------------
    def __call__(self, wave):
        """f_nu at observer wavelengths (micron), units of fnorm."""
        x = HCOK / (np.asarray(wave, dtype=np.float64) * self.T)
        return self._norm * self._s(x)

    def merge_x(self):
        return None if self.noalpha else self._x_merge

    def freq_integrate(self, minwave, maxwave):
        """int f_nu dnu over observer wavelength range [minwave, maxwave] um,
        adaptive QUADPACK in ln-lambda."""
        def integrand(u):
            lam = np.exp(u)
            # dnu = c/lam^2 dlam; dlam = lam du  =>  f * c / lam du
            return float(self(lam)) * C_UM_HZ / lam

        val, _ = integrate.quad(integrand, np.log(minwave), np.log(maxwave),
                                limit=200, epsabs=0.0, epsrel=1e-10)
        return val

    def peak_lambda(self, lo=5.0, hi=5000.0):
        """Observer wavelength (um) of the f_nu maximum."""
        res = optimize.minimize_scalar(
            lambda u: -float(self(np.exp(u))),
            bounds=(np.log(lo), np.log(hi)), method="bounded",
            options={"xatol": 1e-12})
        return float(np.exp(res.x))
