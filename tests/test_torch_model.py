"""The port's greybody model against the JAX package's, on shared numpy
inputs, plus the analytic goldens of tests/test_physics.py re-run on the
port."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape, ModifiedBlackbody as JModifiedBlackbody,
    log_mbb_fnu as j_log_mbb_fnu)
from mbb_emcee_tpu_torch.constants import HCOK_UM_K, C_UM_HZ  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, ModifiedBlackbody, log_mbb_fnu, mbb_fnu, merge_log_x)
from tests.reference_impl.mbb_oracle import (  # noqa: E402
    ModifiedBlackbodyOracle)

THETA = np.array([35.0, 1.8, 350.0, 3.0, 40.0], dtype=np.float32)
SHAPES = [(True, True), (False, True), (False, False)]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _sampling_region(n, seed):
    """Parameter vectors over the region the parity configs' walkers
    explore (the ranges of test_physics.test_parity_vs_oracle)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(10.0, 80.0, n), rng.uniform(0.5, 3.5, n),
                     rng.uniform(50.0, 800.0, n), rng.uniform(1.0, 6.0, n),
                     rng.uniform(5.0, 100.0, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("opthin,noalpha", SHAPES,
                         ids=["thin", "thick", "full"])
def test_log_mbb_fnu_matches_jax(opthin, noalpha):
    """2000 random theta x 25 wavelengths; fp32 on both sides with the
    same formulas in another op order: atol 5e-5 on ln f_nu."""
    th = _sampling_region(2000, seed=1 + 2 * opthin + noalpha)
    wave = np.geomspace(30.0, 3000.0, 25).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: j_log_mbb_fnu(p, jnp.asarray(wave),
                                JShape(opthin=opthin, noalpha=noalpha))))(
        jnp.asarray(th)))
    got = log_mbb_fnu(_t(th), _t(wave),
                      MBBShape(opthin=opthin, noalpha=noalpha)).numpy()
    assert got.shape == (2000, 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("opthin,noalpha", list(itertools.product(
    (False, True), (False, True))))
def test_normalization(opthin, noalpha):
    """S(wavenorm) = fnorm exactly, for all shape variants."""
    shape = MBBShape(opthin=opthin, noalpha=noalpha, wavenorm=500.0)
    f = mbb_fnu(_t(THETA), _t([500.0]), shape)
    np.testing.assert_allclose(f.numpy(), [THETA[4]], rtol=1e-4)


def test_rayleigh_jeans_slope():
    """Long-wavelength (x << 1, tau << 1) slope: f propto
    lambda^-(2+beta)."""
    f = mbb_fnu(_t([30.0, 2.0, 100.0, 4.0, 50.0]), _t([2.0e5, 4.0e5]))
    slope = (torch.log(f[1]) - torch.log(f[0])) / np.log(2.0)
    np.testing.assert_allclose(float(slope), -4.0, atol=5e-3)


def test_opthin_matches_thick_when_transparent():
    theta = _t([35.0, 1.8, 1.0, 3.0, 40.0])      # lambda0 = 1 um
    lam = _t([100.0, 250.0, 500.0, 1000.0])
    f_thick = mbb_fnu(theta, lam, MBBShape(opthin=False, noalpha=True))
    f_thin = mbb_fnu(theta, lam, MBBShape(opthin=True, noalpha=True))
    np.testing.assert_allclose(f_thick.numpy(), f_thin.numpy(), rtol=5e-4)


def test_merge_continuity():
    """Value continuity at x_merge; slope -alpha on the power-law side."""
    mbb = ModifiedBlackbody(*THETA)
    xm = mbb.merge_x()
    assert xm is not None and 1.0 < xm < 100.0
    lam_m = HCOK_UM_K / (xm * THETA[0])
    f = mbb(np.array([lam_m * 1.001, lam_m * 0.999])).numpy()
    np.testing.assert_allclose(f[0], f[1], rtol=2e-2)
    fb = mbb(np.array([lam_m / 8.0, lam_m / 4.0])).numpy()
    slope = (np.log(fb[1]) - np.log(fb[0])) / np.log(2.0)
    np.testing.assert_allclose(slope, THETA[3], rtol=1e-3)


def test_wien_merge_brightens_blue_side():
    lam = _t([20.0, 40.0])
    f_m = mbb_fnu(_t(THETA), lam, MBBShape(noalpha=False))
    f_n = mbb_fnu(_t(THETA), lam, MBBShape(noalpha=True))
    assert bool(torch.all(f_m > f_n))


@pytest.mark.parametrize("opthin,noalpha", list(itertools.product(
    (False, True), (False, True))))
def test_parity_vs_oracle(opthin, noalpha):
    """fp32 port model vs the fp64 scipy oracle (rtol 2e-3, the JAX
    package's golden tolerance)."""
    rng = np.random.default_rng(42)
    lam = np.geomspace(30.0, 3000.0, 25)
    shape = MBBShape(opthin=opthin, noalpha=noalpha)
    for _ in range(20):
        theta = np.array([rng.uniform(10.0, 80.0), rng.uniform(0.5, 3.5),
                          rng.uniform(50.0, 800.0), rng.uniform(1.0, 6.0),
                          rng.uniform(5.0, 100.0)], dtype=np.float32)
        want = ModifiedBlackbodyOracle(*theta.astype(np.float64),
                                       opthin=opthin, noalpha=noalpha)(lam)
        got = mbb_fnu(_t(theta), _t(lam), shape).double().numpy()
        mask = want > 1e-12 * want.max()
        np.testing.assert_allclose(got[mask], want[mask], rtol=2e-3)


def test_log_flux_finite_over_prior_box():
    rng = np.random.default_rng(7)
    n = 256
    thetas = np.stack([
        rng.uniform(1.0, 200.0, n), rng.uniform(0.1, 8.0, n),
        rng.uniform(1.0, 5000.0, n), rng.uniform(0.1, 15.0, n),
        rng.uniform(1e-3, 1e3, n)], axis=1)
    out = log_mbb_fnu(_t(thetas), _t(np.geomspace(5.0, 1e4, 16)))
    assert bool(torch.all(torch.isfinite(out)))


def test_merge_solve_prior_box_corners():
    """The hybrid merge solve at the default prior-box corners, against
    an fp64 brentq (the JAX package's golden, 1e-5 in ln x)."""
    from scipy.optimize import brentq
    corners = dict(beta=[0.01, 2.0, 20.0], alpha=[0.01, 10.0, 60.0],
                   T=[0.1, 30.0, 1000.0], lam0=[1.0, 2000.0, 2e4])
    combos = np.array(list(itertools.product(*corners.values())))
    b, a, T, l0 = combos.T
    log_x0 = np.log(HCOK_UM_K) - np.log(l0) - np.log(T)

    def dlns(u, bb, lx0):
        x = np.exp(u)
        q = x / (-np.expm1(-x)) if x > 1e-8 else 1 + x / 2
        tau = np.exp(min(bb * (u - lx0), 700))
        if tau <= 1e-8:
            h = 1 - tau / 2
        elif tau < 700:
            h = tau / np.expm1(tau)
        else:
            h = 0.0
        return 3 + bb * h - q

    got = merge_log_x(_t(b), _t(log_x0), _t(a), False).double().numpy()
    for i in range(len(b)):
        want = brentq(lambda u: dlns(u, b[i], log_x0[i]) + a[i],
                      np.log(1e-3), np.log(1e4), xtol=1e-13)
        assert abs(got[i] - want) < 1e-5, (b[i], a[i], T[i], l0[i])


@pytest.mark.parametrize("theta,opthin", [
    ((35.0, 1.9, 250.0, 3.5, 40.0), False),
    ((20.0, 1.2, 100.0, 2.5, 10.0), True),
    ((28.0, 2.2, 400.0, 5.0, 30.0), False)])
def test_peak_lambda_and_freq_integrate_match_jax(theta, opthin):
    mine = ModifiedBlackbody(*theta, opthin=opthin)
    ref = JModifiedBlackbody(*theta, opthin=opthin)
    np.testing.assert_allclose(mine.peak_lambda(), ref.peak_lambda(),
                               rtol=1e-4)
    np.testing.assert_allclose(mine.freq_integrate(8.0, 1000.0),
                               ref.freq_integrate(8.0, 1000.0), rtol=1e-4)


def test_freq_integrate_matches_adaptive_quad():
    import scipy.integrate as si
    theta = (35.0, 1.9, 250.0, 3.5, 40.0)
    got = ModifiedBlackbody(*theta).freq_integrate(8.0, 1000.0)
    o = ModifiedBlackbodyOracle(*theta)
    want, _ = si.quad(lambda lam: o(np.array([lam]))[0] * C_UM_HZ / lam ** 2,
                      8.0, 1000.0, limit=200)
    assert abs(got - want) / want < 1e-3
