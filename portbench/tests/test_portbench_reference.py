"""The plain reference against the frozen fp64 oracle and hand values."""

import math

import numpy as np
import pytest
import torch
from scipy import integrate

from portbench.reference import model as M
from portbench.reference.oracle import ModifiedBlackbodyOracle

THETAS = np.array([[32.0, 1.9, 250.0, 3.5, 45.0],
                   [20.0, 1.5, 100.0, 2.0, 10.0],
                   [50.0, 2.5, 400.0, 6.0, 100.0],
                   [15.0, 1.2, 600.0, 1.2, 3.0]])
WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
SHAPE = M.Shape()


@pytest.mark.parametrize("i", range(len(THETAS)))
def test_model_matches_the_oracle(i):
    th = THETAS[i]
    oracle = ModifiedBlackbodyOracle(*th)
    got = torch.exp(M.log_fnu(torch.tensor(th[None]), torch.tensor(WAVE),
                              SHAPE))[0].numpy()
    np.testing.assert_allclose(got, oracle(WAVE), rtol=1e-12)
    um = float(M.merge_logx(torch.tensor(th[None]), SHAPE)[0])
    assert math.exp(um) == pytest.approx(oracle.merge_x(), rel=1e-12)


@pytest.mark.parametrize("i", range(len(THETAS)))
def test_lir_matches_the_oracles_quadrature(i):
    th, z = THETAS[i], 1.5
    oracle = ModifiedBlackbodyOracle(*th)
    dl_m = M.luminosity_distance_mpc(np.array([z]), 69.32, 0.2865)[0] \
        * M.MPC_M
    want = (4 * np.pi * dl_m ** 2 * M.MJY_WM2HZ / M.LSUN_W
            * oracle.freq_integrate(8 * (1 + z), 1000 * (1 + z)))
    got = M.lir_lsun(torch.tensor(th[None]), np.array([z]), SHAPE, 69.32,
                     0.2865)[0]
    assert got == pytest.approx(want, rel=1e-8)


@pytest.mark.parametrize("i", range(len(THETAS)))
def test_peak_matches_the_oracle(i):
    th = THETAS[i]
    got = M.peak_lambda_um(torch.tensor(th[None]), SHAPE)[0]
    assert got == pytest.approx(
        ModifiedBlackbodyOracle(*th).peak_lambda(5.0, 5000.0), rel=1e-6)


def test_dustmass_by_hand():
    th, z = THETAS[0], 2.0
    lam = 125.0 * 3.0
    s = ModifiedBlackbodyOracle(*th)(np.array([lam]))[0]
    x = M.HCOK / (lam * th[0])
    nu = M.C_M_S / 125e-6
    b = 2 * M.H_JS * nu ** 3 / M.C_M_S ** 2 / math.expm1(x)
    dl = M.luminosity_distance_mpc(np.array([z]), 69.32, 0.2865)[0] \
        * M.MPC_M
    want = dl ** 2 * s * 1e-29 / (3.0 * 2.64 * b) / M.MSUN_KG
    got = M.dustmass_msun(torch.tensor(th[None]), np.array([z]), SHAPE,
                          69.32, 0.2865)[0]
    assert got == pytest.approx(want, rel=1e-12)


def test_luminosity_distance():
    assert M.luminosity_distance_mpc(np.array([0.0]), 70.0, 0.3)[0] == 0.0
    z = 1e-4      # D_L -> cz / H0
    assert M.luminosity_distance_mpc(np.array([z]), 70.0, 0.3)[0] == \
        pytest.approx(M.C_KM_S * z / 70.0, rel=1e-3)
    zz = 2.0
    dc, _ = integrate.quad(
        lambda t: 1 / math.sqrt(0.2865 * (1 + t) ** 3 + 0.7135), 0, zz,
        epsabs=0, epsrel=1e-13)
    assert M.luminosity_distance_mpc(np.array([zz]), 69.32, 0.2865)[0] == \
        pytest.approx(3 * M.C_KM_S / 69.32 * dc, rel=1e-12)


def test_lnprob_by_hand():
    th = THETAS[0]
    flux = np.array([11.0, 30.0, 44.0, 38.0, np.nan])   # band 4 missing
    unc = np.array([0.8, 1.9, 2.4, 2.1, 1.5])
    f = ModifiedBlackbodyOracle(*th)(WAVE)
    chi = ((f[:4] - flux[:4]) / unc[:4]) ** 2
    pri = ((th[2] - 250.0) / 120.0) ** 2 + ((th[3] - 3.5) / 1.5) ** 2
    lo, hi = [0.1, 0.01, 1.0, 0.01, 1e-5], [100.0, 5.0, 2e4, 60.0, 1e7]
    mean = [0, 0, 250.0, 3.5, 0]
    sig = [np.inf, np.inf, 120.0, 1.5, np.inf]
    got = M.lnprob(torch.tensor(th[None]), WAVE, flux, unc, lo, hi, mean,
                   sig, SHAPE)[0].item()
    assert got == pytest.approx(-0.5 * (chi.sum() + pri), rel=1e-12)
    out = th.copy()
    out[0] = 101.0
    assert M.lnprob(torch.tensor(out[None]), WAVE, flux, unc, lo, hi, mean,
                    sig, SHAPE)[0].item() == -math.inf


def test_percentile_summary():
    s = np.arange(101, dtype=float)
    np.testing.assert_allclose(M.percentile_summary(s),
                               [50.0, 34.15, 34.15])


def test_posterior_summary_of_a_known_density():
    """The importance sampler's percentiles of a correlated Gaussian, cut
    by a box on one side, against the exact ones: the median and the
    68.3% half-widths of the free marginals, and the truncated one's
    exact percentiles."""
    from scipy import stats
    from portbench.reference import posterior
    mean = np.array([30.0, 2.0, 250.0, 3.5, 45.0])
    sd = np.array([3.0, 0.2, 60.0, 1.5, 2.0])
    corr = np.eye(5)
    corr[0, 1] = corr[1, 0] = -0.6
    corr[0, 2] = corr[2, 0] = 0.5
    cov = corr * np.outer(sd, sd)
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu = torch.as_tensor(mean)
    lo_alpha = 2.0

    def lnp(t):
        d = t - mu
        out = -0.5 * ((d @ prec) * d).sum(-1)
        return torch.where(t[:, 3] >= lo_alpha, out,
                           torch.full_like(out, -math.inf))
    g = torch.Generator().manual_seed(5)
    cen, ess = posterior.posterior_summary(
        lnp, mean * 1.1, sd * 2.0, g, rounds=5, n_round=1 << 14,
        n_final=1 << 17, block=1 << 17)
    assert ess > 1e4
    z = stats.norm.ppf(0.5 + 0.683 / 2)
    for j in (0, 1, 2, 4):
        np.testing.assert_allclose(cen[j], [mean[j], z * sd[j], z * sd[j]],
                                   atol=0.03 * sd[j])
    tn = stats.truncnorm((lo_alpha - mean[3]) / sd[3], np.inf, mean[3],
                         sd[3])
    q = tn.ppf([0.5 - 0.683 / 2, 0.5, 0.5 + 0.683 / 2])
    np.testing.assert_allclose(cen[3], [q[1], q[2] - q[1], q[1] - q[0]],
                               atol=0.03 * sd[3])
