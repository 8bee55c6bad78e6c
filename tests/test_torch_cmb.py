"""The port's CMB heating/background corrections (models/cmb.py) against
the JAX package's on shared numpy inputs (rtol 1e-5), then twins of
tests/test_cmb.py's six tests: the physics invariants of the da Cunha+2013
equations, the plain-MBB limit, and an end-to-end generic-tier fit at high
z on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu.models import cmb as jcmb  # noqa: E402
from mbb_emcee_tpu_torch.models.cmb import (  # noqa: E402
    T_CMB0, cmb_temperature, dust_temperature_with_cmb,
    log_cmb_visibility, cmb_corrected_mbb)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    mbb_fnu, MBBShape)
from mbb_emcee_tpu_torch.sed import SEDFitter, batched_fnu  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- against the JAX package ---------------------------------------------------

def test_functions_match_jax():
    """dust_temperature_with_cmb and log_cmb_visibility on 400 random
    (T, beta, z) and rest wavelengths against the JAX package's, fp32 on
    both sides: rtol 1e-5. Near T_dust ~ T_CMB(z) the visibility
    ln(1 - r) amplifies an ulp of its log-ratio ln r (a difference of two
    fp32 ln-expm1 terms of up to ~10) by r / (1 - r) = e^-vis - 1, which
    the tolerance carries as 2e-6 (e^-vis - 1)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(3.0, 120.0, 400).astype(np.float32)
    beta = rng.uniform(0.5, 3.5, 400).astype(np.float32)
    wave = np.geomspace(20.0, 3000.0, 400).astype(np.float32)
    for z in (0.0, 1.0, 4.0, 8.0):
        got = dust_temperature_with_cmb(_t(t), _t(beta), z).numpy()
        want = np.asarray(jcmb.dust_temperature_with_cmb(
            jnp.asarray(t), jnp.asarray(beta), z))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        got_v = log_cmb_visibility(_t(wave), _t(got), z).numpy()
        want_v = np.asarray(jcmb.log_cmb_visibility(
            jnp.asarray(wave), jnp.asarray(got), z))
        tol = 1e-5 * np.abs(want_v) + 1e-7 + 2e-6 * np.expm1(-want_v)
        assert np.all(np.abs(got_v - want_v) <= tol), z
    assert cmb_temperature(3.0) == jcmb.cmb_temperature(3.0)
    assert T_CMB0 == jcmb.T_CMB0


@pytest.mark.parametrize("z,opthin,noalpha", [
    (5.0, True, True), (2.0, False, True), (4.0, False, False)],
    ids=["thin", "thick", "full"])
def test_fnu_matches_jax(z, opthin, noalpha):
    """The model's fnu on 64 random thetas x 6 observed bands, vmapped in
    both packages, against the JAX model's: rtol 1e-5 without the Wien
    merge; with it, the merge solve's fp32 rounding (5e-5 in ln f_nu,
    tests/test_torch_model.py) sets the tolerance."""
    rng = np.random.default_rng(int(10 * z))
    th = np.stack([rng.uniform(15.0, 60.0, 64), rng.uniform(1.0, 2.5, 64),
                   rng.uniform(80.0, 300.0, 64), rng.uniform(2.0, 5.0, 64),
                   rng.uniform(1.0, 50.0, 64)], axis=1).astype(np.float32)
    wave = np.array([250.0, 450.0, 850.0, 1300.0, 2000.0, 3000.0],
                    np.float32)
    tm = cmb_corrected_mbb(z, opthin=opthin, noalpha=noalpha)
    jm = jcmb.cmb_corrected_mbb(z, opthin=opthin, noalpha=noalpha)
    assert tm.name == jm.name and tm.param_names == jm.param_names
    np.testing.assert_array_equal(tm.lower, jm.lower)
    got = batched_fnu(tm.fnu)(_t(th), _t(wave)).numpy()
    want = np.asarray(jax.vmap(lambda p: jm.fnu(p, jnp.asarray(wave)))(
        jnp.asarray(th)))
    rtol = 5e-5 if not noalpha else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol)


# -- twins of tests/test_cmb.py --------------------------------------------------

def test_dust_temperature_invariants():
    f32 = torch.float32
    # z = 0: exactly the intrinsic temperature.
    np.testing.assert_allclose(
        float(dust_temperature_with_cmb(torch.tensor(25.0, dtype=f32),
                                        torch.tensor(2.0, dtype=f32), 0.0)),
        25.0, rtol=1e-6)
    for z in (2.0, 5.0, 8.0):
        t_floor = cmb_temperature(z)
        t_d = float(dust_temperature_with_cmb(_t(1e-3), _t(2.0), z))
        np.testing.assert_allclose(t_d, t_floor, rtol=1e-3)  # fp32
        t_warm = float(dust_temperature_with_cmb(_t(30.0), _t(2.0), z))
        assert t_warm > 30.0
        assert float(dust_temperature_with_cmb(_t(30.0), _t(2.0),
                                               z + 1.0)) > t_warm
    # Against the direct (non-log) formula in fp64.
    t, beta, z = 18.0, 1.8, 4.0
    p = 4.0 + beta
    direct = (t ** p + T_CMB0 ** p * ((1 + z) ** p - 1.0)) ** (1.0 / p)
    np.testing.assert_allclose(
        float(dust_temperature_with_cmb(_t(t), _t(beta), z)), direct,
        rtol=1e-6)
    # fp32-safety: warm dust at high beta (direct T^p overflows fp32).
    v = float(dust_temperature_with_cmb(_t(500.0), _t(10.0), 2.0))
    assert np.isfinite(v) and v >= 500.0


def test_cmb_visibility_limits():
    lv = float(log_cmb_visibility(_t(100.0), 35.0, 1.0))
    assert -1e-4 < lv <= 0.0
    t_floor = cmb_temperature(4.0)
    lv2 = float(log_cmb_visibility(_t(2000.0), t_floor * 1.0001, 4.0))
    assert lv2 < -4.0 and np.isfinite(lv2)
    cold = 1.3 * t_floor
    a = float(log_cmb_visibility(_t(500.0), cold, 4.0))
    b = float(log_cmb_visibility(_t(3000.0), cold, 4.0))
    assert b < a < 0.0


def test_matches_plain_mbb_for_warm_dust():
    z = 1.0
    model = cmb_corrected_mbb(z, wavenorm=500.0)
    theta = _t([35.0, 2.0, 120.0, 3.0, 40.0])
    w_obs = _t([100.0, 250.0, 500.0, 850.0])
    got = model.fnu(theta, w_obs).double().numpy()
    shape = MBBShape(wavenorm=500.0 / (1 + z))
    w_rest = w_obs / (1 + z)
    vis = np.exp(log_cmb_visibility(w_rest, 35.0, z).double().numpy())
    vis_norm = float(np.exp(float(log_cmb_visibility(
        _t(500.0 / (1 + z)), 35.0, z))))
    plain = mbb_fnu(theta, w_rest, shape).double().numpy()
    np.testing.assert_allclose(got, plain * vis / vis_norm, rtol=1e-3)
    np.testing.assert_allclose(got[2], 40.0, rtol=1e-5)


def test_cold_high_z_flux_suppressed():
    z = 5.0

    def suppression(t_int):
        theta = _t([t_int, 2.0, 100.0, 3.0, 1.0])
        w = _t([3000.0 * (1 + z)])
        got = float(cmb_corrected_mbb(z).fnu(theta, w)[0])
        t_d = float(dust_temperature_with_cmb(theta[0], theta[1], z))
        th = _t([t_d, 2.0, 100.0, 3.0, 1.0])
        shape = MBBShape(wavenorm=500.0 / (1 + z))
        plain = float(mbb_fnu(th, w / (1 + z), shape)[0])
        return got / plain

    s_cold = suppression(20.0)
    s_warm = suppression(60.0)
    assert 0.0 < s_cold < s_warm <= 1.05


def test_end_to_end_recovery_at_high_z():
    z = 4.0
    model = cmb_corrected_mbb(z, opthin=True, noalpha=True)
    true = _t([22.0, 1.8, 100.0, 3.0, 8.0])
    w_obs = np.array([450.0, 850.0, 1300.0, 2000.0, 3000.0])
    f = model.fnu(true, _t(w_obs)).double().numpy()
    unc = 0.05 * f
    rng = np.random.default_rng(12)
    flux = f + unc * rng.standard_normal(f.size)

    fit = SEDFitter(model, nwalkers=48, seed=6, device="cpu")
    fit.set_data(w_obs, flux, unc)
    fit.fix_param("lambda0", 100.0)
    fit.fix_param("alpha", 3.0)
    fit.set_uplim("T", 60.0)
    fit.set_uplim("beta", 4.0)
    for nm, v in (("T", 22.0), ("beta", 1.8), ("fnorm", 8.0)):
        fit.set_param_init(nm, v, 0.1 * v)
    fit.run(nburn=60, nsteps=150)
    res = fit.results()
    t_med, t_plus, t_minus = res.par_cen("T")
    assert abs(t_med - 22.0) < 4.0 * max(t_plus, t_minus)
    assert abs(res.par_cen("fnorm")[0] - 8.0) < 3.0


def test_factory_validation():
    with pytest.raises(ValueError):
        cmb_corrected_mbb(-0.5)
    m = cmb_corrected_mbb(2.0, name="custom")
    assert m.name == "custom"
    assert cmb_corrected_mbb(2.0).name == "cmb-mbb-z2"
    m.validate(wave=np.array([250.0, 500.0]), device="cpu")
