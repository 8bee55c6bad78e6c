"""The port's submm photo-z model (photoz.py) against the JAX package's on
the CPU: photoz_mbb's fnu on the same thetas for every combination of cmb,
opthin and noalpha with z at both bounds, the exact (T, lambda0, z)
scaling degeneracy without CMB terms, the z-bounds validation, and the
z-marginalized dust mass of one fit (compute_dustmass) and of a catalog
(compute_dustmass_batch) on samples shared with the JAX package; then
twins of tests/test_photoz.py's identities and refusals. The forecasts of
the photo-z model are in tests/test_torch_forecast.py."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import photoz as jphotoz  # noqa: E402
from mbb_emcee_tpu.models import cmb as jcmb  # noqa: E402
from mbb_emcee_tpu.models.cosmology import (  # noqa: E402
    Cosmology as JCosmology)
from mbb_emcee_tpu_torch import derived  # noqa: E402
from mbb_emcee_tpu_torch.models.cmb import cmb_corrected_mbb  # noqa: E402
from mbb_emcee_tpu_torch.models.cosmology import (  # noqa: E402
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)
from mbb_emcee_tpu_torch.photoz import (  # noqa: E402
    PARAM_NAMES, PhotoZMBBModel, compute_dustmass, compute_dustmass_batch,
    dustmass_cen, photoz_mbb)
from mbb_emcee_tpu_torch.sed import (  # noqa: E402
    SEDFitter, SEDModel, SEDResults, batched_fnu)

WAVE = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
TRUTH6 = np.array([38.0, 1.9, 80.0, 3.0, 10.0, 4.0])
VARIANTS = [(cmb, opthin, noalpha) for cmb in (False, True)
            for opthin in (False, True) for noalpha in (False, True)]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _thetas(n=256, seed=1):
    """n parameter rows in the default box's populated part, with z at
    both bounds of [0, 12] and just inside them."""
    rng = np.random.default_rng(seed)
    th = np.column_stack([
        rng.uniform(15.0, 60.0, n), rng.uniform(1.0, 2.5, n),
        rng.uniform(50.0, 300.0, n), rng.uniform(1.0, 5.0, n),
        rng.uniform(1.0, 50.0, n), rng.uniform(0.0, 12.0, n)])
    th[:8, 5], th[8:16, 5] = 0.0, 12.0
    th[16:24, 5], th[24:32, 5] = 1e-3, 11.99
    return th.astype(np.float32)


@pytest.mark.parametrize("cmb,opthin,noalpha", VARIANTS,
                         ids=[f"cmb{int(c)}-thin{int(t)}-noalpha{int(a)}"
                              for c, t, a in VARIANTS])
def test_fnu_matches_jax(cmb, opthin, noalpha):
    """fnu of 256 thetas x 6 bands, vmapped in both packages, z at both
    bounds: |ln f_port - ln f_jax| <= 1e-5 (rtol 1e-5 on f_nu). With CMB
    terms the visibility ln(1 - r) amplifies an ulp of ln r by
    r / (1 - r) = e^-vis - 1 near T_dust ~ T_CMB(z), at each band and at
    the normalization point; the tolerance carries that as
    2e-6 (e^-vis - 1), as tests/test_torch_cmb.py does."""
    th = _thetas()
    tm = photoz_mbb(cmb=cmb, opthin=opthin, noalpha=noalpha)
    jm = jphotoz.photoz_mbb(cmb=cmb, opthin=opthin, noalpha=noalpha)
    assert (tm.name, tm.param_names) == (jm.name, jm.param_names)
    np.testing.assert_array_equal(tm.lower, jm.lower)
    np.testing.assert_array_equal(tm.upper, jm.upper)
    got = batched_fnu(tm.fnu)(_t(th), _t(WAVE)).numpy()
    want = np.asarray(jax.vmap(lambda p: jm.fnu(p, _j(WAVE)))(_j(th)))
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    tol = np.full(got.shape, 1e-5)
    if cmb:
        z = th[:, 5]
        t_d = jcmb.dust_temperature_with_cmb(_j(th[:, 0]), _j(th[:, 1]),
                                             _j(z))
        vis = np.asarray(jcmb.log_cmb_visibility(
            _j(WAVE[None, :] / (1.0 + z[:, None])), t_d[:, None],
            _j(z)[:, None]))
        vis_n = np.asarray(jcmb.log_cmb_visibility(
            _j(500.0 / (1.0 + z)), t_d, _j(z)))
        tol += 2e-6 * (np.expm1(-vis) + np.expm1(-vis_n)[:, None])
    d = np.abs(np.log(got) - np.log(want))
    assert np.all(d <= tol), float(np.max(d - tol))


@pytest.mark.parametrize("z", [0.0, 1.5, 4.0, 8.0])
def test_degeneracy_identity_no_cmb(z):
    """Without CMB terms the rest-frame photo-z model IS the observer-frame
    MBB under (T, lambda0, z) -> (T / (1 + z), lambda0 (1 + z)): the exact
    scaling degeneracy the module docstring warns about (rtol 3e-6)."""
    opz = 1.0 + z
    m = photoz_mbb(cmb=False)
    a = m.fnu(_t([35.0, 1.9, 80.0, 3.0, 12.0, z]), _t(WAVE)).numpy()
    b = mbb_fnu(_t([35.0 / opz, 1.9, 80.0 * opz, 3.0, 12.0]), _t(WAVE),
                MBBShape()).numpy()
    np.testing.assert_allclose(a, b, rtol=3e-6)


def test_matches_fixed_z_cmb_factory():
    """photoz_mbb(cmb=True) at theta = (..., z) is cmb_corrected_mbb(z):
    the fixed-z model is the z slice of the photo-z model (rtol 3e-6)."""
    z = 3.0
    a = photoz_mbb(cmb=True).fnu(_t([35.0, 1.9, 80.0, 3.0, 12.0, z]),
                                 _t(WAVE)).numpy()
    b = cmb_corrected_mbb(z=z).fnu(_t([35.0, 1.9, 80.0, 3.0, 12.0]),
                                   _t(WAVE)).numpy()
    np.testing.assert_allclose(a, b, rtol=3e-6)


@pytest.mark.parametrize("opthin,noalpha", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_variants_pass_validate(opthin, noalpha):
    """Every variant evaluates finite at the box center and batches and
    differentiates under torch.func.vmap (SEDModel.validate), so it runs
    on every sampler tier; an SEDFitter takes it."""
    m = photoz_mbb(opthin=opthin, noalpha=noalpha)
    assert isinstance(m, PhotoZMBBModel) and m.param_names == PARAM_NAMES
    m.validate(WAVE, device="cpu")
    SEDFitter(m, nwalkers=16, device="cpu")


def test_zbounds_validation():
    with pytest.raises(ValueError, match="z_lower"):
        photoz_mbb(z_lower=5.0, z_upper=2.0)
    with pytest.raises(ValueError, match="z_lower"):
        photoz_mbb(z_lower=-1.0)
    m = photoz_mbb(z_lower=1.0, z_upper=6.0)
    assert m.lower[5] == 1.0 and m.upper[5] == 6.0
    jm = jphotoz.photoz_mbb(z_lower=1.0, z_upper=6.0)
    np.testing.assert_array_equal(m.lower, jm.lower)
    np.testing.assert_array_equal(m.upper, jm.upper)


def test_equal_arguments_give_equal_models_not_one_object():
    """The JAX package memoizes photoz_mbb so its fitters share traced
    programs; the port has no traced programs and no memo: two calls with
    the same arguments give two models with the same configuration and the
    same fluxes."""
    a, b = photoz_mbb(cmb=True, z_upper=8.0), photoz_mbb(cmb=True,
                                                         z_upper=8.0)
    assert a is not b
    assert (a.name, a.param_names, a.cmb, a.opthin, a.noalpha, a.t_cmb0,
            a.wavenorm) == (b.name, b.param_names, b.cmb, b.opthin,
                            b.noalpha, b.t_cmb0, b.wavenorm)
    np.testing.assert_array_equal(a.lower, b.lower)
    th = _t(TRUTH6)
    assert torch.equal(a.fnu(th, _t(WAVE)), b.fnu(th, _t(WAVE)))


# -- the dust mass on samples shared with the JAX package ----------------------

def _samples(n=400, seed=4, z=None):
    """A photo-z chain's stand-in: n (T, beta, lambda0, alpha, fnorm, z)
    rows around TRUTH6 (z fixed at `z` when given)."""
    rng = np.random.default_rng(seed)
    s = TRUTH6[None, :] * rng.uniform(0.85, 1.15, (n, 6))
    if z is not None:
        s[:, 5] = z
    return s


def _fake(model, samples, cosmo):
    """The attributes compute_dustmass reads from an SEDResults."""
    return SimpleNamespace(
        lumdist=None, _cosmo=cosmo, device=torch.device("cpu"),
        dustmass_chain=None, dustmass_meta=None,
        _require_model=lambda: model,
        _thinned=lambda thin: samples[::thin])


@pytest.mark.parametrize("cmb", [False, True], ids=["no-cmb", "cmb"])
def test_dustmass_matches_jax(cmb):
    """compute_dustmass on one chain of 400 samples, each with its own z,
    against the JAX package's on the same samples: rtol 1e-4; the meta and
    dustmass_cen follow."""
    s = _samples()
    tm = photoz_mbb(cmb=cmb, z_upper=8.0)
    jm = jphotoz.photoz_mbb(cmb=cmb, z_upper=8.0)
    res = _fake(tm, s, Cosmology.named("WMAP9"))
    got = compute_dustmass(res, thin=2)
    want = jphotoz.compute_dustmass(
        _fake(jm, s, JCosmology.named("WMAP9")), thin=2)
    assert got.shape == (200,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert res.dustmass_meta == {"kappa": 2.64, "kappa_wave": 125.0,
                                 "thin": 2, "z_param": "z"}
    np.testing.assert_allclose(dustmass_cen(res),
                               jphotoz.dustmass_cen(SimpleNamespace(
                                   dustmass_chain=want)), rtol=1e-4)


def test_dustmass_batch_matches_jax():
    """compute_dustmass_batch of a 3-source catalog's (S, N, 6) samples
    against the JAX package's on the same samples: rtol 1e-4."""
    s = np.stack([_samples(n=64, seed=k) for k in range(3)])
    tm = photoz_mbb(cmb=True, z_upper=8.0)
    jm = jphotoz.photoz_mbb(cmb=True, z_upper=8.0)
    mf = SimpleNamespace(model=tm, _thinned=lambda thin: _t(s[:, ::thin]))
    got = compute_dustmass_batch(mf, thin=2)
    jmf = SimpleNamespace(model=jm,
                          _thinned=lambda thin: _j(s[:, ::thin]))
    want = jphotoz.compute_dustmass_batch(jmf, thin=2)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert mf.dustmass_meta["z_param"] == "z"


def test_dustmass_no_cmb_matches_core_formula():
    """Under the degeneracy map the no-CMB photo-z dust mass equals the
    observer-frame MBB's (derived.dustmass_integrand and prefactor) sample
    by sample (rtol 5e-4)."""
    z0 = 2.5
    opz = 1.0 + z0
    s = _samples(n=100, z=z0)
    dm = compute_dustmass(_fake(photoz_mbb(cmb=False), s,
                                Cosmology.named("WMAP9")))
    th_obs = s[:, :5].copy()
    th_obs[:, 0] /= opz
    th_obs[:, 2] *= opz
    g = derived.dustmass_integrand(MBBShape())(
        _t(th_obs), torch.tensor(125.0 * opz)).double().numpy()
    oracle = derived.dustmass_prefactor(luminosity_distance(z0), opz, 2.64,
                                        125.0) * g
    np.testing.assert_allclose(dm, oracle, rtol=5e-4)


def test_dustmass_requires_photoz_model():
    plain = SEDModel(fnu=lambda th, w: w * 0 + th[0], param_names=("a",),
                     lower=[0.0], upper=[1.0])
    with pytest.raises(TypeError, match="PhotoZMBBModel"):
        compute_dustmass(_fake(plain, np.ones((4, 1)), None))


def test_lir_zparam_and_dustmass_reject_explicit_lumdist():
    """A sampled redshift contradicts an explicit lumdist= on both derived
    surfaces (a short fit on the CPU)."""
    model = photoz_mbb(cmb=False)
    f = model.fnu(_t(TRUTH6), _t(WAVE)).double().numpy()
    fit = SEDFitter(model, nwalkers=16, seed=9, device="cpu")
    fit.set_data(WAVE, f, 0.07 * f)
    fit.fix_param("alpha", TRUTH6[3])
    fit.set_gaussian_prior("T", 38.0, 6.0)
    for nm, v in zip(model.param_names, TRUTH6):
        fit.set_param_init(nm, v, 0.05 * abs(v))
    fit.run(nburn=4, nsteps=8)
    res = SEDResults(fit=fit, lumdist=5000.0)
    with pytest.raises(ValueError, match="lumdist"):
        res.compute_lir(z_param="z")
    with pytest.raises(ValueError, match="lumdist"):
        compute_dustmass(res)
    dm = compute_dustmass(fit.results(), thin=4)
    assert dm.shape == (16 * 8 // 4,) and np.all(dm > 0)
