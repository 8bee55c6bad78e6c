"""The port's one luminosity-distance path (mbb_emcee_tpu_torch/models/
cosmology.py) and the batch tier's distances (BatchEngine._dl_mpc) on the
CPU: the vectorised pass and the scalar Cosmology methods against
closed-form distances (Einstein-de Sitter, de Sitter, Milne), z <= 0 at
zero, and _dl_mpc against a per-redshift Gauss-Legendre evaluation written
out here, under every named set and an open and a closed cosmology; its
lumdists= passthrough and explicit D_L; one rule built per call, and one
mbb.derived.distance span recording how many redshifts it covered."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch import MultiFitter  # noqa: E402
from mbb_emcee_tpu_torch.constants import C_KM_S  # noqa: E402
from mbb_emcee_tpu_torch.models.cosmology import (  # noqa: E402
    PARAMETER_SETS, Cosmology, luminosity_distance,
    luminosity_distance_batch)
from mbb_emcee_tpu_torch.utils import profiling  # noqa: E402

H0 = 70.0
DH = C_KM_S / H0
ZS = np.array([0.01, 0.3, 1.0, 2.5, 4.0, 7.5])

# name: (cosmology, D_C(z), D_L(z)) in closed form
CLOSED_FORM = {
    "einstein_de_sitter": (
        Cosmology(H0=H0, Om0=1.0),
        lambda z: 2.0 * DH * (1.0 - (1.0 + z) ** -0.5),
        lambda z: (1.0 + z) * 2.0 * DH * (1.0 - (1.0 + z) ** -0.5)),
    "de_sitter": (
        Cosmology(H0=H0, Om0=0.0, Ol0=1.0),
        lambda z: DH * z,
        lambda z: (1.0 + z) * DH * z),
    "milne": (
        Cosmology(H0=H0, Om0=0.0, Ol0=0.0),
        lambda z: DH * np.log1p(z),
        lambda z: DH * z * (1.0 + 0.5 * z)),
}


@pytest.mark.parametrize("case", CLOSED_FORM)
def test_batch_pass_matches_closed_form(case):
    cosmo, _, dl = CLOSED_FORM[case]
    np.testing.assert_allclose(luminosity_distance_batch(ZS, cosmo), dl(ZS),
                               rtol=1e-12)


@pytest.mark.parametrize("case", CLOSED_FORM)
@pytest.mark.parametrize("z", ZS)
def test_scalar_methods_match_closed_form(case, z):
    cosmo, dc, dl = CLOSED_FORM[case]
    got_dl = cosmo.luminosity_distance(z)
    got_dc = cosmo.comoving_distance(z)
    assert type(got_dl) is float and type(got_dc) is float
    assert got_dl == pytest.approx(dl(z), rel=1e-12)
    assert got_dc == pytest.approx(dc(z), rel=1e-12)
    assert luminosity_distance(z, cosmo) == got_dl


@pytest.mark.parametrize("case", CLOSED_FORM)
@pytest.mark.parametrize("z", [0.0, -0.3, -2.0])
def test_nonpositive_redshift_is_at_zero(case, z):
    cosmo = CLOSED_FORM[case][0]
    assert cosmo.comoving_distance(z) == 0.0
    assert cosmo.luminosity_distance(z) == 0.0
    got = luminosity_distance_batch(np.array([z, 1.0]), cosmo)
    assert got[0] == 0.0 and got[1] > 0.0


def _gl_loop(zs, cosmo):
    """Each redshift's D_L by its own 128-node rule on [0, z]."""
    out = []
    for z in zs:
        dc = 0.0
        if z > 0.0:
            x, w = np.polynomial.legendre.leggauss(128)
            dh = C_KM_S / cosmo.H0
            dc = dh * float(np.sum(0.5 * z * w
                                   / cosmo.efunc(0.5 * z * (1.0 + x))))
        ok = 1.0 - cosmo.Om0 - (1.0 - cosmo.Om0 if cosmo.Ol0 is None
                                else cosmo.Ol0)
        dm = dc
        if abs(ok) > 1e-8:
            dh, s = C_KM_S / cosmo.H0, np.sqrt(abs(ok))
            dm = dh / s * (np.sinh(s * dc / dh) if ok > 0
                           else np.sin(s * dc / dh))
        out.append((1.0 + max(z, 0.0)) * dm)
    return np.array(out)


@pytest.fixture(scope="module")
def engine():
    return MultiFitter(nwalkers=16, seed=5, opthin=True, noalpha=True,
                       device="cpu")


SOURCE_Z = np.random.default_rng(21).uniform(0.5, 4.0, 40)
COSMOLOGIES = dict(
    {name: name for name in PARAMETER_SETS},
    open=Cosmology(H0=72.0, Om0=0.25, Ol0=0.6),
    closed=Cosmology(H0=68.0, Om0=0.35, Ol0=0.8))


@pytest.mark.parametrize("which", COSMOLOGIES)
def test_dl_mpc_matches_a_rule_per_redshift(engine, which):
    cosmology = COSMOLOGIES[which]
    cosmo = (Cosmology.named(cosmology) if isinstance(cosmology, str)
             else cosmology)
    z = np.concatenate([[0.0, -0.1], SOURCE_Z])
    want = _gl_loop(z, cosmo)
    got = engine._dl_mpc(z, cosmology=cosmology)
    assert got.dtype == np.float64 and got.shape == z.shape
    np.testing.assert_allclose(got, want, rtol=1e-13)
    np.testing.assert_array_equal(engine._dl_mpc(z, cosmology=cosmo), got)


@pytest.mark.parametrize("cosmology", [None, 1234.5, 800])
def test_dl_mpc_default_and_explicit_distance(engine, cosmology):
    got = engine._dl_mpc(SOURCE_Z, cosmology=cosmology)
    want = [luminosity_distance(z, cosmology) for z in SOURCE_Z]
    np.testing.assert_allclose(got, want, rtol=1e-13)
    if cosmology is not None:
        np.testing.assert_array_equal(got, float(cosmology))


def _counting_leggauss(monkeypatch):
    calls = []
    real = np.polynomial.legendre.leggauss

    def counted(n):
        calls.append(n)
        return real(n)
    monkeypatch.setattr(np.polynomial.legendre, "leggauss", counted)
    return calls


def test_lumdists_pass_through_unchanged(engine, monkeypatch):
    calls = _counting_leggauss(monkeypatch)
    given = np.linspace(100.0, 9000.0, SOURCE_Z.size)
    np.testing.assert_array_equal(
        engine._dl_mpc(SOURCE_Z, lumdists=given, cosmology="Planck18"),
        given)
    assert calls == []


@pytest.mark.parametrize("n", [1, 40, 256])
def test_one_rule_per_call(engine, monkeypatch, n):
    calls = _counting_leggauss(monkeypatch)
    z = np.resize(SOURCE_Z, n)
    engine._dl_mpc(z)
    assert calls == [128]
    calls.clear()
    luminosity_distance_batch(z, "WMAP7")
    Cosmology().luminosity_distance(z[0])
    assert calls == [128, 128]


@pytest.mark.parametrize("n", [3, 256])
def test_one_distance_span_with_its_redshifts(engine, n):
    n0 = len(profiling.recorded())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        engine._dl_mpc(np.resize(SOURCE_Z, n))
    spans = profiling.recorded()[n0:]
    assert [(s.name, s.attrs, s.parent) for s in spans] == [
        ("mbb.derived.distance", {"redshifts": n}, None)]
    assert spans[0].end_ns >= spans[0].start_ns
