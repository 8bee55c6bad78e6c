"""The port's instrument-response mode against the JAX package's on the CPU:
filter packs bit for bit (every built-in band at 33/65/129 nodes, the
analytic specs, file curves, detector conventions), the behaviour cases of
tests/test_response.py on the port's module, lnprob in response mode
through MBBFitter and the plain K2 replay with a pack, packs above the
kernels' old fixed staging, config 3's mock data built without jax, and a
response-mode HDF5 file crossing between the packages."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import instruments as jinstruments  # noqa: E402
from mbb_emcee_tpu import response as jresponse  # noqa: E402
from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import instruments  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import Photometry  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)
from mbb_emcee_tpu_torch.ops.lnprob_kernel import (  # noqa: E402
    prepare_lnprob_inputs, response_nodes)
from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler  # noqa: E402
from mbb_emcee_tpu_torch.response import Response, ResponseSet  # noqa: E402
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    make_initial_ball, stretch_run_plain)
from tools import validate_tpu_parity as vp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTER = os.path.join(REPO, "examples", "filters", "example_250um.txt")
# Port vs JAX: fp32 lnprob on both sides, same formulas, different op order
# and transcendental implementations (XLA:CPU vs torch's).
RTOL, ATOL = 1e-5, 1e-4


def _same_pack(rs, jrs, names):
    got, want = rs.pack(names), jrs.pack(names)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nnodes", [33, 65, 129])
def test_builtin_packs_equal_jax_bitwise(nnodes):
    names = list(instruments.BUILTIN_BANDS)
    assert names == list(jinstruments.BUILTIN_BANDS)
    rs = ResponseSet.builtin(names, nnodes=nnodes)
    jrs = jresponse.ResponseSet.builtin(names, nnodes=nnodes)
    _same_pack(rs, jrs, names)
    for n in names:
        np.testing.assert_allclose(rs[n].effective_wavelength,
                                   jrs[n].effective_wavelength, rtol=1e-12)
        assert rs[n].ref_wavelength == jrs[n].ref_wavelength
        assert rs[n].photon_counter == jrs[n].photon_counter


@pytest.mark.parametrize("spec,kw", [
    ("box:250:60", {}), ("box:350:80:129", {}), ("gauss:500:100", {}),
    ("gauss:160:40:17", {}), ("delta:850", {}), ("builtin:SPIRE_350:129", {}),
    ("PSW", {}), ("pacs-100um", {}), (FILTER, {}),
    ("box:250:100", dict(photon_counter=True)),
    ("gauss:500:100", dict(refspec_index=2.0)),
    ("builtin:IRAS_60", dict(photon_counter=False)),
    (FILTER, dict(photon_counter=True, refspec_index=0.0))])
def test_spec_responses_equal_jax(spec, kw):
    r = Response.from_spec("b", spec, **kw)
    j = jresponse.Response.from_spec("b", spec, **kw)
    np.testing.assert_array_equal(r.wave, j.wave)
    np.testing.assert_array_equal(r.weights, j.weights)
    np.testing.assert_allclose(r.effective_wavelength,
                               j.effective_wavelength, rtol=1e-12)
    assert r.ref_wavelength == j.ref_wavelength
    rs, jrs = ResponseSet(), jresponse.ResponseSet()
    rs.add("b", r)
    jrs.add("b", j)
    _same_pack(rs, jrs, ["b"])


def test_list_file_set_equals_jax(tmp_path):
    """ResponseSet.from_file: a measured curve (one node per row, relative
    to the list file), analytic specs and a built-in name, with the
    detector convention forwarded."""
    listfile = tmp_path / "filters.txt"
    listfile.write_text(
        f"# name spec\nF250 {os.path.relpath(FILTER, tmp_path)}\n"
        "BOX350 box:350:90  # a tophat\nDELTA500 delta:500\n"
        "P100 builtin:PACS_100:33\n")
    names = ["F250", "BOX350", "DELTA500", "P100"]
    for kw in ({}, dict(photon_counter=True)):
        rs = ResponseSet.from_file(str(listfile), **kw)
        jrs = jresponse.ResponseSet.from_file(str(listfile), **kw)
        assert list(rs.keys()) == list(jrs.keys()) == names
        _same_pack(rs, jrs, names)
        assert rs["F250"].wave.size == np.loadtxt(FILTER).shape[0]


# -- the behaviour cases of tests/test_response.py --------------------------

def test_delta_filter():
    r = Response.from_spec("d", "delta:250")
    assert r.effective_wavelength == 250.0
    np.testing.assert_allclose(r(lambda w: torch.full_like(w, 7.5)), 7.5)


def test_box_filter_flat_sed_and_reference_spectrum():
    r = Response.from_spec("b", "box:250:60")
    np.testing.assert_allclose(r(lambda w: torch.ones_like(w) * 3.0), 3.0,
                               rtol=1e-6)
    r = Response.from_spec("b", "box:250:100")
    leff = r.effective_wavelength
    np.testing.assert_allclose(r(lambda w: 5.0 * np.asarray(w) / leff), 5.0,
                               rtol=1e-6)


def test_box_powerlaw_color_correction():
    c, wdt = 250.0, 100.0
    r = Response.from_spec("b", f"box:{c}:{wdt}:129")
    val = r(lambda w: (np.asarray(w) / 250.0) ** 2)
    lam = np.linspace(c - wdt / 2, c + wdt / 2, 200001)
    leff = r.effective_wavelength
    num = np.trapezoid((lam / 250.0) ** 2 / lam ** 2, lam)
    den = np.trapezoid((leff / lam) ** -1.0 / lam ** 2, lam)
    np.testing.assert_allclose(val, num / den, rtol=1e-6)


def test_effective_wavelength_box_and_photon_counter():
    c, wdt = 350.0, 80.0
    r = Response.from_spec("b", f"box:{c}:{wdt}:257")
    lo, hi = c - wdt / 2, c + wdt / 2
    np.testing.assert_allclose(r.effective_wavelength,
                               np.log(hi / lo) / (1 / lo - 1 / hi),
                               rtol=1e-8)
    re = Response.from_spec("e", "box:250:100")
    rp = Response.from_spec("p", "box:250:100", photon_counter=True)
    assert rp.effective_wavelength > re.effective_wavelength
    np.testing.assert_allclose(rp(lambda w: torch.ones_like(w)), 1.0,
                               rtol=1e-6)


def test_gauss_filter():
    r = Response.from_spec("g", "gauss:500:100")
    assert abs(r.effective_wavelength - (500.0 - 7.2)) < 2.0
    np.testing.assert_allclose(r(lambda w: torch.ones_like(w)), 1.0,
                               rtol=1e-6)


def test_packed_contraction_matches_per_band_evaluation(tmp_path):
    lam = np.linspace(200, 300, 51)
    np.savetxt(tmp_path / "f250.txt",
               np.column_stack([lam, np.exp(-0.5 * ((lam - 250) / 20) ** 2)]))
    (tmp_path / "filters.txt").write_text(
        "F250 f250.txt\nBOX350 box:350:90\nDELTA500 delta:500\n")
    rs = ResponseSet.from_file(str(tmp_path / "filters.txt"))
    assert len(rs) == 3 and "F250" in rs and rs["DELTA500"].wave.size == 1
    names = ["F250", "BOX350", "DELTA500"]
    waves, weights = rs.pack(names)
    # padding: wavelength 500, weight 0
    assert waves[2, 1] == 500.0 and weights[2, 1] == 0.0
    theta = torch.tensor([35.0, 1.8, 350.0, 3.0, 40.0])
    sed = lambda w: mbb_fnu(theta, w, MBBShape())  # noqa: E731
    packed = (weights * sed(torch.as_tensor(waves)).numpy()).sum(axis=-1)
    individual = [rs[n](sed) for n in names]
    np.testing.assert_allclose(packed, individual, rtol=2e-4)


def test_validation_errors():
    with pytest.raises(ValueError):
        Response("bad", [250.0, 300.0], [1.0])
    with pytest.raises(ValueError):
        Response("bad", [-1.0, 300.0], [1.0, 1.0])
    with pytest.raises(ValueError):
        Response("bad", [250.0, 300.0], [-0.1, 1.0])
    with pytest.raises(ValueError):
        Response.from_spec("bad", "box:10:40")
    with pytest.raises(KeyError):
        Response.from_builtin("NOT_A_BAND")


def test_builtin_library_conventions():
    """Every band normalized against its own reference spectrum; Herschel
    bands quote at lambda_eff (K(0) = 1), IRAS/MIPS photon counting at
    their nominal wavelengths; aliases resolve; the set forwards the
    detector convention."""
    rs = ResponseSet.builtin(list(instruments.BUILTIN_BANDS))
    for name, band in instruments.BUILTIN_BANDS.items():
        r = rs[name]
        leff = r.effective_wavelength
        assert band.center - 0.75 * band.width < leff \
            < band.center + 0.75 * band.width, name
        s = r.refspec_index
        np.testing.assert_allclose(
            r(lambda w: 4.0 * (r.ref_wavelength / np.asarray(w)) ** s), 4.0,
            rtol=1e-6)
    for name in ("PACS_70", "SPIRE_500"):
        r = Response.from_builtin(name)
        np.testing.assert_allclose(r.ref_wavelength, r.effective_wavelength)
        np.testing.assert_allclose(np.sum(r.weights), 1.0, rtol=1e-10)
    r = Response.from_builtin("MIPS_24")
    assert r.photon_counter and r.refspec_index == 2.0
    assert r.ref_wavelength == 23.68
    for alias, canon in (("mips24um", "MIPS_24"), ("alma-band6", "ALMA_B6"),
                         ("PSW", "SPIRE_250")):
        np.testing.assert_array_equal(Response.from_spec("x", alias).weights,
                                      Response.from_builtin(canon).weights)
    rs = ResponseSet.builtin(["PACS_100", "SPIRE_350"], photon_counter=True)
    assert all(rs[n].photon_counter for n in ("PACS_100", "SPIRE_350"))


# -- response mode through the likelihood and the samplers ------------------

def _config3_fits(nnodes, nwalkers=16):
    """Port and JAX MBBFitter on config 3 (thin, 3 free) with the built-in
    pack of the parity bands at `nnodes` nodes, the parity tool's data."""
    cfg = vp.CONFIGS[3]
    flux, unc, _ = vp.mock_data(cfg)
    fits = []
    for pkg, rset in ((T, ResponseSet), (J, jresponse.ResponseSet)):
        fit = pkg.MBBFitter(nwalkers=nwalkers, opthin=True, noalpha=True,
                            seed=3, responses=rset.builtin(vp.BANDS,
                                                           nnodes=nnodes),
                            **({"device": "cpu"} if pkg is T else {}))
        fit.set_data(vp.WAVE, flux, unc, band_names=vp.BANDS)
        fit.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
        fits.append(fit)
    return fits


@pytest.mark.parametrize("nnodes", [65, 129])
def test_fitter_call_in_response_mode_matches_jax(nnodes):
    """MBBFitter(responses=...)(theta) on config 3's pack and on a 129-node
    pack (which the kernels' old 65-node staging refused)."""
    tfit, jfit = _config3_fits(nnodes)
    rng = np.random.default_rng(nnodes)
    for theta in vp.TRUE[None, :] * rng.uniform(0.8, 1.2, (6, 5)):
        np.testing.assert_allclose(tfit(theta), jfit(theta), rtol=RTOL,
                                   atol=ATOL)
    assert tfit._response_pack()[0].shape == (5, nnodes)


def test_response_mode_with_a_covariance_matches_jax():
    """Response mode x correlated band errors: config 3's model on its
    5 x 65 pack with config 5's band covariance, 8 seeded parameter
    vectors through the JAX lnprob and the port's (the plain version, and
    the kernel wrapper on a CPU tensor), and through both fitters'
    __call__."""
    cfg = vp.CONFIGS[3]
    flux, unc, _ = vp.mock_data(cfg)
    _, _, cov = vp.mock_data(vp.CONFIGS[5])
    assert cov is not None and cov.shape == (5, 5)
    assert np.abs(cov - np.diag(np.diag(cov))).max() > 0
    pack = ResponseSet.builtin(vp.BANDS, nnodes=65).pack(vp.BANDS)
    spec = T.LikelihoodSpec.default()
    jspec = J.LikelihoodSpec.default()
    for sp in (spec, jspec):
        sp.upper[0], sp.upper[1] = vp.UPPER[0], vp.UPPER[1]
        sp.fixed[2], sp.fixed_values[2] = True, vp.TRUE[2]
        sp.fixed[3], sp.fixed_values[3] = True, vp.TRUE[3]
    shape = MBBShape(opthin=True, noalpha=True)
    ops = prepare_lnprob_inputs(
        Photometry(vp.WAVE, flux, unc, cov=cov, band_names=list(vp.BANDS)),
        shape, spec, pack, device="cpu")
    assert ops.icfg[2] == 1 and tuple(ops.icfg[3:5]) == (5, 65)
    jfn, jfree = J.build_lnprob(
        J.Photometry(vp.WAVE, flux, unc, cov=cov, band_names=list(vp.BANDS)),
        JShape(opthin=True, noalpha=True), jspec, response_pack=pack)
    free = ops.free_space.free_idx
    assert list(free) == list(jfree.free_idx) == [0, 1, 4]
    th = (vp.TRUE[free][None] * np.random.default_rng(35).uniform(
        0.8, 1.2, (8, free.size))).astype(np.float32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(th)))
    assert np.all(np.isfinite(want)) and np.all(want > -1e29)
    x = torch.as_tensor(th)
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    np.testing.assert_allclose(ops.plain(x).numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(mbb_lnprob(x, ops).numpy(), want, rtol=2e-5)
    # the covariance matters: the diagonal likelihood gives other values
    diag = prepare_lnprob_inputs(
        Photometry(vp.WAVE, flux, unc, band_names=list(vp.BANDS)), shape,
        spec, pack, device="cpu")
    assert not np.allclose(diag.plain(x).numpy(), want, rtol=1e-3)
    tfit, jfit = _config3_fits(65)
    for fit in (tfit, jfit):
        fit.set_data(vp.WAVE, flux, unc, cov=cov, band_names=vp.BANDS)
    for row in th:
        theta = vp.TRUE.copy()
        theta[free] = row
        np.testing.assert_allclose(tfit(theta), jfit(theta), rtol=2e-5)


def test_response_mode_needs_band_names():
    fit = T.MBBFitter(nwalkers=16, device="cpu",
                      responses=ResponseSet.builtin(vp.BANDS))
    fit.set_data(vp.WAVE, vp.TRUE[4] * np.ones(5), np.ones(5))
    with pytest.raises(ValueError, match="named photometry bands"):
        fit(vp.TRUE)


def test_plain_replay_with_a_pack_matches_jax_stretch_move():
    """The plain K2 replay on a 5 x 129 pack against the JAX package's
    stretch_half_step_from_uniforms on the same uniforms, over 3 steps, at
    chip_smoke.py's replay tolerances."""
    tfit, jfit = _config3_fits(129, nwalkers=32)
    pack = tfit._response_pack()
    phot = tfit._require_data()
    spec = tfit._effective_spec()
    samp = FusedSampler(32, phot, tfit.shape, spec, response_pack=pack,
                        rng="external", device="cpu")
    jfn, _ = J.build_lnprob(jfit._require_data(), jfit.shape,
                            jfit._effective_spec(), response_pack=pack)
    jbatch = jax.jit(jax.vmap(jfn))
    fs = samp.free_space
    p0 = make_initial_ball(torch.Generator().manual_seed(1),
                           vp.TRUE[fs.free_idx], 0.05 * vp.TRUE[fs.free_idx],
                           32, fs.lower, fs.upper, device="cpu")
    state = samp.init_state(p0, seed=5)
    nsteps = 3
    u = np.random.default_rng(2).uniform(
        0.001, 0.999, (nsteps, 6, 16)).astype(np.float32)
    _, chain, lnp = stretch_run_plain(state, samp.ops.plain, nsteps, 1,
                                      samp.a, torch.as_tensor(u))
    pa, pb = jnp.asarray(p0[:16].numpy()), jnp.asarray(p0[16:].numpy())
    la, lb = jbatch(pa), jbatch(pb)
    for t in range(nsteps):
        pa, la, _ = jsampler.stretch_half_step_from_uniforms(
            jnp.asarray(u[t, :3]), pa, pb, la, jbatch)
        pb, lb, _ = jsampler.stretch_half_step_from_uniforms(
            jnp.asarray(u[t, 3:]), pb, pa, lb, jbatch)
        np.testing.assert_allclose(chain[t].numpy(),
                                   np.concatenate([pa, pb]), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lnp[t].numpy(), np.concatenate([la, lb]),
                                   rtol=2e-5, atol=1e-4)


def test_packs_above_the_old_staging_cap():
    """8 bands x 400 nodes (3200 floats per array, above the kernels' old
    2080): the CPU path takes any size, as the JAX package does, and the
    packed operands carry the whole pack."""
    names = ["PACS_70", "PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350",
             "SPIRE_500", "SCUBA2_850", "AZTEC_1100"]
    rs = ResponseSet.builtin(names, nnodes=400)
    pack = rs.pack(names)
    wave = np.array([rs[n].effective_wavelength for n in names])
    waves, weights = response_nodes(wave, pack, device="cpu")
    assert waves.shape == (8, 400)
    phot = Photometry(wave, np.linspace(5, 50, 8), np.ones(8),
                      band_names=names)
    spec = T.LikelihoodSpec.default()
    ops = prepare_lnprob_inputs(phot, MBBShape(), spec, pack, device="cpu")
    # box and priors, flux, whitening, waves and weights, upper-limit flags
    assert ops.consts.numel() == 20 + 8 + 8 * 8 + 2 * 8 * 400 + 8
    jfn, _ = J.build_lnprob(
        J.Photometry(wave, phot.flux, phot.unc, band_names=names),
        JShape(), J.LikelihoodSpec.default(), response_pack=pack)
    th = (vp.TRUE[None] * np.random.default_rng(4).uniform(
        0.8, 1.2, (8, 5))).astype(np.float32)
    np.testing.assert_allclose(ops.plain(torch.as_tensor(th)).numpy(),
                               np.asarray(jax.vmap(jfn)(jnp.asarray(th))),
                               rtol=RTOL, atol=ATOL)


def test_config3_mock_data_without_jax(monkeypatch):
    """chip_smoke.py builds config 3's data from the port's pack through
    the parity tool's own formula: the pack and the data equal the JAX
    package's bit for bit, so the recorded oracle entry still applies."""
    import chip_smoke
    rs, pack = chip_smoke.port_response_pack()
    jrs, jpack = vp.response_pack()
    for a, b in zip(pack, jpack):
        np.testing.assert_array_equal(a, b)
    want = vp.mock_data(vp.CONFIGS[3])
    monkeypatch.setattr(vp, "response_pack", chip_smoke.port_response_pack)
    got = vp.mock_data(vp.CONFIGS[3])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert vp.recorded_entry(3)[0] == "ok"


def test_response_mode_hdf5_crosses_both_ways(tmp_path):
    """A response-mode fit written by either package loads in the other
    with its pack, and the derived L_IR of the reloaded chain agrees."""
    tfit, jfit = _config3_fits(65)
    tfit.run(nburn=10, nsteps=20)
    jfit.run(nburn=10, nsteps=20)
    tres = T.MBBResults(fit=tfit, redshift=2.0)
    jres = J.MBBResults(fit=jfit, redshift=2.0)
    tres.writeToHDF5(str(tmp_path / "t.h5"))
    jres.writeToHDF5(str(tmp_path / "j.h5"))
    for written, loader, src in (
            ("t.h5", J.MBBResults, tres),
            ("j.h5", functools.partial(T.MBBResults, device="cpu"), jres)):
        back = loader(h5file=str(tmp_path / written))
        for a, b in zip(back.response_pack, src.response_pack):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
        np.testing.assert_array_equal(back.chain, np.asarray(
            src.chain, np.float32))
        assert back.phot.band_names == list(vp.BANDS)
    tback = T.MBBResults(h5file=str(tmp_path / "j.h5"), device="cpu")
    np.testing.assert_allclose(tback.compute_lir(thin=4),
                               jres.compute_lir(thin=4), rtol=1e-5)
