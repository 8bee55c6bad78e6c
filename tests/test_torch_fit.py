"""The slice as a whole on the CPU: the port's MBBFitter against the JAX
package's on the parity sentinel's config 1, derived quantities on one
shared chain, HDF5 files crossing between the packages, and the port's
CLI end to end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import derived as jderived  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import cli, derived  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu_params)
from mbb_emcee_tpu_torch.sampler import autocorrelation_time  # noqa: E402
from tools import validate_tpu_parity as vp  # noqa: E402

NW, NBURN, NSTEPS = 64, 200, 400


def _setup(fit, flux, unc, cfg):
    fit.set_data(vp.WAVE, flux, unc)
    fit.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    for (pi, mean, sig) in cfg["priors"]:
        fit.set_gaussian_prior(pi, mean, sig)
    for i in range(5):
        fit.set_param_init(i, vp.TRUE[i])
    return fit


@pytest.fixture(scope="module")
def fits():
    """One port fit and one JAX fit of config 1 (thick, 4 free), fixed
    seeds, same data."""
    cfg = vp.CONFIGS[1]
    flux, unc, _ = vp.mock_data(cfg)
    tfit = _setup(T.MBBFitter(nwalkers=NW, seed=21, noalpha=True,
                              device="cpu"), flux, unc, cfg)
    tfit.run(nburn=NBURN, nsteps=NSTEPS)
    jfit = _setup(J.MBBFitter(nwalkers=NW, seed=21, noalpha=True), flux,
                  unc, cfg)
    jfit.run(nburn=NBURN, nsteps=NSTEPS)
    return tfit, jfit, vp.free_indices(cfg)


def _median_and_se(chain_free, flat, free):
    """Median and its tau-based SE (tools/validate_tpu_parity.tau_se)."""
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain_free),
                                   nan=1.0), 1.0)
    std = flat[:, free].std(axis=0)
    return (np.median(flat[:, free], axis=0),
            1.2533 * std / np.sqrt(flat.shape[0] / tau))


def test_fit_medians_match_jax(fits):
    tfit, jfit, free = fits
    assert type(tfit.sampler).__name__ == "EnsembleSampler"
    assert tfit.chain.shape == (NW, NSTEPS, 5)
    mt, st = _median_and_se(tfit.chain_free.double().numpy(),
                            tfit.chain.reshape(-1, 5), free)
    mj, sj = _median_and_se(np.asarray(jfit.chain_free, np.float64),
                            jfit.chain.reshape(-1, 5), free)
    tol = np.maximum(0.03 * np.abs(mj), 4.0 * np.hypot(st, sj))
    assert np.all(np.abs(mt - mj) <= tol), (mt, mj, tol)
    af = np.asarray(tfit.acceptance_fraction)
    assert np.all((af > 0.1) & (af < 0.9))
    assert np.all(np.isfinite(tfit.gelman_rubin()))


def _shared_chain(shape_kw, n=400, seed=8):
    rng = np.random.default_rng(seed)
    th = np.stack([rng.uniform(20.0, 50.0, n), rng.uniform(1.2, 2.6, n),
                   rng.uniform(100.0, 500.0, n), rng.uniform(2.0, 5.0, n),
                   rng.uniform(20.0, 60.0, n)], axis=1)
    if shape_kw.get("opthin"):
        th[:, 2] = 250.0
    if shape_kw.get("noalpha"):
        th[:, 3] = 3.5
    return th.astype(np.float32)


@pytest.mark.parametrize("shape_kw", [
    dict(opthin=True, noalpha=True), dict(noalpha=True), dict()],
    ids=["thin3", "thick4", "full5"])
@pytest.mark.parametrize("quantity", ["lir", "dustmass", "peaklambda"])
def test_derived_match_jax_on_a_shared_chain(shape_kw, quantity):
    """L_IR, dust mass and lambda_peak per sample from both packages'
    derived kernels and prefactors (z = 2.2, WMAP9), rtol 1e-4."""
    th = _shared_chain(shape_kw)
    jshape, tshape = JShape(**shape_kw), MBBShape(**shape_kw)
    z = 2.2
    dl = T.luminosity_distance(z)
    assert dl == pytest.approx(J.luminosity_distance(z), rel=1e-12)
    x = torch.as_tensor(th)
    if quantity == "lir":
        lam, w = derived.lir_nodes_weights(1 + z, 8.0, 1000.0)
        got = derived.lir_prefactor(dl) * derived.lir_integrand(tshape)(
            x, torch.as_tensor(lam.astype(np.float32)),
            torch.as_tensor(w.astype(np.float32))).double().numpy()
        jl, jw = jderived.lir_nodes_weights(1 + z, 8.0, 1000.0)
        one = jderived.lir_integrand(jshape)
        want = jderived.lir_prefactor(dl) * np.asarray(jax.vmap(
            lambda t: one(t, jnp.asarray(jl, jnp.float32),
                          jnp.asarray(jw, jnp.float32)))(jnp.asarray(th)),
            np.float64)
    elif quantity == "dustmass":
        lam_obs = 125.0 * (1 + z)
        pre = derived.dustmass_prefactor(dl, 1 + z, 2.64, 125.0)
        got = pre * derived.dustmass_integrand(tshape)(
            x, torch.tensor(lam_obs, dtype=torch.float32)).double().numpy()
        one = jderived.dustmass_integrand(jshape)
        want = jderived.dustmass_prefactor(dl, 1 + z, 2.64, 125.0) \
            * np.asarray(jax.vmap(lambda t: one(
                t, jnp.asarray(lam_obs, jnp.float32)))(jnp.asarray(th)),
                np.float64)
    else:
        got = derived.peak_finder(tshape)(x).double().numpy()
        want = np.asarray(jax.vmap(jderived.peak_finder(jshape))(
            jnp.asarray(th)), np.float64)
        # Both sides maximize an fp32 ln f_nu by golden section. Near the
        # flat top, values within ~1e-6 of each other compare by rounding
        # noise, so each side stops anywhere in a plateau of half-width
        # ~sqrt(2 * 1e-6 / |d2 ln f / du2|) ~ 1e-3 in ln lambda: the two
        # LOCATIONS agree to that (rtol 2e-3), while the flux both found
        # agrees to 1e-5 in ln f_nu (what the golden section controls).
        def lnf_at(lam):
            return log_mbb_fnu_params(
                *x.unbind(1), torch.as_tensor(lam.astype(np.float32)),
                tshape).double().numpy()
        np.testing.assert_allclose(lnf_at(got), lnf_at(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=2e-3)
        return
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("pack", [False, True], ids=["point", "response"])
def test_band_fluxes_match_jax(pack):
    """derived.band_flux_eval against the JAX package's on a shared chain:
    point evaluation and a numpy (5, 9) response pack."""
    th = _shared_chain({})
    wave = vp.WAVE
    rp = None
    if pack:
        u = np.linspace(-0.2, 0.2, 9)
        nodes = wave[:, None] * np.exp(u)[None, :]
        rp = (nodes, np.full(nodes.shape, 1.0 / 9))
    got = derived.band_flux_eval(MBBShape(), wave, rp)(
        torch.as_tensor(th)).numpy()
    want = np.asarray(jax.vmap(jderived.band_flux_eval(JShape(), wave, rp))(
        jnp.asarray(th)))
    assert got.shape == (th.shape[0], 5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_results_derived_posteriors(fits):
    tfit, _, _ = fits
    res = T.MBBResults(fit=tfit, redshift=2.2)
    for name in ("lir", "dustmass", "peaklambda"):
        chain = getattr(res, f"compute_{name}")(thin=4)
        assert chain.shape == (NW * NSTEPS // 4,)
        assert np.all(np.isfinite(chain)) and np.all(chain > 0)
    names, cov = res.par_cov()
    assert names == ["T", "beta", "lambda0", "fnorm"] and cov.shape == (4, 4)
    band = res.sed_percentiles([100.0, 250.0, 500.0], thin=8)
    assert band.shape == (3, 3) and np.all(band[1] >= band[2])
    params, lnp = res.best_fit
    assert params.shape == (5,) and np.isfinite(lnp)
    assert "L_IR" in repr(res)


def test_hdf5_files_cross_load(fits, tmp_path):
    """A file written by the port loads in the JAX package's
    MBBResults(h5file=) and the reverse, with equal par_cen."""
    tfit, jfit, _ = fits
    tres = T.MBBResults(fit=tfit, redshift=2.2)
    tres.compute_lir(thin=8)
    tres.writeToHDF5(tmp_path / "port.h5")
    jres = J.MBBResults(fit=jfit, redshift=2.2)
    jres.compute_peaklambda(thin=8)
    jres.writeToHDF5(str(tmp_path / "jax.h5"))

    in_jax = J.MBBResults(h5file=str(tmp_path / "port.h5"))
    in_port = T.MBBResults(h5file=tmp_path / "jax.h5", device="cpu")
    for p in ("T", "beta", "lambda0", "fnorm"):
        np.testing.assert_allclose(in_jax.par_cen(p), tres.par_cen(p),
                                   rtol=1e-6)
        np.testing.assert_allclose(in_port.par_cen(p), jres.par_cen(p),
                                   rtol=1e-6)
    np.testing.assert_allclose(in_jax.lir_chain, tres.lir_chain)
    np.testing.assert_allclose(in_port.peaklambda_chain,
                               jres.peaklambda_chain)
    assert in_jax.redshift == in_port.redshift == 2.2
    np.testing.assert_array_equal(in_port.param_spec.fixed,
                                  jres.param_spec.fixed)


def _photfile(tmp_path):
    path = tmp_path / "phot.txt"
    path.write_text("100.0  11.2  0.8\n160.0  32.1  1.9\n250.0  44.8  2.4\n"
                    "350.0  38.2  2.1\n500.0  22.9  1.5\n")
    return path


def test_cli_runs_end_to_end(tmp_path, capsys):
    out = tmp_path / "fit.h5"
    rc = cli.main([str(_photfile(tmp_path)), str(out), "-w", "32", "-b",
                   "20", "-n", "40", "-z", "2.2", "--get-lir",
                   "--device", "cpu", "-v"])
    assert rc == 0 and out.is_file()
    text = capsys.readouterr().out
    assert "Device: cpu" in text and "L_IR" in text
    res = J.MBBResults(h5file=str(out))
    assert res.chain.shape == (32, 40, 5)
    assert res.lir_chain.shape == (32 * 40,)


def test_cli_checks_redshift_before_sampling(tmp_path, monkeypatch):
    def no_run(*a, **k):
        raise AssertionError("sampled before the up-front check")
    monkeypatch.setattr(T.MBBFitter, "run", no_run)
    out = tmp_path / "fit.h5"
    with pytest.raises(SystemExit, match="redshift"):
        cli.main([str(_photfile(tmp_path)), str(out), "--get-lir",
                  "--device", "cpu"])
    assert not out.exists()


@pytest.mark.parametrize("flags,item", [
    (["--plot-sed", "x.png"], "A10b"), (["--plot-corner", "x.png"], "A10b"),
    (["--plot-chain", "x.png"], "A10b"), (["--profile-dir", "prof"], "A8")])
def test_cli_refuses_waiting_flags(tmp_path, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md.*{item}"):
        cli.main([str(_photfile(tmp_path)), str(tmp_path / "o.h5"),
                  "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [
    ["--hmc", "--hmc-leapfrog", "4"],
    ["--pt", "--pt-rungs", "4", "--pt-beta-min", "0.01"], []])
def test_cli_get_evidence_runs(tmp_path, capsys, flags):
    """--get-evidence (once refused as A9e), after the stretch run, HMC or
    PT: the JAX CLI's line, and the /Evidence group in the file, which the
    JAX package reads."""
    out = tmp_path / "fit.h5"
    rc = cli.main([str(_photfile(tmp_path)), str(out), "-w", "16", "-b",
                   "10", "-n", "20", "--get-evidence", "--nlive", "40",
                   "--device", "cpu", *flags])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "ln Z = " in printed and "likelihood evaluations)" in printed
    ev = J.MBBResults(h5file=str(out)).evidence
    assert np.isfinite(ev.logz) and ev.samples.shape[1] == 5
    assert f"ln Z = {ev.logz:.4f} +/- {ev.logz_err:.4f}" in printed


def _named_photfile(tmp_path):
    path = tmp_path / "named.txt"
    path.write_text("".join(
        f"{n} {w} {f} {0.06 * f:.3f}\n" for n, w, f in zip(
            vp.BANDS, vp.WAVE, (11.2, 32.1, 44.8, 38.2, 22.9))))
    return path


@pytest.mark.parametrize("mode", ["builtin", "responsefile"])
def test_cli_response_modes(tmp_path, mode):
    """--builtin-responses resolves the band-name column against the
    built-in library; --responsefile reads a 'band spec' list (here with
    --photon-counter). The file carries the JAX package's pack."""
    from mbb_emcee_tpu.response import ResponseSet as JRS
    out = tmp_path / "resp.h5"
    if mode == "builtin":
        flags = ["--builtin-responses"]
        want = JRS.builtin(vp.BANDS).pack(vp.BANDS)
    else:
        (tmp_path / "filters.txt").write_text("".join(
            f"{n} box:{w}:{0.3 * w}\n" for n, w in zip(vp.BANDS, vp.WAVE)))
        flags = ["--responsefile", str(tmp_path / "filters.txt"),
                 "--photon-counter"]
        want = JRS.from_file(str(tmp_path / "filters.txt"),
                             photon_counter=True).pack(vp.BANDS)
    rc = cli.main([str(_named_photfile(tmp_path)), str(out), "-w", "16",
                   "-b", "10", "-n", "20", "--device", "cpu", *flags])
    assert rc == 0
    res = J.MBBResults(h5file=str(out))
    for got, w in zip(res.response_pack, want):
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)
    assert res.chain.shape == (16, 20, 5)
    if mode == "builtin":
        with pytest.raises(SystemExit, match="band-name column"):
            cli.main([str(_photfile(tmp_path)), str(out), "--device",
                      "cpu", *flags])


@pytest.mark.parametrize("n_ensembles", [1, 2])
def test_cli_checkpoint_and_resume(tmp_path, n_ensembles):
    """--checkpoint flushes the production run; --resume continues a
    shorter one to the chain of the uninterrupted CLI run, bit for bit."""
    base = [str(_photfile(tmp_path)), "-w", "16", "-b", "10", "--device",
            "cpu", "--checkpoint-interval", "10", "--n-ensembles",
            str(n_ensembles)]
    whole = tmp_path / "whole.h5"
    assert cli.main([base[0], str(whole), *base[1:], "-n", "40"]) == 0
    ck = tmp_path / "run.ckpt.h5"
    assert cli.main([base[0], str(tmp_path / "a.h5"), *base[1:], "-n", "20",
                     "--checkpoint", str(ck)]) == 0
    assert ck.is_file()
    resumed = tmp_path / "resumed.h5"
    assert cli.main([base[0], str(resumed), *base[1:], "-n", "40",
                     "--checkpoint", str(ck), "--resume"]) == 0
    a, b = (T.MBBResults(h5file=h, device="cpu") for h in (whole, resumed))
    assert b.chain.shape == (16 * n_ensembles, 40, 5)
    np.testing.assert_array_equal(a.chain, b.chain)


@pytest.mark.parametrize("rhat,want_steps", [(100.0, 20), (1.0, 60)])
def test_cli_extend_until(tmp_path, rhat, want_steps):
    """--extend-until: a loose threshold stops at the first pass; an
    unreachable one extends by --extend-step until --max-steps."""
    out = tmp_path / "ext.h5"
    rc = cli.main([str(_photfile(tmp_path)), str(out), "-w", "16", "-b",
                   "10", "-n", "20", "--device", "cpu", "--extend-until",
                   str(rhat), "--extend-step", "20", "--max-steps", "60"])
    assert rc == 0
    assert J.MBBResults(h5file=str(out)).chain.shape == (16, want_steps, 5)


@pytest.mark.parametrize("flags,match", [
    (["-n", "6", "--thin", "2"], "at least 4 recorded"),
    (["--extend-step", "3", "--thin", "2"], "divisible")])
def test_cli_extend_until_checks_before_sampling(tmp_path, monkeypatch,
                                                 flags, match):
    def no_run(*a, **k):
        raise AssertionError("sampled before the up-front check")
    monkeypatch.setattr(T.MBBFitter, "run", no_run)
    with pytest.raises(SystemExit, match=match):
        cli.main([str(_photfile(tmp_path)), str(tmp_path / "o.h5"),
                  "--device", "cpu", "--extend-until", "1.05", *flags])


@pytest.mark.parametrize("accessor", [
    "nsteps", "data", "best_fit_model", "effective_samples_bulk",
    "effective_samples_tail", "lir", "dustmass", "peaklambda"])
def test_results_accessors_match_jax(fits, tmp_path, accessor):
    """The accessors MBBResults gained in this port slice against the JAX
    package's MBBResults on the same chain (the port's file loaded in the
    JAX package)."""
    tfit, _, _ = fits
    tres = T.MBBResults(fit=tfit, redshift=2.2)
    tres.writeToHDF5(tmp_path / "acc.h5")
    jres = J.MBBResults(h5file=str(tmp_path / "acc.h5"))
    if accessor == "nsteps":
        assert tres.nsteps == jres.nsteps == NSTEPS
    elif accessor == "data":
        for a in ("data_wave", "data_flux", "data_flux_unc"):
            np.testing.assert_array_equal(getattr(tres, a),
                                          getattr(jres, a))
    elif accessor == "best_fit_model":
        tm, jm = tres.best_fit_model(), jres.best_fit_model()
        for a in ("T", "beta", "lambda0", "alpha", "fnorm"):
            assert getattr(tm, a) == pytest.approx(getattr(jm, a), rel=1e-6)
        waves = np.array([80.0, 250.0, 870.0])
        np.testing.assert_allclose(tm(waves).numpy(), np.asarray(jm(waves)),
                                   rtol=1e-5)
    elif accessor.startswith("effective_samples"):
        kind = accessor.rsplit("_", 1)[1]
        np.testing.assert_allclose(tres.effective_samples(kind),
                                   jres.effective_samples(kind), rtol=1e-6)
    elif accessor == "peaklambda":
        # per sample the two golden sections agree to 2e-3 in lambda (ROADMAP
        # section C), so the summary's errors agree to 2e-3 of the median
        got, want = tres.peaklambda, jres.peaklambda
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * want[0])
    else:
        # the properties compute the full-chain posterior on first use
        np.testing.assert_allclose(getattr(tres, accessor),
                                   getattr(jres, accessor), rtol=1e-4)
