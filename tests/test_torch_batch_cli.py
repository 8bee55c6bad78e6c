"""The port's batch command line (run_mbb_emcee_tpu_torch_batch) and its
ingest on the CPU: the catalog reader and the band-correlation reader
against the JAX package's, the CLI end to end writing files the JAX package
loads (whole batch, chunked, correlated, run-until-converged), its up-front
checks and the refusal of each flag that waits for a ROADMAP.md item; and
the single-fit CLI's --n-ensembles."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu.catalog import read_catalog as j_read_catalog  # noqa: E402
from mbb_emcee_tpu.utils.fits import (  # noqa: E402
    read_band_correlation as j_read_band_correlation)
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import cli, cli_batch  # noqa: E402
from mbb_emcee_tpu_torch.catalog import read_catalog  # noqa: E402
from mbb_emcee_tpu_torch.utils.fits import (  # noqa: E402
    read_band_correlation, write_fits_image)

CATALOG = """\
# a small survey catalog
wave = 100 160 250 350 500
bands = PACS_100 PACS_160 SPIRE_250 SPIRE_350 SPIRE_500
SMM_J0001   2.20   11.2 0.8  32.1 1.9  44.8 2.4  38.2 2.1  22.9 1.5
SMM_J0002   1.85    9.4 0.7  28.8 1.7  40.1 2.2  35.5 2.0  21.3 1.4
SMM_J0003   2.60    nan nan  25.0 1.6  39.0 2.2  36.0 2.0  <30.0 1.5
SMM_J0004   1.40   14.0 0.9  35.0 2.0  45.0 2.5  36.5 2.0  21.0 1.4
SMM_J0005   3.10    8.0 0.7  24.0 1.5  36.0 2.1  34.0 1.9  22.0 1.4
"""
FAST = ["-w", "16", "-b", "10", "-n", "20", "--device", "cpu"]


def _catalog(tmp_path, text=CATALOG, nsrc=None):
    lines = text.splitlines()
    if nsrc is not None:
        head = [ln for ln in lines if not ln.startswith("SMM")]
        lines = head + [ln for ln in lines if ln.startswith("SMM")][:nsrc]
    path = tmp_path / "cat.txt"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_read_catalog_matches_jax(tmp_path):
    """The port's copy of the catalog reader parses what the JAX
    package's parses: names, redshifts, a NaN missing band, a '<' per-source
    upper limit OR-combined with an 'uplims' header row."""
    text = CATALOG.replace("bands =", "uplims = 0 0 0 0 1\nbands =")
    path = _catalog(tmp_path, text)
    got, want = read_catalog(path), j_read_catalog(str(path))
    assert got.names == want.names and got.band_names == want.band_names
    for a in ("redshifts", "wave", "flux", "unc", "uplim_bands",
              "uplim_src"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    np.testing.assert_array_equal(got.uplim_mask(), want.uplim_mask())
    assert got.uplim_mask()[2, 4] and got.nsources == 5
    assert got.has_redshifts
    (tmp_path / "bad.txt").write_text("SMM 1.0 1 2\n")
    with pytest.raises(ValueError, match="wave"):
        read_catalog(tmp_path / "bad.txt")


@pytest.mark.parametrize("scaled", [False, True], ids=["corr", "cov"])
def test_read_band_correlation_matches_jax(tmp_path, scaled):
    r = np.full((5, 5), 0.3)
    np.fill_diagonal(r, 1.0)
    d = np.array([1.0, 2.0, 0.5, 3.0, 1.5]) if scaled else np.ones(5)
    write_fits_image(tmp_path / "r.fits", r * np.outer(d, d))
    got = read_band_correlation(tmp_path / "r.fits")
    np.testing.assert_allclose(got, j_read_band_correlation(
        str(tmp_path / "r.fits")), rtol=1e-15)
    np.testing.assert_allclose(got, r, rtol=1e-12)
    write_fits_image(tmp_path / "bad.fits", np.ones((5, 4)))
    with pytest.raises(ValueError, match="square"):
        read_band_correlation(tmp_path / "bad.fits")


def test_batch_cli_writes_a_file_jax_loads(tmp_path, capsys):
    out = tmp_path / "batch.h5"
    rc = cli_batch.main([str(_catalog(tmp_path, nsrc=4)), str(out), *FAST,
                         "--get-lir", "--get-dustmass", "--get-peaklambda",
                         "--derived-thin", "4", "--store-thin", "2",
                         "--summary", "-v"])
    assert rc == 0 and out.is_file()
    text = capsys.readouterr().out
    assert "SMM_J0003" in text and "max-Rhat" in text
    assert "Device: cpu" in text
    jmf = J.MultiFitter.from_h5(str(out))
    assert jmf.nsources == 4 and jmf.thin == 2
    assert np.asarray(jmf.chain_free).shape == (4, 10, 16, 5)
    assert jmf.source_names[2] == "SMM_J0003"
    assert jmf.lir_chain.shape == (4, 20 * 16 // 4)
    assert np.all(np.isfinite(jmf.dustmass_chain))
    ul = jmf._spec.uplim_bands
    assert ul.shape == (4, 5) and ul[2, 4] and ul.sum() == 1
    assert np.isinf(jmf.unc[2, 0]) and jmf.flux[2, 0] == 0.0
    assert np.all(np.isfinite(jmf.par_cen("T")))
    tmf = T.MultiFitter.from_h5(out, device="cpu")
    np.testing.assert_allclose(tmf.par_cen("beta"), jmf.par_cen("beta"),
                               rtol=1e-5)


def test_batch_cli_chunked_writes_part_files(tmp_path, capsys):
    """--chunk-size 2 on 5 sources: three parts of 2 sources, the last
    overlapping its predecessor, each a normal batch file."""
    out = tmp_path / "batch.h5"
    rc = cli_batch.main([str(_catalog(tmp_path)), str(out), *FAST,
                         "--chunk-size", "2", "--phot-uplim", "SPIRE_350"])
    assert rc == 0 and not out.exists()
    assert "5 sources served in 3 chunks of 2" in capsys.readouterr().out
    names = []
    for i in range(3):
        jmf = J.MultiFitter.from_h5(str(tmp_path / f"batch.part{i:03d}.h5"))
        assert jmf.nsources == 2
        names += jmf.source_names
        assert jmf._spec.uplim_bands[:, 3].all()
    assert names == ["SMM_J0001", "SMM_J0002", "SMM_J0003", "SMM_J0004",
                     "SMM_J0004", "SMM_J0005"]


def test_batch_cli_correlated_and_extend_until(tmp_path, capsys):
    """--corrfile fits with correlated band errors; --extend-until keeps
    extending (here to --max-steps) on the same Philox streams."""
    r = np.full((5, 5), 0.2)
    np.fill_diagonal(r, 1.0)
    write_fits_image(tmp_path / "r.fits", r)
    text = CATALOG.replace("<30.0", "30.0")
    out = tmp_path / "corr.h5"
    rc = cli_batch.main([str(_catalog(tmp_path, text, nsrc=3)), str(out),
                         *FAST, "--corrfile", str(tmp_path / "r.fits"),
                         "--extend-until", "1.0001", "--extend-step", "10",
                         "--max-steps", "40"])
    assert rc == 0
    jmf = J.MultiFitter.from_h5(str(out))
    np.testing.assert_allclose(jmf._band_corr, r)
    assert np.asarray(jmf.chain_free).shape[1] == 40
    assert "3 sources fit" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--get-lir"], "redshift"),
    (["--extend-until", "1.05", "-n", "3"], "4 recorded"),
    (["--extend-until", "1.05", "--extend-step", "3", "--thin", "2",
      "-n", "20"], "divisible"),
    (["--chunk-size", "0"], "positive")])
def test_batch_cli_checks_before_sampling(tmp_path, monkeypatch, flags,
                                          match):
    def no_run(*a, **k):
        raise AssertionError("sampled before the up-front check")
    monkeypatch.setattr(T.MultiFitter, "run", no_run)
    text = CATALOG.replace("2.20", "nan")
    with pytest.raises(SystemExit, match=match):
        cli_batch.main([str(_catalog(tmp_path, text)),
                        str(tmp_path / "o.h5"), *FAST, *flags])


def test_batch_cli_refuses_uplims_with_correlation(tmp_path):
    r = np.eye(5)
    write_fits_image(tmp_path / "r.fits", r)
    with pytest.raises(SystemExit, match="corrfile"):
        cli_batch.main([str(_catalog(tmp_path)), str(tmp_path / "o.h5"),
                        *FAST, "--corrfile", str(tmp_path / "r.fits")])


@pytest.mark.parametrize("flags,item", [
    (["--mesh-devices", "4"], "A11"), (["--profile-dir", "prof"], "A8")])
def test_batch_cli_refuses_waiting_flags(tmp_path, flags, item):
    """A flag whose ROADMAP.md item waits names it; the flag of a ported
    item (A8: --profile-dir) runs and leaves a trace in its directory."""
    if item == "A8":
        prof = tmp_path / flags[1]
        assert cli_batch.main([str(_catalog(tmp_path)),
                               str(tmp_path / "o.h5"), *FAST,
                               flags[0], str(prof)]) == 0
        assert len(list(prof.glob("*.pt.trace.json"))) == 1
        return
    with pytest.raises(SystemExit, match=f"ROADMAP.md.*{item}"):
        cli_batch.main([str(_catalog(tmp_path)), str(tmp_path / "o.h5"),
                        *FAST, *flags])


def test_batch_cli_plot_population_writes_png(tmp_path, capsys):
    """--plot-population (refused until the plots were ported) saves the
    population figure after the --population stage."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    png = tmp_path / "pop.png"
    rc = cli_batch.main([str(_catalog(tmp_path, nsrc=3)),
                         str(tmp_path / "o.h5"), *FAST, "--population", "T",
                         "--population-burn", "10", "--population-steps",
                         "20", "--population-walkers", "8",
                         "--plot-population", str(png)])
    assert rc == 0 and png.stat().st_size > 0
    assert f"population figure -> {png}" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--get-evidence", "--hmc", "--hmc-leapfrog", "4"],
    ["--get-evidence", "--pt", "--pt-rungs", "4", "--pt-beta-min", "0.01"],
    ["--get-evidence", "--summary"],
    ["--population", "T", "--population-burn", "10",
     "--population-steps", "20", "--population-walkers", "8"]])
def test_batch_cli_evidence_and_population_run(tmp_path, capsys, flags):
    """--get-evidence and --population (once refused as A9e and A9f) run
    after the batch fit, HMC or PT on --device cpu: the JAX CLI's lines,
    the batch file's Evidence group (read by the JAX package) or the
    .pop.h5 file."""
    out = tmp_path / "o.h5"
    rc = cli_batch.main([str(_catalog(tmp_path, nsrc=3)), str(out), *FAST,
                         "--nlive", "40", *flags])
    assert rc == 0
    printed = capsys.readouterr().out
    jm = J.MultiFitter.from_h5(str(out))
    if "--get-evidence" in flags:
        ev = jm.evidence
        assert ev.logz.shape == (3,) and np.all(np.isfinite(ev.logz))
        assert (f"ln Z: median {np.median(ev.logz):.4f} over 3 sources "
                f"(median err {np.median(ev.logz_err):.4f})") in printed
        header = [ln for ln in printed.splitlines() if "max-Rhat" in ln]
        assert bool(header) == ("--summary" in flags)
        assert all(ln.rstrip().endswith("lnZ") for ln in header)
    else:
        assert jm.evidence is None
        pop = str(tmp_path / "o.pop.h5")
        assert f"hyper chain written to {pop}" in printed
        back = T.HierarchicalFitter.from_h5(pop, device="cpu")
        assert back.chain_free.shape == (20, 8, 2)


def _mock_catalog(path, nsources, seed):
    """tests/test_cli_batch.py's synthetic catalog: optically thin, no
    alpha, T in [25, 40] K, 5% errors."""
    from mbb_emcee_tpu_torch.models.modified_blackbody import (
        MBBShape, mbb_fnu)
    wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0, 850.0])
    rng = np.random.default_rng(seed)
    trues = np.column_stack([
        rng.uniform(25.0, 40.0, nsources), rng.uniform(1.5, 2.2, nsources),
        np.full(nsources, 250.0), np.full(nsources, 3.5),
        rng.uniform(20.0, 60.0, nsources)])
    z = rng.uniform(1.0, 3.0, nsources)
    lines = ["# mock survey catalog",
             "wave = " + " ".join(f"{w:g}" for w in wave)]
    for i in range(nsources):
        f = mbb_fnu(torch.tensor(trues[i], dtype=torch.float32),
                    torch.tensor(wave, dtype=torch.float32),
                    MBBShape(opthin=True, noalpha=True)).double().numpy()
        unc = 0.05 * f
        flux = f + unc * rng.standard_normal(f.size)
        lines.append(f"SRC{i:03d} {z[i]:.3f} " + " ".join(
            f"{flux[j]:.4f} {unc[j]:.4f}" for j in range(wave.size)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_batch_cli_population(tmp_path, capsys):
    """Twin of tests/test_cli_batch.py's: --population after the batch
    fit prints mu/sigma posteriors and the ESS, and writes the hyper chain
    (read by both packages); the batch file is untouched."""
    import h5py
    from mbb_emcee_tpu import hierarchy as jh
    cat = _mock_catalog(tmp_path / "cat.txt", 4, 8)
    out = str(tmp_path / "batch.h5")
    rc = cli_batch.main([cat, out, "--opthin", "--noalpha", "-w", "64",
                         "-b", "40", "-n", "120", "--seed", "5",
                         "--population", "T", "--population-burn", "60",
                         "--population-steps", "200",
                         "--population-walkers", "16", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "population (4 sources" in text
    assert "T: mu " in text and "sigma " in text
    assert "reweight ESS min" in text
    pop = str(tmp_path / "batch.pop.h5")
    assert f"hyper chain written to {pop}" in text
    with h5py.File(pop) as f:
        assert f.attrs["kind"] == "hierarchy"
        assert [n.decode() for n in f.attrs["hyper_names"]] == ["mu_T",
                                                                "sigma_T"]
        assert f["chain_free"].shape == (200, 16, 2)
        assert f["reweight_ess"].shape == (4,)
    assert jh.HierarchicalFitter.from_h5(pop).free_hyper_names() == [
        "mu_T", "sigma_T"]
    assert J.MultiFitter.from_h5(out).nsources == 4


def test_batch_cli_population_correlated(tmp_path, capsys):
    cat = _mock_catalog(tmp_path / "cat.txt", 4, 12)
    out = str(tmp_path / "batch.h5")
    rc = cli_batch.main([cat, out, "--opthin", "--noalpha", "-w", "64",
                         "-b", "40", "-n", "120", "--seed", "5",
                         "--population", "T", "beta",
                         "--population-correlated",
                         "--population-burn", "60",
                         "--population-steps", "150",
                         "--population-walkers", "16", "--device", "cpu"])
    assert rc == 0
    assert "rho(T,beta)" in capsys.readouterr().out
    back = T.HierarchicalFitter.from_h5(str(tmp_path / "batch.pop.h5"),
                                        device="cpu")
    assert back.population.hyper_names == (
        "mu_T", "mu_beta", "sigma_T", "sigma_beta", "rho_T_beta")


@pytest.mark.parametrize("flags", [
    ["--map", "--population", "T"], ["--map", "--get-evidence"],
    ["--chunk-size", "2", "--population", "T"],
    ["--population", "T", "--population-correlated"],
    ["--population-correlated"]])
def test_batch_cli_population_conflicts_match_jax(tmp_path, flags):
    """Twin of tests/test_cli_batch.py's population conflicts: the port
    exits with the JAX batch CLI's message, before any sampling."""
    from mbb_emcee_tpu import cli_batch as jcli_batch
    cat = _mock_catalog(tmp_path / "cat.txt", 4, 0)
    args = [cat, str(tmp_path / "x.h5"), *flags]
    with pytest.raises(SystemExit) as want:
        jcli_batch.main(args)
    with pytest.raises(SystemExit) as got:
        cli_batch.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
    assert not (tmp_path / "x.h5").exists()


@pytest.mark.parametrize("mode", ["builtin", "responsefile"])
def test_batch_cli_response_modes(tmp_path, mode):
    """--builtin-responses resolves the catalog's 'bands' row against the
    built-in library; --responsefile reads a 'band spec' list. The batch
    file carries the JAX package's pack and reloads in both packages."""
    from mbb_emcee_tpu.response import ResponseSet as JRS
    names = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
    if mode == "builtin":
        flags = ["--builtin-responses"]
        want = JRS.builtin(names).pack(names)
    else:
        (tmp_path / "f.txt").write_text(
            "PACS_100 gauss:100:30\nPACS_160 builtin:PACS_160:33\n"
            "SPIRE_250 box:250:70\nSPIRE_350 SPIRE_350\n"
            "SPIRE_500 delta:500\n")
        flags = ["--responsefile", str(tmp_path / "f.txt")]
        want = JRS.from_file(str(tmp_path / "f.txt")).pack(names)
    out = tmp_path / "resp.h5"
    assert cli_batch.main([str(_catalog(tmp_path, nsrc=3)), str(out),
                           *FAST, *flags]) == 0
    jmf = J.MultiFitter.from_h5(str(out))
    for got, w in zip(jmf._response_pack(), want):
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)
    tmf = T.MultiFitter.from_h5(out, device="cpu")
    for got, w in zip(tmf._response_pack(), want):
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)
    assert np.all(np.isfinite(tmf.par_cen("T")))
    text = "\n".join(ln for ln in CATALOG.splitlines()
                     if not ln.startswith("bands"))
    with pytest.raises(SystemExit, match="bands = "):
        cli_batch.main([str(_catalog(tmp_path, text)),
                        str(tmp_path / "o.h5"), *FAST, *flags])


def test_batch_cli_checkpoint_and_resume(tmp_path):
    """--checkpoint flushes the batch run; --resume continues a shorter
    run to the chains of the uninterrupted one, bit for bit."""
    cat = str(_catalog(tmp_path, nsrc=3))
    whole = tmp_path / "whole.h5"
    assert cli_batch.main([cat, str(whole), *FAST]) == 0
    ck = tmp_path / "b.ckpt.h5"
    short = [a if a != "20" else "10" for a in FAST]
    assert cli_batch.main([cat, str(tmp_path / "a.h5"), *short,
                           "--checkpoint", str(ck),
                           "--checkpoint-interval", "5"]) == 0
    resumed = tmp_path / "resumed.h5"
    assert cli_batch.main([cat, str(resumed), *FAST, "--checkpoint",
                           str(ck), "--checkpoint-interval", "5",
                           "--resume"]) == 0
    a = T.MultiFitter.from_h5(whole, device="cpu")
    b = T.MultiFitter.from_h5(resumed, device="cpu")
    assert b.chain_free.shape == (3, 20, 16, 5)
    assert torch.equal(a.chain_free, b.chain_free)


def test_batch_cli_refuses_chunked_checkpoint(tmp_path, monkeypatch):
    def no_run(*a, **k):
        raise AssertionError("sampled before the up-front check")
    monkeypatch.setattr(T.MultiFitter, "run", no_run)
    with pytest.raises(SystemExit, match="chunk-size"):
        cli_batch.main([str(_catalog(tmp_path)), str(tmp_path / "o.h5"),
                        *FAST, "--chunk-size", "2", "--checkpoint",
                        str(tmp_path / "c.h5")])


def test_single_cli_n_ensembles(tmp_path, capsys):
    """run_mbb_emcee_tpu_torch --n-ensembles 3: three ensembles merged into
    one 48-walker product the JAX package loads; --covfile is refused up
    front."""
    phot = tmp_path / "phot.txt"
    phot.write_text("100.0  11.2  0.8\n160.0  32.1  1.9\n250.0  44.8  2.4\n"
                    "350.0  38.2  2.1\n500.0  22.9  1.5\n")
    out = tmp_path / "fit.h5"
    rc = cli.main([str(phot), str(out), *FAST, "--n-ensembles", "3", "-z",
                   "2.2", "--get-lir"])
    assert rc == 0
    res = J.MBBResults(h5file=str(out))
    assert res.chain.shape == (48, 20, 5)
    assert res.lir_chain.shape == (48 * 20,)
    write_fits_image(tmp_path / "cov.fits", np.eye(5))
    with pytest.raises(SystemExit, match="diagonal"):
        cli.main([str(phot), str(out), *FAST, "--n-ensembles", "2",
                  "--covfile", str(tmp_path / "cov.fits")])
