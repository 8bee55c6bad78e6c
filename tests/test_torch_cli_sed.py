"""The port's generic-model command line (run_sed_tpu_torch, cli_sed.py) on
the CPU: twins of tests/test_cli_sed.py with the model file written in
torch and --device cpu; the parser against the JAX package's (every option
with the same default and nargs, plus --device); the refusal of a JAX model
file; files written by either CLI loaded by the other package (the same
two-temperature function written in jnp and in torch); posteriors and MAP
modes of the same catalog through both CLIs; and the per-source summary
table (cli_batch._summary_table, whose PPC column this CLI prints) against
the JAX package's on the same numbers."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import cli_batch as jcli_batch  # noqa: E402
from mbb_emcee_tpu import cli_sed as jcli_sed  # noqa: E402
from mbb_emcee_tpu.sedmulti import (  # noqa: E402
    SEDMultiFitter as JSEDMultiFitter)
from mbb_emcee_tpu_torch import cli_batch  # noqa: E402
from mbb_emcee_tpu_torch.cli_sed import (  # noqa: E402
    build_parser, fit, load_model, main)
from mbb_emcee_tpu_torch.photoz import photoz_mbb  # noqa: E402
from mbb_emcee_tpu_torch.sampler import autocorrelation_time  # noqa: E402
from mbb_emcee_tpu_torch.sedmulti import SEDMultiFitter  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
CPU = ["--device", "cpu"]
WAVE = np.array([60.0, 100.0, 250.0, 500.0, 1100.0])
INITS = ["--initval", "T_cold", "18", "--initval", "T_warm", "45",
         "--initval", "fc", "30", "--initval", "fw", "1.5"]

MODEL_SRC = '''
import torch
from mbb_emcee_tpu_torch import SEDModel, log_mbb_fnu
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def _two_mbb(theta, wave):
    t_c, t_w, beta, f_c, f_w = theta
    pin = [torch.full_like(t_c, 250.0), torch.full_like(t_c, 4.0)]
    p_c = torch.stack([t_c, beta, *pin, f_c])
    p_w = torch.stack([t_w, beta, *pin, f_w])
    return (torch.exp(log_mbb_fnu(p_c, wave, _SHAPE))
            + torch.exp(log_mbb_fnu(p_w, wave, _SHAPE)))


MODEL = SEDModel(fnu=_two_mbb,
                 param_names=("T_cold", "T_warm", "beta", "fc", "fw"),
                 lower=[5.0, 25.0, 0.5, 1e-3, 1e-4],
                 upper=[25.0, 80.0, 4.0, 1e3, 1e2], name="two-temp-cli")
OTHER = 42
'''

# tests/test_cli_sed.py's model file, the JAX package's twin of MODEL_SRC
J_MODEL_SRC = '''
import jax.numpy as jnp
from mbb_emcee_tpu import SEDModel, log_mbb_fnu
from mbb_emcee_tpu.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def _two_mbb(theta, wave):
    t_c, t_w, beta, f_c, f_w = theta
    p_c = jnp.stack([t_c, beta, 250.0, 4.0, f_c])
    p_w = jnp.stack([t_w, beta, 250.0, 4.0, f_w])
    return (jnp.exp(log_mbb_fnu(p_c, wave, _SHAPE))
            + jnp.exp(log_mbb_fnu(p_w, wave, _SHAPE)))


MODEL = SEDModel(fnu=_two_mbb,
                 param_names=("T_cold", "T_warm", "beta", "fc", "fw"),
                 lower=[5.0, 25.0, 0.5, 1e-3, 1e-4],
                 upper=[25.0, 80.0, 4.0, 1e3, 1e2], name="two-temp-cli")
'''

# An optically thin greybody with lambda0 and alpha pinned (T, beta and
# fnorm free): a well-identified posterior for the comparison of the two
# CLIs' chains (tests/test_torch_sedmulti.py's _thin_models).
THIN_SRC = '''
import torch
from mbb_emcee_tpu_torch import SEDModel, log_mbb_fnu
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def _thin(th, w):
    p = torch.stack([th[0], th[1], torch.full_like(th[0], 250.0),
                     torch.full_like(th[0], 4.0), th[2]])
    return torch.exp(log_mbb_fnu(p, w, _SHAPE))


MODEL = SEDModel(fnu=_thin, param_names=("T", "beta", "fnorm"),
                 lower=[5.0, 0.5, 1.0], upper=[80.0, 4.0, 200.0],
                 name="thin-greybody")
'''

J_THIN_SRC = '''
import jax.numpy as jnp
from mbb_emcee_tpu import SEDModel, log_mbb_fnu
from mbb_emcee_tpu.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def _thin(th, w):
    return jnp.exp(log_mbb_fnu(jnp.stack([th[0], th[1], 250.0, 4.0,
                                          th[2]]), w, _SHAPE))


MODEL = SEDModel(fnu=_thin, param_names=("T", "beta", "fnorm"),
                 lower=[5.0, 0.5, 1.0], upper=[80.0, 4.0, 200.0],
                 name="thin-greybody")
'''


def _write(tmp_path, name, src):
    path = tmp_path / name
    path.write_text(src)
    return str(path)


def _write_model(tmp_path):
    return _write(tmp_path, "mymodel.py", MODEL_SRC)


def _two_mbb_np(theta, wave=WAVE):
    """The two-temperature model's fluxes (MODEL_SRC's formula), fp64."""
    from mbb_emcee_tpu_torch import log_mbb_fnu
    from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
    shape = MBBShape(opthin=True, noalpha=True)
    t_c, t_w, beta, f_c, f_w = theta
    flux = 0.0
    for t, f in ((t_c, f_c), (t_w, f_w)):
        p = torch.tensor([t, beta, 250.0, 4.0, f], dtype=torch.float32)
        flux = flux + torch.exp(log_mbb_fnu(
            p, torch.tensor(wave, dtype=torch.float32), shape)).double()
    return flux.numpy()


def _write_catalog(tmp_path, S=3, seed=0):
    rng = np.random.default_rng(seed)
    trues = np.column_stack([
        rng.uniform(15, 22, S), rng.uniform(38, 52, S), np.full(S, 1.8),
        rng.uniform(15, 60, S), rng.uniform(0.5, 3.0, S)])
    z = rng.uniform(1.5, 2.5, S)
    lines = ["# two-component mock catalog",
             "wave = " + " ".join(f"{w:g}" for w in WAVE)]
    for i in range(S):
        f = _two_mbb_np(trues[i])
        unc = 0.05 * f
        flux = f + unc * rng.standard_normal(f.size)
        lines.append(f"SRC{i:02d} {z[i]:.3f} " + " ".join(
            f"{flux[j]:.5f} {unc[j]:.5f}" for j in range(WAVE.size)))
    path = tmp_path / "cat.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), trues


def _reload(out, mpath):
    return SEDMultiFitter.from_h5(out, load_model(mpath), device="cpu")


# -- twins of tests/test_cli_sed.py ---------------------------------------------

def test_parser_and_model_loading(tmp_path):
    assert build_parser().prog == "run_sed_tpu_torch"
    mpath = _write_model(tmp_path)
    model = load_model(mpath)
    assert model.name == "two-temp-cli" and model.npar == 5
    # alternate attribute name and failure modes
    with pytest.raises(SystemExit, match="not an SEDModel"):
        load_model(mpath + ":OTHER")
    with pytest.raises(SystemExit, match="no attribute"):
        load_model(mpath + ":MISSING")
    with pytest.raises(SystemExit, match="not found"):
        load_model(str(tmp_path / "nope.py"))
    bad = tmp_path / "broken.py"
    bad.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(SystemExit, match="importing"):
        load_model(str(bad))


def test_cli_sed_full_run(tmp_path, capsys):
    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path)
    out = str(tmp_path / "out.h5")
    rc = main([mpath, cat, out, "-w", "48", "-b", "60", "-n", "160",
               "--seed", "5", *INITS, "--prior", "beta", "1.8", "0.4",
               "--get-lir", "--get-peaklambda", "--ppc",
               "--derived-thin", "4", "--summary", *CPU])
    assert rc == 0
    txt = capsys.readouterr().out
    assert "posterior predictive [two-temp-cli]" in txt
    assert "max-Rhat" in txt and "PPC p" in txt

    # reload with the model and check recovery
    mf = _reload(out, mpath)
    cen = mf.par_cen("T_cold")
    sig = np.maximum(np.maximum(cen[:, 1], cen[:, 2]), 0.2)
    assert np.all(np.abs(cen[:, 0] - trues[:, 0]) < 6 * sig)
    assert mf.lir_chain is not None      # derived chains persisted
    # ... and the serving loop continues after the reload
    n0 = mf.chain_free.shape[1]
    mf.extend(20)
    assert mf.chain_free.shape[1] == n0 + 20


def test_cli_sed_map_triage(tmp_path, capsys):
    import h5py
    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path, seed=3)
    out = str(tmp_path / "map.h5")
    rc = main([mpath, cat, out, "-w", "16", "--map", "--map-starts", "6",
               *INITS, "--summary", *CPU])
    assert rc == 0
    assert "MAP triage [two-temp-cli]" in capsys.readouterr().out
    with h5py.File(out) as f:
        assert f.attrs["kind"] == "sed-map"
        assert f["Params"].shape == (3, 5)
    # triage refuses chain-only extras
    with pytest.raises(SystemExit, match="need"):
        main([mpath, cat, out, "--map", "--get-lir", *CPU])


def test_cli_sed_checkpoint_and_guards(tmp_path):
    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path, seed=7)
    out = str(tmp_path / "o.h5")
    ck = str(tmp_path / "ck.h5")
    run = [mpath, cat, out, "-w", "32", "-b", "10", "-n", "40", *INITS,
           "--checkpoint", ck, "--checkpoint-interval", "20", *CPU]
    assert main(run) == 0
    # the port's checkpoint is its production-segment file (the JAX
    # package's is a sed-batch file): it is read back by resuming, which
    # restores the finished 40-record run bitwise
    import h5py
    with h5py.File(ck, "r") as f:
        assert int(f.attrs["nsteps_target"]) == 40
    first = _reload(out, mpath)
    assert first.chain_free.shape[1] == 40
    assert main(run + ["--resume"]) == 0
    assert torch.equal(_reload(out, mpath).chain_free, first.chain_free)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main([mpath, cat, out, "--hmc", "--pt", *CPU])
    with pytest.raises(SystemExit, match="stretch-move"):
        main([mpath, cat, out, "--hmc", "--extend-until", "1.1", *CPU])
    with pytest.raises(SystemExit, match="unknown parameter"):
        main([mpath, cat, out, "--lowlim", "T_dust", "5", *CPU])
    # extend preconditions are validated BEFORE the production run
    with pytest.raises(SystemExit, match="4 recorded steps"):
        main([mpath, cat, out, "-n", "6", "--thin", "2",
              "--extend-until", "1.05", *CPU])
    with pytest.raises(SystemExit, match="divisible"):
        main([mpath, cat, out, "-n", "100", "--thin", "2",
              "--extend-until", "1.05", "--extend-step", "7", *CPU])
    # --plot-population is accepted (the shared population stage
    # handles it)
    a = build_parser().parse_args(
        [mpath, cat, out, "--population", "T_cold",
         "--plot-population", "p.png"])
    assert a.plot_population == "p.png"


def test_cli_sed_hmc_and_uplim(tmp_path):
    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path, seed=9)
    out = str(tmp_path / "h.h5")
    rc = main([mpath, cat, out, "-w", "16", "-b", "30", "-n", "60",
               "--hmc", *INITS, "--phot-uplim", "4", *CPU])
    assert rc == 0
    mf = _reload(out, mpath)
    assert np.asarray(mf._spec.uplim_bands)[4]
    assert mf.chain_free.shape[1] == 60


def test_shipped_model_file(tmp_path):
    """examples/two_temp_model_torch.py drives the CLI as shipped."""
    mpath = os.path.join(EXAMPLES, "two_temp_model_torch.py")
    model = load_model(mpath)
    assert model.name == "two-temp-greybody"
    cat, trues = _write_catalog(tmp_path, S=2, seed=13)
    out = str(tmp_path / "ship.h5")
    rc = main([mpath, cat, out, "-w", "16", "-b", "10", "-n", "20",
               "--initval", "T_cold", "18",
               "--initval", "T_warm", "45",
               "--initval", "fnorm_cold", "30",
               "--initval", "fnorm_warm", "1.5", *CPU])
    assert rc == 0 and os.path.exists(out)


def test_cli_sed_population(tmp_path, capsys):
    """--population works on the generic-model shell with the model's own
    parameter names, writes the hyper chain, and refuses the bad combos."""
    import h5py
    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path, S=4, seed=3)
    out = str(tmp_path / "out.h5")
    rc = main([mpath, cat, out, "-w", "48", "-b", "40", "-n", "120",
               "--seed", "5", *INITS, "--population", "T_cold",
               "--population-burn", "60", "--population-steps", "150",
               "--population-walkers", "16", *CPU])
    assert rc == 0
    txt = capsys.readouterr().out
    assert "population (4 sources" in txt
    assert "T_cold: mu " in txt
    pop = str(tmp_path / "out.pop.h5")
    assert f"hyper chain written to {pop}" in txt
    with h5py.File(pop) as f:
        names = [n.decode() for n in f.attrs["hyper_names"]]
        assert names == ["mu_T_cold", "sigma_T_cold"]
    with pytest.raises(SystemExit):
        main([mpath, cat, "x.h5", "--map", "--population", "T_cold", *CPU])
    with pytest.raises(SystemExit):
        main([mpath, cat, "x.h5", "--population", "T_cold",
              "--population-correlated", *CPU])


PZ_WAVE = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])


def _pz_lines(rows, seed):
    """Catalog lines of photo-z mock sources: rows of (name, z, z column
    text)."""
    gen = photoz_mbb(cmb=True, z_upper=10.0)
    rng = np.random.default_rng(seed)
    lines = ["wave = " + " ".join(f"{w:g}" for w in PZ_WAVE)]
    for name, z0, zcol in rows:
        t = torch.tensor([38.0, 1.9, 80.0, 3.0, 10.0, z0])
        f = gen.fnu(t, torch.tensor(PZ_WAVE, dtype=torch.float32)).double(
        ).numpy()
        unc = 0.07 * f
        flux = f + unc * rng.standard_normal(f.size)
        lines.append(f"{name} {zcol} " + " ".join(
            f"{flux[j]:.6f} {unc[j]:.6f}" for j in range(PZ_WAVE.size)))
    return lines


PZ_INITS = ["--initval", "T", "38", "--initval", "beta", "1.9",
            "--initval", "lambda0", "80", "--initval", "fnorm", "10",
            "--initval", "z", "3"]


def test_cli_sed_photoz_serving(tmp_path):
    """The shipped photo-z model file drives the shell end to end:
    joint-z catalog fit, z-marginalized L_IR (--lir-zparam) and dust
    mass (--get-dustmass), both persisted; bad combos pre-validated."""
    import h5py
    ppath = os.path.join(EXAMPLES, "photoz_model_torch.py")
    model = load_model(ppath)
    assert model.param_names[-1] == "z"
    # the catalog z column is a placeholder (the fit samples z itself)
    cat = tmp_path / "pzcat.txt"
    cat.write_text("\n".join(_pz_lines(
        [("PZ00", 2.5, "0.0"), ("PZ01", 4.0, "0.0")], 7)) + "\n")

    out = str(tmp_path / "pz.h5")
    rc = main([ppath, str(cat), out, "-w", "32", "-b", "20", "-n", "40",
               "--seed", "4", "--fixed", "alpha", "3",
               "--prior", "T", "38", "6", *PZ_INITS,
               "--get-lir", "--lir-zparam", "z", "--get-dustmass",
               "--derived-thin", "2", *CPU])
    assert rc == 0
    with h5py.File(out) as f:
        assert "LIRChain" in f and "DustMassChain" in f
        assert np.isfinite(np.asarray(f["LIRChain"])).all()
        assert np.isfinite(np.asarray(f["DustMassChain"])).all()
        assert f["DustMassChain"].attrs["z_param"] == "z"
    mf = SEDMultiFitter.from_h5(out, model, device="cpu")
    assert mf.dustmass_chain is not None and mf.lir_chain is not None

    # pre-validation: unknown z parameter; dustmass on a non-photo-z model
    with pytest.raises(SystemExit, match="lir-zparam"):
        main([ppath, str(cat), "x.h5", "--get-lir",
              "--lir-zparam", "bogus", *CPU])
    mpath = _write_model(tmp_path)
    with pytest.raises(SystemExit, match="photo-z"):
        main([mpath, str(cat), "x.h5", "--get-dustmass", *CPU])


def test_cli_sed_anchor_z(tmp_path):
    """--anchor-z: the catalog z column becomes a per-source prior on the
    sampled z -- spec-z rows pinned, NaN rows free -- in one batch."""
    ppath = os.path.join(EXAMPLES, "photoz_model_torch.py")
    # source 0 has spectroscopy (z column finite); source 1 does not
    lines = _pz_lines([("MX00", 2.5, "2.5"), ("MX01", 4.0, "nan")], 9)
    cat = tmp_path / "mixed.txt"
    cat.write_text("\n".join(lines) + "\n")

    out = str(tmp_path / "mx.h5")
    rc = main([ppath, str(cat), out, "-w", "32", "-b", "120", "-n", "240",
               "--seed", "4", "--fixed", "alpha", "3",
               "--prior", "T", "38", "6", "--anchor-z", "0.02", *PZ_INITS,
               *CPU])
    assert rc == 0
    mf = SEDMultiFitter.from_h5(out, load_model(ppath), device="cpu")
    cen = mf.par_cen("z")
    assert abs(cen[0, 0] - 2.5) < 0.05          # anchored at spec-z
    assert 0.5 * (cen[0, 1] + cen[0, 2]) < 0.05
    assert 0.5 * (cen[1, 1] + cen[1, 2]) > 0.2  # NaN row stays free
    assert "z" in mf._ps_prior                  # prior persisted

    # pre-validation: a model without 'z', all-NaN z, bad sigma
    mpath = _write_model(tmp_path)
    cat2, _ = _write_catalog(tmp_path, S=2, seed=1)
    with pytest.raises(SystemExit, match="sampled 'z'"):
        main([mpath, cat2, "x.h5", "--anchor-z", "0.1", *CPU])
    lines[1] = lines[1].replace("2.5 ", "nan ", 1)
    allnan = tmp_path / "allnan.txt"
    allnan.write_text("\n".join(lines) + "\n")
    with pytest.raises(SystemExit, match="finite redshift"):
        main([ppath, str(allnan), "x.h5", "--anchor-z", "0.1", *CPU])
    with pytest.raises(SystemExit, match="positive"):
        main([ppath, str(cat), "x.h5", "--anchor-z", "-1", *CPU])
    # spec-z outside the model's z box refuses before any device work
    oob = tmp_path / "oob.txt"
    oob.write_text("\n".join(
        [lines[0], lines[2].replace("nan ", "11.5 ", 1)]) + "\n")
    with pytest.raises(SystemExit, match="z box"):
        main([ppath, str(oob), "x.h5", "--anchor-z", "0.1", *CPU])


def test_cli_sed_corrfile(tmp_path):
    """--corrfile: correlated calibration errors through the generic CLI,
    given as a covariance FITS (normalized to its correlation)."""
    from mbb_emcee_tpu_torch.utils.fits import write_fits_image

    mpath = _write_model(tmp_path)
    cat, trues = _write_catalog(tmp_path)
    out = str(tmp_path / "corr.h5")
    sig = np.array([1.0, 2.0, 2.5, 2.0, 1.5])
    C = 0.3 * np.outer(sig, sig) + 0.7 * np.diag(sig ** 2)
    corr = str(tmp_path / "cov.fits")
    write_fits_image(corr, C)
    rc = main([mpath, cat, out, "-w", "24", "-b", "20", "-n", "60",
               "--seed", "5", "--initval", "T_cold", "18",
               "--initval", "T_warm", "45", "--initval", "beta", "1.8",
               "--initval", "fc", "30", "--initval", "fw", "1.0",
               "--corrfile", corr, *CPU])
    assert rc == 0
    back = _reload(out, mpath)
    want = C / np.sqrt(np.outer(np.diag(C), np.diag(C)))
    np.testing.assert_allclose(back._band_corr, want, rtol=1e-12)
    assert back.chain_free.shape[1] == 60

    # upper limits and correlation refuse to combine, at the CLI level
    with pytest.raises(SystemExit, match="corrfile"):
        main([mpath, cat, out, "-w", "24", "-b", "4", "-n", "8",
              "--corrfile", corr, "--phot-uplim", "4", *CPU])


def test_cli_sed_pt_checkpoint_resume(tmp_path):
    """--pt + --checkpoint/--resume on the generic CLI: an interrupted
    tempered serving run resumes to the same target through the engine's
    tier checkpointing."""
    import h5py
    mpath = _write_model(tmp_path)
    cat, _ = _write_catalog(tmp_path)
    ck = str(tmp_path / "pt.ck.h5")
    common = [mpath, cat, "-w", "16", "-b", "10", "--pt",
              "--pt-rungs", "4", "--seed", "5",
              "--initval", "T_cold", "18", "--initval", "T_warm", "45",
              "--initval", "beta", "1.8", "--initval", "fc", "30",
              "--initval", "fw", "1.0",
              "--checkpoint", ck, "--checkpoint-interval", "10", *CPU]
    rc = main(common[:2] + [str(tmp_path / "pt1.h5")] + common[2:]
              + ["-n", "10"])
    assert rc == 0
    with h5py.File(ck, "r") as f:
        assert f.attrs["tier"] == "pt"
    rc = main(common[:2] + [str(tmp_path / "pt2.h5")] + common[2:]
              + ["-n", "30", "--resume"])
    assert rc == 0
    back = _reload(str(tmp_path / "pt2.h5"), mpath)
    assert back.chain_free.shape[1] == 30


# -- the port against the JAX package's CLI ------------------------------------

def _options(parser):
    """{option string: (dest, default, nargs)} of every optional argument,
    and the positional dests in order."""
    opts, pos = {}, []
    for a in parser._actions:
        if not a.option_strings:
            pos.append(a.dest)
        for s in a.option_strings:
            opts[s] = (a.dest, a.default, a.nargs)
    return opts, pos


def test_parser_matches_jax():
    """Every option of the JAX run_sed_tpu parser exists in the port's
    with the same destination, default and nargs; the port adds --device
    alone (default cuda), and the positionals are the same."""
    got, got_pos = _options(build_parser())
    want, want_pos = _options(jcli_sed.build_parser())
    assert got_pos == want_pos == ["modelfile", "catalog", "outfile"]
    for opt, spec in want.items():
        assert got.get(opt) == spec, opt
    assert set(got) - set(want) == {"--device"}
    assert got["--device"][1] == "cuda"


def test_jax_model_file_is_refused(tmp_path):
    """A model file written for the JAX package exits with a message that
    names the torch twins; the check reads the class's module name."""
    jpath = _write(tmp_path, "jmodel.py", J_MODEL_SRC)
    with pytest.raises(SystemExit, match="JAX SEDModel") as e:
        load_model(jpath)
    msg = str(e.value)
    assert "torch model file" in msg
    for twin in ("two_temp_model_torch.py", "cmb_high_z_model_torch.py",
                 "photoz_model_torch.py"):
        assert f"examples/{twin}" in msg


def test_refuses_mesh_devices_by_item(tmp_path):
    """--mesh-devices (ROADMAP A11, ported) no longer refuses by item: on
    the CPU it shards the 2-source catalog over 2 CPU shards and fits the
    unsharded fit's chains bit for bit; a mesh size that does not divide
    the source count exits with the JAX CLI's message."""
    from mbb_emcee_tpu_torch import cli_sed
    assert cli_sed._WAITING == ()
    mpath = _write_model(tmp_path)
    cat, _ = _write_catalog(tmp_path, S=2)
    args = [mpath, cat, str(tmp_path / "o.h5"), "-w", "32", "-b", "4",
            "-n", "8", "--seed", "5", *INITS, *CPU]
    got = fit(args + ["--mesh-devices", "2"]).mf
    want = fit(args).mf
    assert got.mesh.size == 2 and want.mesh is None
    assert torch.equal(got.chain_free, want.chain_free)
    assert torch.equal(got.lnprobability, want.lnprobability)
    with pytest.raises(SystemExit, match=r"^--mesh-devices 3 must divide "
                       r"the source count \(2\)$"):
        main(args + ["--mesh-devices", "3"])


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    """The same two-temperature catalog through both CLIs (the model file
    written in torch and in jnp): MCMC files and --map artifacts."""
    tmp = tmp_path_factory.mktemp("both")
    mpath = _write(tmp, "tmodel.py", MODEL_SRC)
    jpath = _write(tmp, "jmodel.py", J_MODEL_SRC)
    cat, _ = _write_catalog(tmp, S=3, seed=11)
    run = ["-w", "16", "-b", "10", "-n", "20", "--seed", "5", *INITS,
           "--get-lir", "--get-peaklambda", "--loo"]
    tri = ["-w", "16", "--map", "--map-starts", "6", *INITS]
    out = {k: str(tmp / f"{k}.h5") for k in ("port", "jax", "port_map",
                                              "jax_map")}
    assert main([mpath, cat, out["port"], *run, *CPU]) == 0
    assert jcli_sed.main([jpath, cat, out["jax"], *run]) == 0
    assert main([mpath, cat, out["port_map"], *tri, *CPU]) == 0
    assert jcli_sed.main([jpath, cat, out["jax_map"], *tri]) == 0
    return mpath, jpath, out


def test_files_cross_between_the_clis(both_clis):
    """The port CLI's file loads in the JAX SEDMultiFitter.from_h5 with the
    jnp model, and the JAX CLI's in the port's with the torch model:
    chains, derived chains, LOO and source metadata intact."""
    mpath, jpath, out = both_clis
    tmodel = load_model(mpath)
    jmodel = jcli_sed.load_model(jpath)
    for path in (out["port"], out["jax"]):
        t = SEDMultiFitter.from_h5(path, tmodel, device="cpu")
        j = JSEDMultiFitter.from_h5(path, jmodel)
        np.testing.assert_array_equal(t.chain_free.double().numpy(),
                                      np.asarray(j.chain_free, np.float64))
        np.testing.assert_array_equal(np.asarray(t.lir_chain),
                                      np.asarray(j.lir_chain))
        np.testing.assert_array_equal(np.asarray(t.peaklambda_chain),
                                      np.asarray(j.peaklambda_chain))
        np.testing.assert_array_equal(t.loo_result.elpd_loo,
                                      j.loo_result.elpd_loo)
        assert list(t.source_names) == list(j.source_names) == [
            "SRC00", "SRC01", "SRC02"]
        assert t.chain_free.shape == (3, 20, 16, 5)
    # the serving loop continues on the port's own file; a JAX file's
    # sampler state is another generator's, refused by name (ROADMAP.md)
    t = SEDMultiFitter.from_h5(out["port"], tmodel, device="cpu")
    t.extend(4)
    assert t.chain_free.shape[1] == 24
    t = SEDMultiFitter.from_h5(out["jax"], tmodel, device="cpu")
    with pytest.raises(ValueError, match="threefry2x32"):
        t.extend(4)


def test_map_artifacts_match_jax(both_clis):
    """The --map file of each CLI on the two-temperature catalog: the same
    attributes (kind, model name, parameter names) and the same datasets
    with the same shapes and dtypes."""
    import h5py
    _, _, out = both_clis
    with h5py.File(out["port_map"]) as t, h5py.File(out["jax_map"]) as j:
        assert sorted(t.attrs) == sorted(j.attrs)
        for k in ("kind", "model_name"):
            assert t.attrs[k] == j.attrs[k]
        np.testing.assert_array_equal(t.attrs["param_names"],
                                      j.attrs["param_names"])
        assert sorted(t) == sorted(j) == ["Cov", "Interior", "LnProb",
                                           "Params", "Sigma"]
        for k in t:
            assert t[k].shape == j[k].shape, k
            assert t[k].dtype == j[k].dtype, k


def _mc_se(chain):
    """Per-free-parameter standard error of the median of one source's
    (nrec, nwalkers, nfree) chain from its autocorrelation time."""
    chain = np.asarray(chain, np.float64)
    flat = chain.reshape(-1, chain.shape[-1])
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain), nan=1.0),
                     1.0)
    return 1.2533 * flat.std(axis=0) / np.sqrt(flat.shape[0] / tau)


@pytest.fixture(scope="module")
def thin_catalog(tmp_path_factory):
    """A 4-source catalog of the thin greybody (one source missing a band)
    and its model file in torch and in jnp."""
    tmp = tmp_path_factory.mktemp("thin")
    tpath = _write(tmp, "thin.py", THIN_SRC)
    jpath = _write(tmp, "jthin.py", J_THIN_SRC)
    model = load_model(tpath)
    wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0, 850.0])
    rng = np.random.default_rng(21)
    truths = np.column_stack([rng.uniform(20, 40, 4), np.full(4, 1.8),
                              rng.uniform(20, 60, 4)])
    f = torch.func.vmap(model.fnu, in_dims=(0, None))(
        torch.as_tensor(truths, dtype=torch.float32),
        torch.as_tensor(wave, dtype=torch.float32)).double().numpy()
    unc = 0.06 * f
    flux = f + unc * rng.standard_normal(f.shape)
    lines = ["wave = " + " ".join(f"{w:g}" for w in wave)]
    for i in range(4):
        cells = [("nan nan" if (i, j) == (2, 0)
                  else f"{flux[i, j]:.6f} {unc[i, j]:.6f}")
                 for j in range(wave.size)]
        lines.append(f"G{i} 2.0 " + " ".join(cells))
    cat = tmp / "thin.txt"
    cat.write_text("\n".join(lines) + "\n")
    flags = ["--seed", "7", "--initval", "T", "30", "--initval", "beta",
             "1.8", "--initval", "fnorm", "40", "--prior", "beta", "1.8",
             "0.3"]
    return tmp, tpath, jpath, str(cat), flags


def test_posteriors_match_the_jax_cli(thin_catalog):
    """The thin-greybody catalog through both CLIs at -w 48 -b 100 -n 300:
    per-source medians of every free parameter within max(1%,
    3 sigma_MC) (both chains' autocorrelation times; other random
    streams, not bitwise)."""
    tmp, tpath, jpath, cat, flags = thin_catalog
    flags = [*flags, "-w", "48", "-b", "100", "-n", "300",
             "--initscatter", "T", "3", "--initscatter", "beta", "0.18",
             "--initscatter", "fnorm", "4"]
    assert main([tpath, cat, str(tmp / "t.h5"), *flags, *CPU]) == 0
    assert jcli_sed.main([jpath, cat, str(tmp / "j.h5"), *flags]) == 0
    a = SEDMultiFitter.from_h5(str(tmp / "t.h5"), load_model(tpath),
                               device="cpu").chain_free.double().numpy()
    b = np.asarray(JSEDMultiFitter.from_h5(
        str(tmp / "j.h5"), jcli_sed.load_model(jpath)).chain_free,
        np.float64)
    for s in range(4):
        ma = np.median(a[s].reshape(-1, 3), axis=0)
        mb = np.median(b[s].reshape(-1, 3), axis=0)
        tol = np.maximum(0.01 * np.abs(mb),
                         3.0 * np.hypot(_mc_se(a[s]), _mc_se(b[s])))
        assert np.all(np.abs(ma - mb) <= tol), (s, ma, mb, tol)


def test_map_modes_match_the_jax_cli(thin_catalog):
    """--map of the thin-greybody catalog through both CLIs: every mode
    interior in both, the modes within 0.2 Laplace sigma + 1e-3 and the
    sigmas within 2% (tests/test_torch_mapfit.py's run_map tolerance)."""
    import h5py
    tmp, tpath, jpath, cat, flags = thin_catalog
    flags = [*flags, "-w", "16", "--map", "--map-starts", "6"]
    assert main([tpath, cat, str(tmp / "tm.h5"), *flags, *CPU]) == 0
    assert jcli_sed.main([jpath, cat, str(tmp / "jm.h5"), *flags]) == 0
    with h5py.File(tmp / "tm.h5") as t, h5py.File(tmp / "jm.h5") as j:
        got = {k: np.asarray(t[k]) for k in t}
        want = {k: np.asarray(j[k]) for k in j}
    assert got["Interior"].all() and want["Interior"].all()
    # every parameter is free: Params and Sigma are both (4, 3)
    assert np.all(np.abs(got["Params"] - want["Params"])
                  < 0.2 * want["Sigma"] + 1e-3)
    np.testing.assert_allclose(got["Sigma"], want["Sigma"], rtol=2e-2)


class _Batch:
    """The surface _summary_table reads, from fixed numbers."""

    def __init__(self, cen, rhat, names, nsources, source_names=None,
                 logz_pt=None, evidence=None):
        self._cen, self._rhat = cen, rhat
        self.free_param_names = list(names)
        self.source_names = source_names
        self.nsources = nsources
        self.logz_pt, self.evidence = logz_pt, evidence

    def par_cen(self, p):
        return self._cen[p]

    def gelman_rubin(self):
        if self._rhat is None:
            raise ValueError("too few recorded steps")
        return self._rhat


class _PPC:
    def __init__(self, p):
        self.p_value = p


class _Ev:
    def __init__(self, logz):
        self.logz = logz


@pytest.mark.parametrize("case", ["ppc", "ppc+lnz+names", "no-ppc",
                                  "nan-rhat"])
def test_summary_table_matches_jax(case):
    """cli_batch._summary_table(mf, offset, ppc=) prints the JAX package's
    table for the same medians, R-hats, lnZ columns and p-values: the
    'PPC p' column when given a PPC result, none without (the batch CLI's
    own output), and the NaN R-hat of a too-short chain."""
    rng = np.random.default_rng(4)
    S, names = 5, ["T", "beta", "fnorm"]
    cen = {p: np.column_stack([rng.uniform(1, 50, S),
                               rng.uniform(0.01, 3, (S, 2))])
           for p in names}
    rhat = (None if case == "nan-rhat"
            else rng.uniform(0.99, 1.3, (S, 3)))
    kw = {}
    if case == "ppc+lnz+names":
        kw = dict(source_names=[f"SMM{i}" for i in range(S)],
                  logz_pt=(rng.normal(-20, 3, S), None),
                  evidence=_Ev(rng.normal(-21, 3, S)))
    mf = _Batch(cen, rhat, names, S, **kw)
    ppc = None if case == "no-ppc" else _PPC(rng.uniform(0, 1, S))
    for offset in (0, 7):
        got = cli_batch._summary_table(mf, offset=offset, ppc=ppc)
        want = jcli_batch._summary_table(mf, offset=offset, ppc=ppc)
        assert got == want
        assert ("PPC p" in got.splitlines()[0]) == (ppc is not None)
    if ppc is None:
        assert cli_batch._summary_table(mf) == jcli_batch._summary_table(mf)


def test_fit_stage_writes_nothing_and_main_writes(tmp_path, capsys):
    """fit() parses, validates and fits without writing the output file;
    main() on the same arguments prints what fit() printed, writes the
    file, and its chain is bitwise fit()'s (the same seed)."""
    mpath = _write_model(tmp_path)
    cat, _ = _write_catalog(tmp_path, S=2, seed=5)
    out = tmp_path / "o.h5"
    argv = [mpath, cat, str(out), "-w", "16", "-b", "5", "-n", "10",
            *INITS, "--ppc", "--summary", *CPU]
    res = fit(argv)
    printed = capsys.readouterr().out
    assert not out.exists() and res.ppc is not None
    assert res.mf.chain_free.shape == (2, 10, 16, 5)
    assert main(argv) == 0
    again = capsys.readouterr().out
    assert again.startswith(printed) and "PPC p" in again
    back = _reload(str(out), mpath)
    assert torch.equal(back.chain_free, res.mf.chain_free)
