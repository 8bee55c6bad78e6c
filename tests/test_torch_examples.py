"""The torch twins of the generic examples (examples/*_torch.py) on the CPU.

Tier-1: each model-file twin, loaded through the port's
cli_sed.load_model, against the JAX file's MODEL loaded through the JAX
CLI's (names, bounds and name exactly; fnu on 64 in-box thetas x the JAX
tests' wavelengths at rtol 1e-5, with the CMB visibility's conditioning
term of tests/test_torch_photoz.py for the CMB models), and each model file
driving run_sed_tpu_torch as shipped (the twin of
tests/test_cli_sed.py:192). fit_single_source_torch.py runs in tier-1 as a
subprocess with MBB_EXAMPLE_QUICK=1 --device cpu, as tests/test_examples.py
runs its original in the fast lane; the slow lane runs the other script
twins so. No twin imports jax or the JAX package (read from the source)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import cli_sed as jcli_sed  # noqa: E402
from mbb_emcee_tpu_torch import cli_sed  # noqa: E402
from mbb_emcee_tpu_torch.models.cmb import (  # noqa: E402
    dust_temperature_with_cmb, log_cmb_visibility)
from mbb_emcee_tpu_torch.sed import batched_fnu  # noqa: E402
from mbb_emcee_tpu_torch.sedmulti import SEDMultiFitter  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _two_temp_thetas(rng, n):
    return np.column_stack([
        rng.uniform(5.0, 25.0, n), rng.uniform(25.0, 120.0, n),
        rng.uniform(0.5, 4.0, n), rng.uniform(1e-3, 1e3, n),
        rng.uniform(1e-4, 1e2, n)])


def _cmb_thetas(rng, n):
    # tests/test_torch_cmb.py's populated part of the box
    return np.column_stack([
        rng.uniform(15.0, 60.0, n), rng.uniform(1.0, 2.5, n),
        rng.uniform(80.0, 300.0, n), rng.uniform(2.0, 5.0, n),
        rng.uniform(1.0, 50.0, n)])


def _photoz_thetas(rng, n):
    # tests/test_torch_photoz.py's, with z over the file's [0, 10] box
    return np.column_stack([
        rng.uniform(15.0, 60.0, n), rng.uniform(1.0, 2.5, n),
        rng.uniform(50.0, 300.0, n), rng.uniform(1.0, 5.0, n),
        rng.uniform(1.0, 50.0, n), rng.uniform(0.0, 10.0, n)])


# file stem -> (thetas, the JAX tests' wavelengths, the model's fixed
# redshift (None: none; "param": sampled), run_sed flags of the shipped
# file's docstring at the smoke size)
MODEL_FILES = {
    "two_temp_model": (
        _two_temp_thetas, [60.0, 100.0, 250.0, 500.0, 1100.0], None,
        ["--initval", "T_cold", "18", "--initval", "T_warm", "45",
         "--initval", "fnorm_cold", "30", "--initval", "fnorm_warm",
         "1.5"]),
    "cmb_high_z_model": (
        _cmb_thetas, [250.0, 450.0, 850.0, 1300.0, 2000.0, 3000.0], 5.0,
        ["--fixed", "lambda0", "100", "--fixed", "alpha", "3",
         "--lowlim", "T", "10", "--uplim", "T", "60"]),
    "photoz_model": (
        _photoz_thetas, [250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0],
        "param", ["--fixed", "alpha", "3", "--prior", "T", "38", "6",
                  "--initval", "z", "3"]),
}


def _paths(stem):
    return (os.path.join(EXAMPLES, f"{stem}_torch.py"),
            os.path.join(EXAMPLES, f"{stem}.py"))


def _vis_tol(th, wave, z):
    """2e-6 (e^-vis - 1) at each band and at the normalization point: the
    CMB visibility's amplification of an ulp of its log-ratio near
    T_dust ~ T_CMB(z) (tests/test_torch_photoz.py's rule), fp64."""
    th = torch.as_tensor(th, dtype=torch.float64)
    z = (th[:, 5] if z == "param"
         else torch.full((th.shape[0],), float(z), dtype=torch.float64))
    t_d = dust_temperature_with_cmb(th[:, 0], th[:, 1], z)
    w = torch.as_tensor(wave, dtype=torch.float64)
    vis = log_cmb_visibility(w[None] / (1.0 + z[:, None]), t_d[:, None],
                             z[:, None]).numpy()
    vis_n = log_cmb_visibility(500.0 / (1.0 + z), t_d, z).numpy()
    return 2e-6 * (np.expm1(-vis) + np.expm1(-vis_n)[:, None])


@pytest.mark.parametrize("stem", list(MODEL_FILES))
def test_model_file_twin_matches_jax(stem):
    """The torch twin's MODEL against the JAX file's: parameter names,
    bounds and model name exactly; fnu on 64 in-box thetas x the JAX
    tests' wavelengths, |ln f_port - ln f_jax| <= 1e-5 (plus the CMB
    visibility's conditioning for the CMB models)."""
    make, wave, z, _ = MODEL_FILES[stem]
    tpath, jpath = _paths(stem)
    tm, jm = cli_sed.load_model(tpath), jcli_sed.load_model(jpath)
    assert tm.name == jm.name and tm.param_names == jm.param_names
    np.testing.assert_array_equal(tm.lower, jm.lower)
    np.testing.assert_array_equal(tm.upper, jm.upper)
    th = make(np.random.default_rng(64), 64).astype(np.float32)
    assert np.all((th >= tm.lower) & (th <= tm.upper))
    wave = np.asarray(wave, np.float32)
    got = batched_fnu(tm.fnu)(torch.as_tensor(th),
                              torch.as_tensor(wave)).numpy()
    want = np.asarray(jax.vmap(lambda p: jm.fnu(p, jnp.asarray(wave)))(
        jnp.asarray(th)))
    assert got.shape == want.shape == (64, wave.size)
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    tol = np.full(got.shape, 1e-5)
    if z is not None:
        tol += _vis_tol(th, wave, z)
    d = np.abs(np.log(got) - np.log(want))
    assert np.all(d <= tol), float(np.max(d - tol))


@pytest.mark.parametrize("stem", list(MODEL_FILES))
def test_shipped_model_file(stem, tmp_path):
    """Each model-file twin drives run_sed_tpu_torch as shipped: a
    2-source mock catalog made from the file's own MODEL near the truth
    its docstring's flags assume, fitted on --device cpu and read back."""
    make, wave, _, flags = MODEL_FILES[stem]
    tpath, _ = _paths(stem)
    model = cli_sed.load_model(tpath)
    truth = {"two_temp_model": [18.0, 45.0, 1.8, 30.0, 1.5],
             "cmb_high_z_model": [22.0, 1.8, 100.0, 3.0, 8.0],
             "photoz_model": [38.0, 1.9, 80.0, 3.0, 10.0, 3.0]}[stem]
    rng = np.random.default_rng(13)
    lines = ["wave = " + " ".join(f"{w:g}" for w in wave)]
    for i in range(2):
        t = torch.tensor(truth, dtype=torch.float32)
        f = model.fnu(t, torch.tensor(wave, dtype=torch.float32)).double(
        ).numpy()
        unc = 0.05 * f
        flux = f + unc * rng.standard_normal(f.size)
        lines.append(f"S{i} 2.0 " + " ".join(
            f"{flux[j]:.6g} {unc[j]:.6g}" for j in range(len(wave))))
    cat = tmp_path / "cat.txt"
    cat.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "ship.h5")
    rc = cli_sed.main([tpath, str(cat), out, "-w", "16", "-b", "10", "-n",
                       "20", *flags, "--device", "cpu"])
    assert rc == 0 and os.path.exists(out)
    back = SEDMultiFitter.from_h5(out, model, device="cpu")
    assert back.chain_free.shape[:3] == (2, 20, 16)
    assert np.all(np.isfinite(back.chain_free.numpy()))


FAST = ["fit_single_source_torch.py"]
SCRIPTS = ["photoz_fit_torch.py", "survey_forecast_torch.py",
           "custom_model_torch.py", "fit_covariance_uplims_torch.py",
           "fit_with_responses_torch.py", "serve_batches_torch.py",
           "serve_ragged_catalog_torch.py",
           "serve_correlated_tempered_torch.py",
           "model_comparison_torch.py", "population_inference_torch.py"]


def _run(name, tmp_path):
    """`python examples/<name> --device cpu` with MBB_EXAMPLE_QUICK=1,
    from a temp directory; returns its standard output."""
    env = dict(os.environ, MBB_EXAMPLE_QUICK="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, name), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}")
    assert proc.stdout.strip()
    return proc.stdout


@pytest.mark.parametrize("name", FAST)
def test_example_quick(name, tmp_path):
    """The fast-lane twin runs to its end and reloads its own file."""
    out = _run(name, tmp_path)
    assert "round-trip T:" in out
    assert (tmp_path / "fit.h5").is_file()


@pytest.mark.slow
@pytest.mark.parametrize("name", SCRIPTS)
def test_example_slow_lane(name, tmp_path):
    """The script twin runs to its end as `python examples/<name>
    --device cpu` with MBB_EXAMPLE_QUICK=1, from a temp directory."""
    _run(name, tmp_path)


def test_twins_import_no_jax():
    """Every examples/*_torch.py twin, each beside its original, imports
    neither jax nor the JAX package (read from the source: no import
    statement names them)."""
    import ast
    twins = sorted(n for n in os.listdir(EXAMPLES) if n.endswith("_torch.py"))
    assert set(FAST + SCRIPTS) <= set(twins)
    for name in twins:
        assert os.path.isfile(os.path.join(EXAMPLES, name[:-9] + ".py"))
        with open(os.path.join(EXAMPLES, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "mbb_emcee_tpu"), (
                    f"{name}:{node.lineno} imports {mod}")
