"""mbb_tpu_inspect_torch (mbb_emcee_tpu_torch/cli_inspect.py) on the CPU:
twins of tests/test_cli_inspect.py on files the port writes; every kind
the JAX package writes read by both inspectors (the same dict, text and
JSON); every kind the port writes classified as that kind, never as
`upstream`, with its parameter table against the port's own par_cen; and
the parser against the JAX parser."""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import cli_inspect as jinspect  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import cli_inspect  # noqa: E402
from mbb_emcee_tpu_torch.cli_inspect import inspect_file, main  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
CPU = ["--device", "cpu"]

# An optically thin greybody with lambda0 and alpha pinned (T, beta and
# fnorm free), as a model file of each package's generic tier.
THIN_SRC = '''
import torch
from mbb_emcee_tpu_torch import SEDModel, log_mbb_fnu
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape

_SHAPE = MBBShape(opthin=True, noalpha=True)


def _thin(th, w):
    p = torch.stack([th[0], th[1], torch.full_like(th[0], 250.0),
                     torch.full_like(th[0], 3.5), th[2]])
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
    return jnp.exp(log_mbb_fnu(jnp.stack([th[0], th[1], 250.0, 3.5,
                                          th[2]]), w, _SHAPE))


MODEL = SEDModel(fnu=_thin, param_names=("T", "beta", "fnorm"),
                 lower=[5.0, 0.5, 1.0], upper=[80.0, 4.0, 200.0],
                 name="thin-greybody")
'''


def _mock_flux(shape, seed=0):
    f = mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                torch.tensor(WAVE, dtype=torch.float32),
                shape).double().numpy()
    unc = 0.05 * f
    rng = np.random.default_rng(seed)
    return f + unc * rng.standard_normal(f.size), unc


def _inputs(d):
    """The shared inputs: photometry and catalog text files, both model
    files, fluxes of the thin model."""
    flux, unc = _mock_flux(MBBShape(opthin=True, noalpha=True))
    phot = d / "phot.txt"
    phot.write_text("".join(f"{WAVE[i]} {flux[i]:.4f} {unc[i]:.4f}\n"
                            for i in range(WAVE.size)))
    fl = np.stack([flux, 1.2 * flux, 0.8 * flux])
    un = np.stack([unc, unc, unc])
    cat = d / "cat.txt"
    rows = "".join(f"{n} 2.0 " + " ".join(
        f"{fl[i, j]:.5f} {un[i, j]:.5f}" for j in range(WAVE.size)) + "\n"
        for i, n in enumerate("abc"))
    cat.write_text("wave = " + " ".join(f"{w:g}" for w in WAVE) + "\n"
                   + rows)
    tmodel, jmodel = d / "thin_torch.py", d / "thin_jax.py"
    tmodel.write_text(THIN_SRC)
    jmodel.write_text(J_THIN_SRC)
    return {"phot": str(phot), "cat": str(cat), "tmodel": str(tmodel),
            "jmodel": str(jmodel), "flux": flux, "unc": unc, "fl": fl,
            "un": un}


def _hier_samples():
    rng = np.random.default_rng(0)
    return 35.0 + 4.0 * rng.standard_normal((6, 64, 1))


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    """One small artifact of every kind the port writes, and the object
    that wrote each (for its own summaries)."""
    d = tmp_path_factory.mktemp("inspect_torch")
    x = _inputs(d)
    files, objs = {}, {}

    fit = T.MBBFitter(nwalkers=32, seed=7, opthin=True, noalpha=True,
                      device="cpu")
    fit.set_data(WAVE, x["flux"], x["unc"])
    fit.fix_param("beta", 1.9)
    fit.run(nburn=20, nsteps=40)
    res = T.MBBResults(fit=fit, redshift=2.0)
    res.compute_peaklambda(thin=4)
    files["single"] = str(d / "single.h5")
    res.writeToHDF5(files["single"])
    objs["single"] = res

    mf = T.MultiFitter(nwalkers=16, seed=3, opthin=True, noalpha=True,
                       device="cpu")
    mf.set_data(WAVE, x["fl"], x["un"], source_names=["a", "b", "c"])
    mf.run(nburn=8, nsteps=12)
    files["batch"] = str(d / "batch.h5")
    mf.writeToHDF5(files["batch"])
    objs["batch"] = mf
    mf.run_map(nstarts=2)
    files["map"] = str(d / "map.h5")
    mf.write_map_h5(files["map"])
    objs["map"] = mf

    from mbb_emcee_tpu_torch.cli_sed import load_model
    model = load_model(x["tmodel"])
    sfit = T.SEDFitter(model, nwalkers=16, seed=4, device="cpu")
    sfit.set_data(WAVE, x["flux"], x["unc"])
    sfit.set_param_init("T", 30.0, 3.0)
    sfit.run(nburn=10, nsteps=20)
    files["sed"] = str(d / "sed.h5")
    sres = sfit.results()
    sres.writeToHDF5(files["sed"])
    objs["sed"] = sres

    smf = T.SEDMultiFitter(model, nwalkers=16, seed=5, device="cpu")
    smf.set_data(WAVE, x["fl"], x["un"], source_names=["a", "b", "c"])
    smf.run(nburn=8, nsteps=12)
    files["sed-batch"] = str(d / "sedbatch.h5")
    smf.writeToHDF5(files["sed-batch"])
    objs["sed-batch"] = smf

    from mbb_emcee_tpu_torch import cli_sed
    files["sed-map"] = str(d / "sedmap.h5")
    assert cli_sed.main([x["tmodel"], x["cat"], files["sed-map"], "-w",
                         "16", "--map", "--map-starts", "2", *CPU]) == 0

    hf = T.HierarchicalFitter(
        _hier_samples(), T.TruncatedGaussianPopulation.for_box(
            ("T",), [10.0], [60.0]), nwalkers=16, seed=2, device="cpu")
    hf.fix_param("mu_T", 35.0)
    hf.run(nburn=20, nsteps=30)
    files["hierarchy"] = str(d / "hier.h5")
    hf.writeToHDF5(files["hierarchy"])
    objs["hierarchy"] = hf

    from mbb_emcee_tpu_torch import cli
    files["checkpoint"] = str(d / "ckpt.h5")
    assert cli.main([x["phot"], str(d / "ck_out.h5"), "-w", "16", "-b",
                     "6", "-n", "12", "--opthin", "--noalpha",
                     "--checkpoint", files["checkpoint"],
                     "--checkpoint-interval", "4", *CPU]) == 0

    files["single-map"] = str(d / "map1.h5")
    assert cli.main([x["phot"], files["single-map"], "--opthin",
                     "--noalpha", "--map", "--map-starts", "2", *CPU]) == 0
    return files, objs


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """One small artifact of every kind the JAX package writes, and a
    synthesized upstream mbb_emcee file."""
    import h5py
    d = tmp_path_factory.mktemp("inspect_jax")
    x = _inputs(d)
    files = {}

    fit = J.MBBFitter(nwalkers=32, seed=7, opthin=True, noalpha=True)
    fit.set_data(WAVE, x["flux"], x["unc"])
    fit.fix_param("beta", 1.9)
    fit.run(nburn=20, nsteps=40)
    res = J.MBBResults(fit=fit, redshift=2.0)
    res.compute_peaklambda(thin=4)
    files["single"] = str(d / "single.h5")
    res.writeToHDF5(files["single"])

    mf = J.MultiFitter(nwalkers=16, seed=3, opthin=True, noalpha=True)
    mf.set_data(WAVE, x["fl"], x["un"], source_names=["a", "b", "c"])
    mf.run(nburn=8, nsteps=12)
    files["batch"] = str(d / "batch.h5")
    mf.writeToHDF5(files["batch"])
    mf.run_map(nstarts=2)
    files["map"] = str(d / "map.h5")
    mf.write_map_h5(files["map"])

    from mbb_emcee_tpu import cli_sed as jcli_sed
    model = jcli_sed.load_model(x["jmodel"])
    sfit = J.SEDFitter(model, nwalkers=16, seed=4)
    sfit.set_data(WAVE, x["flux"], x["unc"])
    sfit.set_param_init("T", 30.0, 3.0)
    sfit.run(nburn=10, nsteps=20)
    files["sed"] = str(d / "sed.h5")
    sfit.results().writeToHDF5(files["sed"])

    smf = J.SEDMultiFitter(model, nwalkers=16, seed=5)
    smf.set_data(WAVE, x["fl"], x["un"], source_names=["a", "b", "c"])
    smf.run(nburn=8, nsteps=12)
    files["sed-batch"] = str(d / "sedbatch.h5")
    smf.writeToHDF5(files["sed-batch"])

    files["sed-map"] = str(d / "sedmap.h5")
    assert jcli_sed.main([x["jmodel"], x["cat"], files["sed-map"], "-w",
                          "16", "--map", "--map-starts", "2"]) == 0

    from mbb_emcee_tpu.hierarchy import (
        HierarchicalFitter, TruncatedGaussianPopulation)
    hf = HierarchicalFitter(
        _hier_samples(), TruncatedGaussianPopulation.for_box(
            ("T",), [10.0], [60.0]), nwalkers=16, seed=2)
    hf.fix_param("mu_T", 35.0)
    hf.run(nburn=20, nsteps=30)
    files["hierarchy"] = str(d / "hier.h5")
    hf.writeToHDF5(files["hierarchy"])

    from mbb_emcee_tpu.checkpoint import save_checkpoint
    from mbb_emcee_tpu.sampler import SamplerState
    state = SamplerState(
        key=jax.random.PRNGKey(0),
        pos_a=jnp.zeros((8, 3)), pos_b=jnp.zeros((8, 3)),
        lnp_a=jnp.zeros(8), lnp_b=jnp.zeros(8),
        naccept=jnp.zeros(16, jnp.int32),
        nsteps=jnp.array(12, jnp.int32))
    files["checkpoint"] = str(d / "ckpt.h5")
    save_checkpoint(files["checkpoint"], state,
                    [np.zeros((5, 16, 3)), np.zeros((7, 16, 3))],
                    [np.zeros((5, 16)), np.zeros((7, 16))],
                    meta={"run_id": "deadbeef"},
                    prng_impl="threefry2x32")

    rng = np.random.default_rng(8)
    files["upstream"] = str(d / "legacy.h5")
    with h5py.File(files["upstream"], "w") as f:
        f.attrs["z"] = 2.5
        f.create_dataset("chain", data=TRUE + [1.5, 0.1, 20.0, 0.3, 2.0]
                         * rng.standard_normal((16, 40, 5)))
        f.create_dataset("lnprobability",
                         data=-0.5 * rng.chisquare(3, (16, 40)))
        f.create_dataset("lir", data=rng.lognormal(29, 0.2, 16 * 40))
    return files


# -- twins of tests/test_cli_inspect.py, on the port's files ------------------

def test_single_summary(port_files):
    files, _ = port_files
    info = inspect_file(files["single"])
    assert info["kind"] == "single"
    assert info["nwalkers"] == 32 and info["nsteps"] == 40
    assert info["redshift"] == 2.0
    by_name = {r["name"]: r for r in info["params"]}
    # fixed param reported as fixed, free params as central intervals
    assert by_name["beta"]["fixed"] == pytest.approx(1.9)
    assert abs(by_name["T"]["median"] - TRUE[0]) < 8.0
    assert by_name["T"]["uperr"] > 0 and by_name["T"]["lowerr"] > 0
    # stored derived chain summarized
    dnames = [r["name"] for r in info["derived"]]
    assert "peak lambda" in dnames
    # diagnostics on free dims only (fixed column would divide by zero)
    assert info["max_rhat"] > 0.9
    assert info["min_bulk_ess"] > 1


def test_batch_summary_and_selection(port_files):
    files, _ = port_files
    info = inspect_file(files["batch"])
    assert info["kind"] == "batch"
    assert info["nsources"] == 3 and info["shown"] == 3
    assert info["free_params"] == ["T", "beta", "fnorm"]
    assert [r["source"] for r in info["sources"]] == ["a", "b", "c"]
    t_meds = [
        {p["name"]: p for p in r["params"]}["T"]["median"]
        for r in info["sources"]]
    assert all(abs(t - TRUE[0]) < 10.0 for t in t_meds)
    # the port's batch file holds no XLA continuation state
    assert "continuable" not in info

    # name + index selection resolve to the same rows
    byname = inspect_file(files["batch"], sources=["c"])
    byidx = inspect_file(files["batch"], sources=["2"])
    assert byname["sources"][0]["index"] == 2
    assert byname["sources"][0]["params"] == byidx["sources"][0]["params"]
    with pytest.raises(ValueError, match="unknown source"):
        inspect_file(files["batch"], sources=["nope"])


def test_single_fit_map_artifact(port_files):
    """The single-fit CLI's --map artifact stores a 1-D Params vector and
    a scalar LnProb; the inspector normalizes it."""
    files, _ = port_files
    out = files["single-map"]
    info = inspect_file(out)
    assert info["kind"] == "map"
    assert info["nsources"] == 1
    row = info["sources"][0]
    assert np.isfinite(row["lnprob"])
    by_name = {p["name"]: p for p in row["params"]}
    assert set(by_name) == {"T", "beta", "lambda0", "alpha", "fnorm"}
    assert main([out]) == 0                 # shell render works too


def test_map_summary(port_files):
    files, objs = port_files
    info = inspect_file(files["map"])
    assert info["kind"] == "map"
    assert info["nsources"] == 3
    row = info["sources"][0]
    assert row["source"] == "a"
    by_name = {p["name"]: p for p in row["params"]}
    # full-space values; Laplace sigmas paired onto the free subset
    assert set(by_name) == {"T", "beta", "lambda0", "alpha", "fnorm"}
    for free in ("T", "beta", "fnorm"):
        assert by_name[free]["sigma"] > 0
    assert "sigma" not in by_name["lambda0"]       # opthin: not sampled
    assert np.isfinite(row["lnprob"])
    mf = objs["map"]
    np.testing.assert_allclose(
        [[p["map"] for p in r["params"]] for r in info["sources"]],
        np.asarray(mf.map_params), rtol=1e-6)


def test_main_text_and_json(port_files, capsys):
    files, _ = port_files
    rc = main([files["single"], "--no-diag"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "single" in out and "T = " in out and "(fixed)" in out

    rc = main([files["single"], files["batch"], "--json", "--no-diag"])
    assert rc == 0
    docs = json.loads(capsys.readouterr().out)
    assert [doc["kind"] for doc in docs] == ["single", "batch"]

    # a non-HDF5 file reports an error without stopping the walk
    rc = main(["/etc/hostname", files["map"]])
    err = capsys.readouterr()
    assert rc == 1
    assert "ERROR" in err.err
    assert "MAP triage" in err.out


def test_json_with_zero_results(capsys):
    """--json with every file failing exits rc=1 without a traceback."""
    rc = main(["/etc/hostname", "--json"])
    err = capsys.readouterr()
    assert rc == 1
    assert "ERROR" in err.err
    assert err.out.strip() == ""


def test_hierarchy_free_idx_labels(port_files):
    """A fixed hyper NOT at the tail: chain_free columns are labeled via
    the stored free_idx mapping, not hyper_names[:nfree]."""
    files, _ = port_files
    info = inspect_file(files["hierarchy"], diag=False)
    assert info["kind"] == "hierarchy"
    assert [r["name"] for r in info["params"]] == ["sigma_T"]


def test_checkpoint_chain_so_far(port_files):
    """Checkpoint inspection reports the records so far from the Segments
    layout, and the port's generator as stored."""
    files, _ = port_files
    info = inspect_file(files["checkpoint"], diag=False)
    assert info["kind"] == "checkpoint"
    assert info["prng_impl"] == "philox4x32_10"
    assert info["chain_shape"][0] == 12    # 3 flushes of 4 records
    assert info["chain_shape"][1:] == [16, 3]


def test_percentile_width_ordering(port_files):
    files, _ = port_files
    wide = inspect_file(files["single"], pct=95.0, diag=False)
    narrow = inspect_file(files["single"], pct=50.0, diag=False)
    gw = {r["name"]: r for r in wide["params"]}["T"]
    gn = {r["name"]: r for r in narrow["params"]}["T"]
    assert gw["uperr"] > gn["uperr"]
    assert gw["median"] == pytest.approx(gn["median"])


# -- the JAX package's files through both inspectors -------------------------

def _same(got, want, where="info"):
    """Equal structure, strings, ints and flags; floats (and arrays of
    them) at rtol 1e-10."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=where)
    elif isinstance(want, float):
        assert isinstance(got, float), where
        assert (math.isnan(got) and math.isnan(want)) or math.isclose(
            got, want, rel_tol=1e-10), (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


JAX_KINDS = ["single", "batch", "map", "sed", "sed-batch", "sed-map",
             "hierarchy", "checkpoint", "upstream"]


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_jax_files_read_as_the_jax_inspector_reads_them(kind, jax_files,
                                                        capsys):
    """Every kind the JAX package writes (and an upstream file): the
    port's inspect_file gives the JAX one's dict, _render the same text
    and main --json the same JSON."""
    path = jax_files[kind]
    got, want = inspect_file(path), jinspect.inspect_file(path)
    assert want["kind"] == kind
    _same(got, want)
    for pct in (68.3, 95.0):
        assert cli_inspect._render(got, pct) == jinspect._render(want, pct)
    assert main([path, "--json"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert jinspect.main([path, "--json"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    _same(mine, theirs, "json")


# -- the port's files through the port's inspector ---------------------------

PORT_KINDS = ["single", "batch", "map", "sed", "sed-batch", "sed-map",
              "hierarchy", "checkpoint"]


def _table(rows):
    return {r["name"]: r for r in rows}


@pytest.mark.parametrize("kind", PORT_KINDS)
def test_port_files_are_their_own_kind(kind, port_files):
    """Each kind the port writes is classified as that kind (never
    `upstream`), and its parameter table is the writer's own par_cen at
    the same percentile (rtol 1e-6)."""
    files, objs = port_files
    pct = 90.0
    info = inspect_file(files[kind], pct=pct)
    assert info["kind"] == kind
    if kind in ("single", "sed"):
        res = objs[kind]
        for name, row in _table(info["params"]).items():
            if "fixed" in row:
                continue
            np.testing.assert_allclose(
                [row["median"], row["uperr"], row["lowerr"]],
                res.par_cen(name, percentile=pct), rtol=1e-6)
    elif kind in ("batch", "sed-batch"):
        # the sed-batch file's PhiloxState group is neither a source nor
        # a chain
        assert info["nsources"] == info["shown"] == 3
        fitter = objs[kind]
        for s, src in enumerate(info["sources"]):
            for name, row in _table(src["params"]).items():
                np.testing.assert_allclose(
                    [row["median"], row["uperr"], row["lowerr"]],
                    fitter.par_cen(name, percentile=pct)[s], rtol=1e-6)
    elif kind == "hierarchy":
        hf = objs[kind]
        for name, row in _table(info["params"]).items():
            np.testing.assert_allclose(
                [row["median"], row["uperr"], row["lowerr"]],
                hf.par_cen(name, percentile=pct), rtol=1e-6)


def test_jax_inspector_reads_the_port_single_file_as_upstream(port_files):
    """The JAX inspector accepts only its own package name on a single-fit
    file, so it takes the port's for an upstream mbb_emcee file; the port's
    inspector reads both packages' files (ROADMAP.md section C)."""
    import h5py
    files, _ = port_files
    with h5py.File(files["single"], "r") as f:
        assert f.attrs["package"] == "mbb_emcee_tpu_torch"
        assert jinspect.detect_kind(f) == "upstream"
        assert cli_inspect.detect_kind(f) == "single"


def test_parser_matches_the_jax_parser():
    """Every option of the JAX parser, with the same default and nargs;
    the program is mbb_tpu_inspect_torch."""
    mine, theirs = cli_inspect.build_parser(), jinspect.build_parser()
    assert mine.prog == "mbb_tpu_inspect_torch"

    def opts(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type) for a in p._actions if a.dest != "help"}
    assert opts(mine) == opts(theirs)
    args = mine.parse_args(["x.h5"])
    assert args.files == ["x.h5"] and args.percentile == 68.3
