"""The port's plot helpers (mbb_emcee_tpu_torch/plotting.py) on the CPU:
twins of tests/test_plotting.py (each figure builds headless, holds the
expected artists and saves); the figures' data against the JAX package's
on one chain that the port writes and both packages read (the SED band and
lines at rtol 1e-4, the corner histograms' counts exactly, the P(z) stairs
at rtol 1e-6); the Monte-Carlo population marginal against the JAX one on
the same numpy draws; the generic results' prior reweighting the P(z)
overlay reads; the --plot-* flags of the three command lines; and the
ImportError that names matplotlib where it is missing."""

import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import plotting as jplotting  # noqa: E402
from mbb_emcee_tpu import sed as jsed  # noqa: E402
from mbb_emcee_tpu.hierarchy import (  # noqa: E402
    TruncatedGaussianPopulation as JTruncatedGaussianPopulation)
from mbb_emcee_tpu.photoz import photoz_mbb as j_photoz_mbb  # noqa: E402
from mbb_emcee_tpu.reweight import (  # noqa: E402
    reweight_prior as j_reweight_prior)
from mbb_emcee_tpu_torch import MBBFitter, MBBResults  # noqa: E402
from mbb_emcee_tpu_torch import cli, cli_batch, cli_sed  # noqa: E402
from mbb_emcee_tpu_torch import plotting  # noqa: E402
from mbb_emcee_tpu_torch.hierarchy import (  # noqa: E402
    HierarchicalFitter, TruncatedGaussianPopulation)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)
from mbb_emcee_tpu_torch.photoz import photoz_mbb  # noqa: E402
from mbb_emcee_tpu_torch.reweight import reweight_prior  # noqa: E402
from mbb_emcee_tpu_torch.sed import SEDFitter, SEDResults  # noqa: E402

import matplotlib.pyplot as plt  # noqa: E402

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
PZ_WAVE = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
PZ_TRUTH = np.array([38.0, 1.9, 80.0, 3.0, 10.0, 4.0])


def _thin_flux():
    shape = MBBShape(opthin=True, noalpha=True)
    return mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                   torch.tensor(WAVE, dtype=torch.float32),
                   shape).double().numpy()


@pytest.fixture(scope="module")
def results():
    f = _thin_flux()
    unc = 0.05 * f
    rng = np.random.default_rng(1)
    fit = MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=7,
                    device="cpu")
    fit.set_data(WAVE, f + unc * rng.standard_normal(f.size), unc)
    fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    fit.set_phot_upperlimits([False, False, False, False, True])
    fit.run(nburn=20, nsteps=60)
    return MBBResults(fit=fit)


@pytest.fixture(scope="module")
def pz_fit():
    """tests/test_plotting.py:182's photo-z fit on the port."""
    model = photoz_mbb(cmb=True, z_upper=8.0)
    f = model.fnu(torch.tensor(PZ_TRUTH, dtype=torch.float32),
                  torch.tensor(PZ_WAVE, dtype=torch.float32)).double(
    ).numpy()
    fit = SEDFitter(model, nwalkers=32, seed=4, device="cpu")
    fit.set_data(PZ_WAVE, f, 0.07 * f)
    fit.set_gaussian_prior("T", 38.0, 6.0)
    fit.fix_param("alpha", 3.0)
    for nm, v in zip(model.param_names, PZ_TRUTH):
        fit.set_param_init(nm, v, 0.1 * abs(v))
    fit.run(nburn=40, nsteps=120)
    return fit.results()


# -- twins of tests/test_plotting.py ------------------------------------------

def test_plot_sed(results, tmp_path):
    out = tmp_path / "sed.png"
    fig = results.plot_sed(savefig=str(out))
    ax = fig.axes[0]
    assert ax.get_xscale() == "log" and ax.get_yscale() == "log"
    # Band fill + median + best-fit lines + data + uplim arrows all drew.
    labels = [t.get_text() for t in ax.get_legend().get_texts()]
    assert any("posterior band" in t for t in labels)
    assert "upper limits" in labels
    assert out.exists() and out.stat().st_size > 0
    plt.close(fig)


def test_plot_corner(results, tmp_path):
    out = tmp_path / "corner.png"
    fig = results.plot_corner(savefig=str(out))
    nfree = len(results.free_param_names)
    visible = [a for a in fig.axes if a.get_visible()]
    assert len(visible) == nfree * (nfree + 1) // 2
    assert out.exists() and out.stat().st_size > 0
    plt.close(fig)


def test_plot_corner_param_subset(results):
    fig = results.plot_corner(params=["T", "beta"])
    assert len([a for a in fig.axes if a.get_visible()]) == 3
    plt.close(fig)


def test_plot_chain(results, tmp_path):
    out = tmp_path / "chain.png"
    fig = results.plot_chain(savefig=str(out))
    assert len(fig.axes) == len(results.free_param_names)
    assert out.exists() and out.stat().st_size > 0
    plt.close(fig)


def _photfile(tmp_path):
    f = _thin_flux()
    phot = tmp_path / "phot.txt"
    phot.write_text("".join(f"{w} {fl:.4f} {0.05 * fl:.4f}\n"
                            for w, fl in zip(WAVE, f)))
    return str(phot)


def test_cli_plot_flags(tmp_path):
    """run_mbb_emcee_tpu_torch --plot-sed / --plot-corner / --plot-chain /
    --plot-ppc each write a PNG; --map refuses them (no chain)."""
    pngs = {k: tmp_path / f"{k}.png" for k in ("sed", "corner", "chain",
                                               "ppc")}
    rc = cli.main([_photfile(tmp_path), str(tmp_path / "out.h5"),
                   "--opthin", "--noalpha", "-w", "16", "-b", "10", "-n",
                   "20", "--uplim", "T", "100", "--derived-thin", "4",
                   "--device", "cpu",
                   *[a for k, p in pngs.items()
                     for a in (f"--plot-{k}", str(p))]])
    assert rc == 0
    for p in pngs.values():
        assert p.exists() and p.stat().st_size > 0
    with pytest.raises(SystemExit, match="plot"):
        cli.main([_photfile(tmp_path), str(tmp_path / "m.h5"), "--map",
                  "--plot-sed", "x.png", "--device", "cpu"])


def test_plot_ppc(results, tmp_path):
    out = tmp_path / "ppc.png"
    fig = results.plot_ppc(thin=4, savefig=str(out))
    ax = fig.axes[0]
    assert "posterior predictive: p =" in ax.get_title()
    labels = [t.get_text() for t in ax.get_legend().get_texts()]
    assert any("replicated" in t for t in labels)
    assert out.exists()
    # also accepts a precomputed PPCResult
    ppc = results.posterior_predictive(thin=4)
    fig2 = results.plot_ppc(ppc=ppc)
    assert f"{ppc.p_value:.3f}" in fig2.axes[0].get_title()
    plt.close("all")


def _hier_samples(seed, S, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(35.0, 4.0, S)
    return (x[:, None] + rng.normal(0, 1.5, (S, N)))[..., None]


def test_plot_population(tmp_path):
    samples = _hier_samples(5, 24, 128)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples, pop, nwalkers=16, seed=2, device="cpu")
    hf.run(nburn=50, nsteps=150)
    out = tmp_path / "pop.png"
    fig = hf.plot_population("T", savefig=str(out))
    assert out.exists()
    ax = fig.axes[0]
    # band + median line + histogram patches present
    assert len(ax.lines) >= 1 and len(ax.collections) >= 1
    assert len(ax.patches) > 0
    with pytest.raises(ValueError):
        hf.plot_population("beta")
    plt.close("all")


class _NoMarginalPop:
    """A 'user' population model: the fitting contract only (ln_dist
    etc.), NO marginal_pdf -- plot_population must fall back to the
    Monte-Carlo band instead of raising."""

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def __getattr__(self, name):
        if name == "marginal_pdf":
            raise AttributeError(name)
        return getattr(self._inner, name)


def test_plot_population_without_marginal_pdf(tmp_path):
    samples = _hier_samples(6, 16, 96)
    pop = _NoMarginalPop(
        TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0]))
    assert not hasattr(pop, "marginal_pdf")
    hf = HierarchicalFitter(samples, pop, nwalkers=16, seed=2, device="cpu")
    hf.run(nburn=40, nsteps=120)
    out = tmp_path / "pop_fallback.png"
    fig = hf.plot_population("T", n_draw=64, savefig=str(out))
    assert out.exists()
    ax = fig.axes[0]
    assert len(ax.lines) >= 1 and len(ax.collections) >= 1
    plt.close("all")


def test_mc_marginal_matches_exact():
    """The fallback's numerics against the built-in exact marginals:
    grid evaluation is exact for 1-parameter populations; the
    uniform-importance marginalization converges for 2-parameter ones."""
    x = np.linspace(12.0, 58.0, 101)

    pop1 = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    phi1 = np.array([35.0, 4.0])
    np.testing.assert_allclose(
        plotting._mc_marginal(pop1, 0, device="cpu")(phi1, x),
        pop1.marginal_pdf(phi1, 0, x), rtol=2e-4, atol=1e-7)

    pop2 = TruncatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 4.0])
    phi2 = np.array([35.0, 1.9, 4.0, 0.3])
    got = plotting._mc_marginal(pop2, 0, n_mc=4096, device="cpu")(phi2, x)
    want = pop2.marginal_pdf(phi2, 0, x)
    # MC marginalization over the beta box: ~1/sqrt(4096) relative error
    np.testing.assert_allclose(got, want, rtol=0.08, atol=5e-4)


def test_plot_pz(pz_fit, tmp_path):
    """The photo-z P(z) figure: histogram curve + interval markers,
    reweighted overlay, truth marker; unreliable overlays say so."""
    rw = reweight_prior(pz_fit, "T", 36.0, 6.0)
    out = tmp_path / "pz.png"
    fig = pz_fit.plot_pz(reweight=rw, z_true=4.0, savefig=str(out))
    assert out.exists()
    ax = fig.axes[0]
    labels = [t.get_text() for t in ax.get_legend().get_texts()]
    assert any(lab.startswith("P(z)") for lab in labels)
    assert any("reweighted" in lab for lab in labels)
    assert any("z = 4" in lab for lab in labels)
    # median + two interval + truth vlines drew
    assert len(ax.lines) >= 4
    plt.close("all")


# -- figure data against the JAX package on one chain -------------------------

def _line_data(fig):
    ax = fig.axes[0]
    return [np.asarray(ln.get_ydata(), float) for ln in ax.lines]


def _band(fig):
    """The fill_between band's vertices (the first PolyCollection)."""
    from matplotlib.collections import PolyCollection
    polys = [c for c in fig.axes[0].collections
             if isinstance(c, PolyCollection)]
    return np.concatenate([p.vertices for p in polys[0].get_paths()])


@pytest.fixture(scope="module")
def shared_mbb(results, tmp_path_factory):
    """The port's MBB chain written by the port and read by both
    packages."""
    path = str(tmp_path_factory.mktemp("shared") / "mbb.h5")
    results.writeToHDF5(path)
    return (MBBResults(h5file=path, device="cpu"),
            J.MBBResults(h5file=path))


def test_plot_sed_data_matches_jax(shared_mbb):
    """plot_sed's band vertices and median / best-fit lines against the
    JAX package's on the same chain: rtol 1e-4 (two fp32 model
    evaluations, torch and jnp, over the same samples)."""
    got_res, want_res = shared_mbb
    got = plotting.plot_sed(got_res, thin=2)
    want = jplotting.plot_sed(want_res, thin=2)
    np.testing.assert_allclose(_band(got), _band(want), rtol=1e-4)
    g, w = _line_data(got), _line_data(want)
    assert len(g) == len(w) >= 2
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    plt.close("all")


def test_plot_corner_counts_match_jax(shared_mbb):
    """plot_corner's 1-D step histograms and 2-D histograms hold exactly
    the JAX package's values on the same chain."""
    got_res, want_res = shared_mbb
    got = plotting.plot_corner(got_res, bins=20)
    want = jplotting.plot_corner(want_res, bins=20)
    n = 0
    for ga, wa in zip(got.axes, want.axes):
        assert ga.get_visible() == wa.get_visible()
        for gp, wp in zip(ga.patches, wa.patches):
            np.testing.assert_array_equal(gp.get_xy(), wp.get_xy())
            n += 1
        for gc, wc in zip(ga.collections, wa.collections):
            np.testing.assert_array_equal(np.asarray(gc.get_array()),
                                          np.asarray(wc.get_array()))
            n += 1
    nfree = len(got_res.free_param_names)
    assert n == nfree * (nfree + 1) // 2
    plt.close("all")


@pytest.fixture(scope="module")
def shared_pz(pz_fit, tmp_path_factory):
    """The port's photo-z chain written by the port and read by both
    packages' SEDResults (each with its own photoz_mbb)."""
    path = str(tmp_path_factory.mktemp("shared_pz") / "pz.h5")
    pz_fit.writeToHDF5(path)
    return (SEDResults(h5file=path, model=photoz_mbb(cmb=True, z_upper=8.0),
                       device="cpu"),
            jsed.SEDResults(h5file=path,
                            model=j_photoz_mbb(cmb=True, z_upper=8.0)))


def _stairs(fig):
    from matplotlib.patches import StepPatch
    return [p.get_data().values for p in fig.axes[0].patches
            if isinstance(p, StepPatch)]


def test_plot_pz_stairs_match_jax(shared_pz):
    """plot_pz's P(z) stairs (and the reweighted overlay's, each package
    reweighting its own reading of the chain) against the JAX package's at
    rtol 1e-6; the SED band of the photo-z model at rtol 1e-4."""
    got_res, want_res = shared_pz
    got = plotting.plot_pz(got_res, reweight=reweight_prior(
        got_res, "T", 36.0, 6.0), z_true=4.0)
    want = jplotting.plot_pz(want_res, reweight=j_reweight_prior(
        want_res, "T", 36.0, 6.0), z_true=4.0)
    g, w = _stairs(got), _stairs(want)
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    got = plotting.plot_sed(got_res, thin=4, n_wave=60)
    want = jplotting.plot_sed(want_res, thin=4, n_wave=60)
    np.testing.assert_allclose(_band(got), _band(want), rtol=1e-4)
    for a, b in zip(_line_data(got), _line_data(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    plt.close("all")


def test_reweight_of_generic_results_matches_jax(shared_pz):
    """reweight_prior on an SEDResults resolves the model's own parameter
    names (the P(z) overlay reads its 'z' column) and gives the JAX
    package's weights and summaries on the same chain."""
    got_res, want_res = shared_pz
    got = reweight_prior(got_res, "T", 33.0, 5.0)
    want = j_reweight_prior(want_res, "T", 33.0, 5.0)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-9)
    np.testing.assert_allclose(got.par_cen("z"), want.par_cen("z"),
                               rtol=1e-9)
    np.testing.assert_array_equal(got.parameter_chain("z"),
                                  want.parameter_chain("z"))
    assert got.reliable == want.reliable


@pytest.mark.parametrize("n_mc", [64, 4096])
def test_mc_marginal_matches_jax(n_mc):
    """_mc_marginal of the 1- and 2-parameter truncated normals of
    tests/test_plotting.py:158-179 against the JAX function with the same
    seed and n_mc: the importance draws are the same numpy draws, so the
    two agree to fp32 evaluation, rtol 1e-5."""
    x = np.linspace(12.0, 58.0, 101)
    cases = [((("T",), [10.0], [60.0]), np.array([35.0, 4.0])),
             ((("T", "beta"), [10.0, 0.5], [60.0, 4.0]),
              np.array([35.0, 1.9, 4.0, 0.3]))]
    for (names, lo, hi), phi in cases:
        got = plotting._mc_marginal(
            TruncatedGaussianPopulation.for_box(names, lo, hi), 0,
            n_mc=n_mc, seed=3, device="cpu")(phi, x)
        want = jplotting._mc_marginal(
            JTruncatedGaussianPopulation.for_box(names, lo, hi), 0,
            n_mc=n_mc, seed=3)(phi, x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


# -- the population figure through the command lines --------------------------

CATALOG = """\
wave = 100 160 250 350 500
SMM_J0001   2.20   11.2 0.8  32.1 1.9  44.8 2.4  38.2 2.1  22.9 1.5
SMM_J0002   1.85    9.4 0.7  28.8 1.7  40.1 2.2  35.5 2.0  21.3 1.4
SMM_J0004   1.40   14.0 0.9  35.0 2.0  45.0 2.5  36.5 2.0  21.0 1.4
"""


def test_batch_cli_plot_population_per_parameter(tmp_path, capsys):
    """--plot-population with two --population parameters writes one PNG
    per parameter, suffixed by its name."""
    cat = tmp_path / "cat.txt"
    cat.write_text(CATALOG)
    rc = cli_batch.main([str(cat), str(tmp_path / "o.h5"), "-w", "16", "-b",
                         "10", "-n", "20", "--device", "cpu",
                         "--population", "T", "beta",
                         "--population-burn", "10",
                         "--population-steps", "20",
                         "--population-walkers", "16",
                         "--plot-population", str(tmp_path / "pop.png")])
    assert rc == 0
    printed = capsys.readouterr().out
    for p in ("T", "beta"):
        png = tmp_path / f"pop_{p}.png"
        assert png.stat().st_size > 0
        assert f"population figure -> {png}" in printed


def test_sed_cli_plot_population(tmp_path, capsys):
    """run_sed_tpu_torch --population T --plot-population saves the figure
    after the batch file is on disk."""
    import os
    mpath = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "two_temp_model_torch.py")
    lines = ["wave = 60 100 250 500 1100"]
    model = cli_sed.load_model(mpath)
    rng = np.random.default_rng(2)
    for i in range(3):
        t = np.array([rng.uniform(15, 22), rng.uniform(38, 52), 1.8,
                      rng.uniform(15, 60), rng.uniform(0.5, 3.0)])
        f = model.fnu(torch.tensor(t, dtype=torch.float32),
                      torch.tensor([60.0, 100.0, 250.0, 500.0, 1100.0])
                      ).double().numpy()
        lines.append(f"S{i} 2.0 " + " ".join(
            f"{v:.5f} {0.05 * v:.5f}" for v in f))
    cat = tmp_path / "cat.txt"
    cat.write_text("\n".join(lines) + "\n")
    png = tmp_path / "tcold.png"
    rc = cli_sed.main([mpath, str(cat), str(tmp_path / "o.h5"), "-w", "16",
                       "-b", "10", "-n", "20", "--initval", "T_cold", "18",
                       "--initval", "T_warm", "45", "--device", "cpu",
                       "--population", "T_cold", "--population-burn", "10",
                       "--population-steps", "20", "--population-walkers",
                       "8", "--plot-population", str(png)])
    assert rc == 0 and png.stat().st_size > 0
    assert f"population figure -> {png}" in capsys.readouterr().out


# -- where matplotlib is missing ----------------------------------------------

def test_missing_matplotlib_raises_import_error(results, monkeypatch):
    """Without matplotlib the module still imports and each plot call
    raises the ImportError that names matplotlib (the card's machine has
    none)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    import importlib
    importlib.reload(plotting)
    for hook in (results.plot_sed, results.plot_corner, results.plot_chain,
                 results.plot_ppc):
        with pytest.raises(ImportError, match="matplotlib"):
            hook()
