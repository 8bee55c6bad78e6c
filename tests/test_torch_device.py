"""The port runs on the card unless the caller asks for the CPU: with no
CUDA device and no device named (or the card named), MBBFitter(),
MultiFitter(), MultiFitter.from_h5, MBBResults(h5file=),
HierarchicalFitter(), build_hier_lnprob, nested_sample, the generic tier's
SEDFitter(), SEDResults(h5file=), forecast() and forecast_mbb(), and both
CLIs fail at once with a message naming the CPU switch, and nothing falls
back to the CPU silently."""

import numpy as np
import pytest
import torch

import mbb_emcee_tpu_torch as T
from mbb_emcee_tpu_torch import cli, cli_batch
from mbb_emcee_tpu_torch.fitter import default_device

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
FLUX = np.array([8.6, 23.3, 41.2, 44.6, 45.0])


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card():
    assert default_device() == "cuda"


@pytest.mark.parametrize("make", [
    lambda: T.MBBFitter(), lambda: T.MultiFitter(),
    lambda: T.MBBFitter(nwalkers=16, n_ensembles=2),
    lambda: T.MBBFitter(device="cuda"), lambda: T.MultiFitter(device="cuda")])
def test_constructors_refuse_without_a_card(no_card, make):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_cpu_by_name_still_runs_without_a_card(no_card):
    fit = T.MBBFitter(nwalkers=16, device="cpu")
    fit.set_data(WAVE, FLUX, 0.05 * FLUX)
    fit.run(nburn=2, nsteps=4)
    assert fit.device.type == "cpu" and fit.chain.shape == (16, 4, 5)


def test_from_h5_refuses_without_a_card(no_card, tmp_path):
    mf = T.MultiFitter(nwalkers=16, device="cpu")
    mf.set_data(WAVE, FLUX[None, :], 0.05 * FLUX[None, :])
    mf.run(nburn=2, nsteps=4)
    path = mf.writeToHDF5(str(tmp_path / "b.h5"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.MultiFitter.from_h5(path)
    assert T.MultiFitter.from_h5(path, device="cpu").chain.shape[0] == 1


def test_results_reload_refuses_without_a_card(no_card, tmp_path):
    fit = T.MBBFitter(nwalkers=16, device="cpu")
    fit.set_data(WAVE, FLUX, 0.05 * FLUX)
    fit.run(nburn=2, nsteps=4)
    path = str(tmp_path / "f.h5")
    T.MBBResults(fit=fit).writeToHDF5(path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.MBBResults(h5file=path)
    back = T.MBBResults(h5file=path, device="cpu")
    assert back.device.type == "cpu"
    assert back.posterior_predictive(thin=1).chi2_obs.shape == (16 * 4,)


def test_clis_refuse_without_a_card(no_card, tmp_path, monkeypatch):
    def never(*a, **k):
        raise AssertionError("a fitter was built before the device check")
    monkeypatch.setattr(T.MBBFitter, "__init__", never)
    monkeypatch.setattr(T.MultiFitter, "__init__", never)
    phot = tmp_path / "p.txt"
    phot.write_text("".join(f"{w} {f} {0.05 * f}\n"
                            for w, f in zip(WAVE, FLUX)))
    cat = tmp_path / "c.txt"
    cat.write_text("wave = " + " ".join(f"{w:g}" for w in WAVE) + "\nS0 1.0 "
                   + " ".join(f"{f} {0.05 * f}" for f in FLUX) + "\n")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main([str(phot), str(tmp_path / "o.h5")])
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_batch.main([str(cat), str(tmp_path / "o.h5")])
    assert not (tmp_path / "o.h5").exists()


def test_population_and_nested_refuse_without_a_card(no_card):
    """HierarchicalFitter, build_hier_lnprob, HierarchicalFitter.from_h5 and
    nested_sample follow the same rule; from_batch takes the batch's
    device, here the CPU named by the batch."""
    samples = np.random.default_rng(0).normal(35.0, 4.0, (3, 16, 1))
    pop = T.TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    spec = T.LikelihoodSpec.for_box(pop.lower, pop.upper)
    for make in (lambda: T.HierarchicalFitter(samples, pop),
                 lambda: T.HierarchicalFitter(samples, pop, device="cuda"),
                 lambda: T.hierarchy.build_hier_lnprob(samples, pop, spec),
                 lambda: T.nested_sample(lambda x: x[:, 0], [0.0], [1.0], 0)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, device="cpu")
    mf.set_data(WAVE, np.stack([FLUX, FLUX]), 0.05 * np.stack([FLUX, FLUX]))
    mf.run(nburn=2, nsteps=4)
    hf = T.HierarchicalFitter.from_batch(mf, ("T",))
    assert hf.device.type == "cpu"


def test_generic_tier_refuses_without_a_card(no_card, tmp_path):
    """SEDFitter(), SEDResults(h5file=...), forecast() and forecast_mbb()
    without device= (or with the card named) raise the no-card error; a
    results object of a CPU fit stays on the fit's device."""
    from mbb_emcee_tpu_torch.models.modified_blackbody import log_mbb_fnu
    shape = T.MBBShape(opthin=True, noalpha=True)
    model = T.SEDModel(
        fnu=lambda th, w: torch.exp(log_mbb_fnu(th, w, shape)),
        param_names=("T", "beta", "lambda0", "alpha", "fnorm"),
        lower=[0.1, 0.01, 1.0, 0.01, 1e-5],
        upper=[100.0, 5.0, 2e4, 60.0, 1e7], name="mbb-wrapped")
    fit = T.SEDFitter(model, nwalkers=16, device="cpu")
    fit.set_data(WAVE, FLUX, 0.05 * FLUX)
    fit.fix_param("lambda0", 250.0).fix_param("alpha", 3.5)
    fit.run(nburn=2, nsteps=4)
    path = str(tmp_path / "s.h5")
    fit.results().writeToHDF5(path)
    theta = [30.0, 1.8, 250.0, 3.5, 40.0]
    for make in (lambda: T.SEDFitter(model),
                 lambda: T.SEDFitter(model, device="cuda"),
                 lambda: T.SEDResults(h5file=path, model=model),
                 lambda: T.forecast(model, theta, WAVE, unc=0.05 * FLUX),
                 lambda: T.forecast_mbb(theta, WAVE, unc=0.05 * FLUX)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert fit.results().device.type == "cpu"
    back = T.SEDResults(h5file=path, model=model, device="cpu")
    assert back.posterior_predictive().chi2_obs.shape == (16 * 4,)
