"""The PT and HMC tiers' checkpoints, files and command lines in the port on
the CPU: save_tier_checkpoint / load_tier_checkpoint in the JAX package's
layout (either package reads the other's arrays; a file of the wrong tier
is refused with the JAX message, a JAX tier checkpoint for its generator),
MultiFitter.run_pt / run_hmc resumed from a checkpoint bit for bit the
uninterrupted run, the batch file's PTEvidence and HMC groups and the
single-fit file's PTEvidence attrs crossing between the packages both ways,
and --pt / --hmc in both CLIs with the JAX CLIs' conflict messages."""

import re
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import checkpoint as jck  # noqa: E402
from mbb_emcee_tpu import cli as jcli, cli_batch as jcli_batch  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import checkpoint as tck  # noqa: E402
from mbb_emcee_tpu_torch import cli, cli_batch  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    ModifiedBlackbody)

REPO = Path(__file__).resolve().parents[1]
WAVE = np.array([250.0, 350.0, 500.0, 850.0, 1100.0])


def _data(S=3, seed=7):
    rng = np.random.default_rng(seed)
    Ts, fns = np.linspace(26.0, 36.0, S), np.linspace(30.0, 55.0, S)
    flux = np.stack([ModifiedBlackbody(
        T=Ts[i], beta=1.9, lambda0=250.0, alpha=2.0, fnorm=fns[i],
        opthin=True, noalpha=True)(torch.tensor(WAVE, dtype=torch.float32))
        .double().numpy() for i in range(S)])
    unc = 0.05 * flux
    return flux + rng.normal(0.0, unc), unc


def _fitter(flux_scale=1.0, seed=5):
    flux, unc = _data()
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=seed,
                       device="cpu")
    mf.set_uplim("T", 80.0)
    mf.set_data(WAVE, flux * flux_scale, unc,
                source_names=["a", "b", "c"])
    return mf


# -- the file layout -----------------------------------------------------------

def _arrays(rng):
    state = {"pos": rng.normal(size=(3, 4, 8, 2)).astype(np.float32),
             "nsteps": np.int64(12), "seed": np.uint64(2 ** 63 + 5),
             "step": np.int64(77)}
    aux = {"betas": np.tile([1.0, 0.1, 0.01, 0.0], (3, 1)),
           "ss_m": rng.normal(size=(3, 3))}
    blocks = [rng.normal(size=(3, n, 8, 2)).astype(np.float32)
              for n in (5, 4)]
    lnps = [rng.normal(size=(3, n, 8)).astype(np.float32) for n in (5, 4)]
    return state, aux, blocks, lnps


def test_tier_checkpoint_round_trip_in_the_jax_layout(tmp_path):
    """The port's file: attrs tier / multi / prng_impl, State and Aux
    groups, O(new) chain segments. Both packages' loaders read it back; a
    second flush of the same run appends one segment."""
    rng = np.random.default_rng(0)
    state, aux, blocks, lnps = _arrays(rng)
    path = str(tmp_path / "pt.h5")
    meta = {"nwalkers": 8, "run_id": "r1"}
    tck.save_tier_checkpoint(path, "pt", state, blocks[:1], lnps[:1], meta,
                             aux_arrays=aux)
    tck.save_tier_checkpoint(path, "pt", state, blocks, lnps, meta,
                             aux_arrays=aux)
    with h5py.File(path, "r") as f:
        assert f.attrs["tier"] == "pt" and bool(f.attrs["multi"])
        assert f.attrs["prng_impl"] == tck.PRNG_IMPL
        assert sorted(f["Segments"]) == ["seg00000", "seg00001"]
        assert set(f["State"]) == set(state) and set(f["Aux"]) == set(aux)
    for load in (tck.load_tier_checkpoint, jck.load_tier_checkpoint):
        st, ax, chain, lnp, got = load(path, "pt")
        for k, v in state.items():
            np.testing.assert_array_equal(np.asarray(st[k]), v)
        for k, v in aux.items():
            np.testing.assert_array_equal(ax[k], v)
        np.testing.assert_array_equal(chain, np.concatenate(blocks, 1))
        np.testing.assert_array_equal(lnp, np.concatenate(lnps, 1))
        assert got["prng_impl"] == tck.PRNG_IMPL and got["run_id"] == "r1"
    assert int(tck.load_tier_checkpoint(path, "pt")[0]["seed"]) == \
        2 ** 63 + 5


def test_wrong_tier_and_stretch_checkpoint_refused_as_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    state, aux, blocks, lnps = _arrays(rng)
    path = str(tmp_path / "pt.h5")
    tck.save_tier_checkpoint(path, "pt", state, blocks, lnps, {})
    mf = _fitter().run(nburn=2, nsteps=4, checkpoint=str(tmp_path / "s.h5"),
                       checkpoint_interval=2)
    for p, tier in ((path, "hmc"), (str(tmp_path / "s.h5"), "pt")):
        with pytest.raises(ValueError) as want:
            jck.load_tier_checkpoint(p, tier)
        with pytest.raises(ValueError) as got:
            tck.load_tier_checkpoint(p, tier)
        assert str(got.value) == str(want.value)
        assert "checkpoint, not a" in str(got.value)
    assert mf.chain_free.shape[1] == 4


def test_jax_tier_checkpoint_refused(tmp_path):
    import jax
    path = str(tmp_path / "j.h5")
    jck.save_tier_checkpoint(
        path, "hmc", {"key": jax.random.key(0, impl="threefry2x32"),
                      "u": np.zeros((2, 4, 3), np.float32)},
        [np.zeros((2, 3, 4, 3), np.float32)],
        [np.zeros((2, 3, 4), np.float32)], {}, "threefry2x32")
    with pytest.raises(ValueError, match="another sampler.*threefry"):
        tck.load_tier_checkpoint(path, "hmc")


# -- resume ------------------------------------------------------------------

class _Killed(Exception):
    pass


def _kill_after(monkeypatch, n):
    """Let the run flush n checkpoints, then stop it as a kill would."""
    orig, seen = tck.save_tier_checkpoint, []

    def flush(*a, **k):
        orig(*a, **k)
        seen.append(1)
        if len(seen) == n:
            raise _Killed()
    monkeypatch.setattr(tck, "save_tier_checkpoint", flush)


@pytest.mark.parametrize("tier", ["pt", "hmc"])
def test_resume_is_the_uninterrupted_run(tmp_path, monkeypatch, tier):
    """Killed after two flushes and resumed, the run's chain, lnprob,
    counters and (PT) evidence or (HMC) step sizes are the uninterrupted
    checkpointed run's bit for bit, and its chain the run's without a
    checkpoint."""
    if tier == "pt":
        def run(mf, **kw):
            return mf.run_pt(nrungs=4, nburn=20, nsteps=40, **kw)
    else:
        def run(mf, **kw):
            return mf.run_hmc(nwarmup=20, nsteps=40, n_leapfrog=4, **kw)
    plain = run(_fitter())
    whole = run(_fitter(), checkpoint=str(tmp_path / "w.h5"),
                checkpoint_interval=10)
    path = str(tmp_path / "k.h5")
    with monkeypatch.context() as m:
        _kill_after(m, 2)
        with pytest.raises(_Killed):
            run(_fitter(), checkpoint=path, checkpoint_interval=10)
    assert tck.load_tier_checkpoint(path, tier)[2].shape[1] == 20
    back = run(_fitter(), checkpoint=path, checkpoint_interval=10,
               resume=True)
    for a in ("chain_free", "lnprobability"):
        assert torch.equal(getattr(back, a), getattr(whole, a))
        assert torch.equal(getattr(plain, a), getattr(whole, a))
    np.testing.assert_array_equal(back.acceptance_fraction,
                                  whole.acceptance_fraction)
    if tier == "pt":
        for a in ("logz_pt", "logz_ti"):
            for x, y in zip(getattr(back, a), getattr(whole, a)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(back.swap_fraction,
                                      whole.swap_fraction)
        np.testing.assert_allclose(plain.logz_pt[0], whole.logz_pt[0],
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(back.hmc_step_size,
                                      whole.hmc_step_size)
        np.testing.assert_array_equal(back.hmc_mass, whole.hmc_mass)


def test_resume_refusals(tmp_path):
    path = str(tmp_path / "c.h5")
    _fitter().run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=8,
                     checkpoint=path, checkpoint_interval=4)
    with pytest.raises(ValueError, match="posterior_fp"):
        _fitter(flux_scale=1.1).run_pt(nrungs=4, beta_min=1e-2, nburn=5,
                                       nsteps=8, checkpoint=path,
                                       resume=True)
    with pytest.raises(ValueError, match="nrungs"):
        _fitter().run_pt(nrungs=5, beta_min=1e-2, nburn=5, nsteps=8,
                         checkpoint=path, resume=True)
    with pytest.raises(ValueError, match="already holds 8 records"):
        _fitter().run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=4,
                         checkpoint=path, resume=True)
    with pytest.raises(ValueError, match="'pt' checkpoint, not a 'hmc'"):
        _fitter().run_hmc(nwarmup=4, nsteps=8, checkpoint=path, resume=True)
    with pytest.raises(ValueError, match="seed"):
        _fitter(seed=6).run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=8,
                               checkpoint=path, resume=True)
    for run in (lambda mf: mf.run_pt(resume=True),
                lambda mf: mf.run_hmc(resume=True)):
        with pytest.raises(ValueError, match="requires checkpoint"):
            run(_fitter())
    done = _fitter().run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=12,
                            checkpoint=path, checkpoint_interval=4,
                            resume=True)
    assert done.chain_free.shape[1] == 12


# -- files across the packages -------------------------------------------------

@pytest.mark.parametrize("tier", ["pt", "hmc"])
def test_batch_files_cross_between_the_packages(tmp_path, tier):
    """The port's PTEvidence / HMC groups load in JAX's MultiFitter.from_h5,
    and the JAX package's writer's file of them loads in the port's."""
    mf = _fitter()
    if tier == "pt":
        mf.run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=8)
        names = ("logz_pt", "logz_ti", "pt_betas", "swap_fraction")
    else:
        mf.run_hmc(nwarmup=5, nsteps=8, n_leapfrog=4)
        names = ("hmc_step_size", "hmc_mass")
    p1, p2 = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    mf.writeToHDF5(p1)
    jm = J.MultiFitter.from_h5(p1)
    jm.writeToHDF5(p2)
    back = T.MultiFitter.from_h5(p2, device="cpu")
    for got in (jm, back):
        for n in names:
            for x, y in zip(np.atleast_1d(getattr(got, n)),
                            np.atleast_1d(getattr(mf, n))):
                np.testing.assert_array_equal(x, y)
    assert torch.equal(back.chain_free, mf.chain_free)
    other = ("hmc_step_size" if tier == "pt" else "logz_pt")
    assert getattr(back, other) is None
    view = back.results(1)
    if tier == "pt":
        assert view.logz_pt == (mf.logz_pt[0][1], mf.logz_pt[1][1])
        assert view.logz_ti == (mf.logz_ti[0][1], mf.logz_ti[1][1])


def test_single_fit_pt_evidence_crosses_both_ways(tmp_path):
    fit = T.MBBFitter(nwalkers=16, opthin=True, noalpha=True, seed=2,
                      device="cpu")
    flux, unc = _data(1)
    fit.set_data(WAVE, flux[0], unc[0])
    fit.run_pt(nrungs=4, beta_min=1e-2, nburn=10, nsteps=20)
    p1, p2 = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    T.MBBResults(fit=fit).writeToHDF5(p1)
    jr = J.MBBResults(h5file=p1)
    assert jr.logz_pt == fit.logz_pt and jr.logz_ti == fit.logz_ti
    jr.writeToHDF5(p2)
    back = T.MBBResults(h5file=p2, device="cpu")
    assert back.logz_pt == fit.logz_pt and back.logz_ti == fit.logz_ti
    fit.run(nburn=5, nsteps=8)
    T.MBBResults(fit=fit).writeToHDF5(p1)
    with h5py.File(p1, "r") as f:
        assert "PTEvidence" not in f


# -- the command lines ---------------------------------------------------------

def _photfile(tmp_path):
    path = tmp_path / "phot.txt"
    path.write_text("100.0  11.2  0.8\n160.0  32.1  1.9\n250.0  44.8  2.4\n"
                    "350.0  38.2  2.1\n500.0  22.9  1.5\n")
    return path


CATALOG = """\
wave = 100 160 250 350 500
SMM_J0001   2.20   11.2 0.8  32.1 1.9  44.8 2.4  38.2 2.1  22.9 1.5
SMM_J0002   1.85    9.4 0.7  28.8 1.7  40.1 2.2  35.5 2.0  21.3 1.4
SMM_J0003   2.60    nan nan  25.0 1.6  39.0 2.2  36.0 2.0  <30.0 1.5
"""
FAST = ["-w", "16", "-b", "10", "-n", "20"]


@pytest.mark.parametrize("flag", ["--pt", "--hmc"])
def test_cli_runs_pt_and_hmc(tmp_path, capsys, flag):
    out = tmp_path / "fit.h5"
    extra = (["--pt-rungs", "4", "--pt-beta-min", "0.01"] if flag == "--pt"
             else ["--hmc-leapfrog", "4", "--hmc-target-accept", "0.7"])
    rc = cli.main([str(_photfile(tmp_path)), str(out), *FAST, flag, *extra,
                   "-z", "2.2", "--get-lir", "--device", "cpu"])
    assert rc == 0 and out.is_file()
    res = J.MBBResults(h5file=str(out))
    assert res.chain.shape == (16, 20, 5)
    assert (res.logz_pt is not None) == (flag == "--pt")
    assert res.lir_chain is not None
    assert "fnorm" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--pt", "--hmc"])
def test_batch_cli_runs_pt_and_hmc(tmp_path, capsys, flag):
    cat = tmp_path / "cat.txt"
    cat.write_text(CATALOG)
    out = tmp_path / "b.h5"
    extra = (["--pt-rungs", "4", "--pt-beta-min", "0.01"] if flag == "--pt"
             else ["--hmc-leapfrog", "4"])
    rc = cli_batch.main([str(cat), str(out), *FAST, flag, *extra,
                         "--summary", "--checkpoint", str(tmp_path / "c.h5"),
                         "--checkpoint-interval", "5", "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert ("lnZ(PT)" in printed) == (flag == "--pt")
    jm = J.MultiFitter.from_h5(str(out))
    assert np.asarray(jm.chain_free).shape[:3] == (3, 20, 16)
    if flag == "--pt":
        assert np.all(np.isfinite(jm.logz_pt[0]))
    else:
        assert np.all(np.asarray(jm.hmc_step_size) > 0)
    tier = flag[2:]
    assert tck.load_tier_checkpoint(str(tmp_path / "c.h5"),
                                    tier)[2].shape[1] == 20


SINGLE_CONFLICTS = [
    ["--hmc", "--pt"], ["--pt", "--map"], ["--hmc", "--map"],
    ["--hmc", "--extend-until", "1.05"], ["--pt", "--init-map"],
    ["--hmc", "--n-ensembles", "2"], ["--pt", "--n-ensembles", "2"],
    ["--pt", "--checkpoint", "c.h5"], ["--hmc", "--checkpoint", "c.h5"],
    ["--hmc", "--resume", "--checkpoint", "c.h5"],
    ["--get-evidence", "--map"]]


@pytest.mark.parametrize("flags", SINGLE_CONFLICTS)
def test_cli_conflicts_match_jax(tmp_path, flags):
    args = [str(_photfile(tmp_path)), str(tmp_path / "o.h5"), *FAST, *flags]
    with pytest.raises(SystemExit) as want:
        jcli.main(args)
    with pytest.raises(SystemExit) as got:
        cli.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "o.h5").exists()


BATCH_CONFLICTS = [
    ["--hmc", "--pt"], ["--pt", "--map"], ["--hmc", "--map"],
    ["--pt", "--extend-until", "1.05"], ["--hmc", "--init-map"],
    ["--pt", "--init-map"]]


@pytest.mark.parametrize("flags", BATCH_CONFLICTS)
def test_batch_cli_conflicts_match_jax(tmp_path, flags):
    cat = tmp_path / "cat.txt"
    cat.write_text(CATALOG)
    args = [str(cat), str(tmp_path / "o.h5"), *FAST, *flags]
    with pytest.raises(SystemExit) as want:
        jcli_batch.main(args)
    with pytest.raises(SystemExit) as got:
        cli_batch.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_waiting_refusals_name_their_lettered_item(tmp_path):
    """What still waits names its lettered ROADMAP.md item (--mesh-devices
    A11); --profile-dir (A8, ported) runs in both CLIs and leaves a trace;
    nothing in the package names A8, A9, A9e, A9f or A10c any more (the
    migration surface, nested sampling, the population tier and the plots
    are ported)."""
    cat = tmp_path / "cat.txt"
    cat.write_text(CATALOG)
    small = ["-w", "16", "-b", "4", "-n", "8", "--device", "cpu"]
    p1, p2 = tmp_path / "p1", tmp_path / "p2"
    assert cli.main([str(_photfile(tmp_path)), str(tmp_path / "o1.h5"),
                     "--profile-dir", str(p1), *small]) == 0
    assert cli_batch.main([str(cat), str(tmp_path / "o2.h5"),
                           "--profile-dir", str(p2), *small]) == 0
    for prof in (p1, p2):
        assert len(list(prof.glob("*.pt.trace.json"))) == 1
    for flags, item in ((["--mesh-devices", "4"], "A11"),):
        with pytest.raises(SystemExit, match=rf"item {item}\)"):
            cli_batch.main([str(cat), "o.h5", *flags, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=r"item A11\)"):
        T.MBBFitter(device="cpu", mesh=object())
    pat = re.compile(r'"A(8|9[ef]?|10c)"')
    pkg = REPO / "mbb_emcee_tpu_torch"
    offending = [f"{p.name}:{i}" for p in sorted(pkg.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pat.search(line)]
    assert offending == []
