"""Checkpoint / resume / extend of the port's stretch-move runs on the CPU:
the stretch-move cases of tests/test_checkpoint.py on the port's fitters
(a checkpointed run equals the plain one, an interrupted run resumes to the
same chain, every refusal), the fingerprints against the JAX package's,
files crossing between the packages (the port refuses a JAX checkpoint,
the JAX reader reads the port's segments), and run + extend equal to the
longer run, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import checkpoint as jcheckpoint  # noqa: E402
from mbb_emcee_tpu.likelihood import LikelihoodSpec as JSpec  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import checkpoint  # noqa: E402
from mbb_emcee_tpu_torch.convert import spec_from_reference  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])


def _data(scale=1.0, seed=0):
    f = mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                torch.tensor(WAVE, dtype=torch.float32),
                MBBShape(opthin=True, noalpha=True)).double().numpy() * scale
    unc = 0.05 * f
    return f + unc * np.random.default_rng(seed).standard_normal(f.size), unc


def _fit(seed=21, backend="auto", responses=None, names=None):
    fit = T.MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=seed,
                      device="cpu", sampler_backend=backend,
                      responses=responses)
    fit.set_data(WAVE, *_data(), band_names=names)
    fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    return fit


def test_checkpointed_run_matches_plain(tmp_path):
    plain = _fit().run(nburn=20, nsteps=120)
    ck = str(tmp_path / "run.ckpt.h5")
    chk = _fit().run(nburn=20, nsteps=120, checkpoint=ck,
                     checkpoint_interval=40)
    np.testing.assert_array_equal(plain.chain, chk.chain)
    assert torch.equal(plain.lnprobability, chk.lnprobability)
    np.testing.assert_array_equal(plain.acceptance_fraction,
                                  chk.acceptance_fraction)
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")


@pytest.mark.parametrize("thin,interval", [(1, 40), (3, 10)])
def test_resume_after_interruption(tmp_path, thin, interval):
    """A run 'killed' after its first flush resumes (skipping burn-in) to
    the uninterrupted chain and final state, bit for bit."""
    full = _fit().run(nburn=20, nsteps=120, thin=thin)
    ck = str(tmp_path / "i.ckpt.h5")
    _fit().run(nburn=20, nsteps=interval * thin, thin=thin, checkpoint=ck,
               checkpoint_interval=interval)
    resumed = _fit().run(nburn=999, nsteps=120, thin=thin, checkpoint=ck,
                         checkpoint_interval=interval, resume=True)
    assert resumed.chain.shape[1] == 120 // thin
    np.testing.assert_array_equal(resumed.chain, full.chain)
    assert torch.equal(resumed.final_state.position,
                       full.final_state.position)
    assert resumed.final_state.step == full.final_state.step
    assert resumed.burn_chain_free is None


def test_resume_without_a_file_starts_fresh(tmp_path):
    ck = str(tmp_path / "none.ckpt.h5")
    fit = _fit().run(nburn=10, nsteps=40, checkpoint=ck, resume=True,
                     checkpoint_interval=20)
    np.testing.assert_array_equal(fit.chain,
                                  _fit().run(nburn=10, nsteps=40).chain)


def test_checkpoint_file_layout(tmp_path):
    """Version 2 layout: the run meta, the port's generator name, the
    Philox key and stream position, and one segment per flush."""
    import h5py
    ck = str(tmp_path / "l.ckpt.h5")
    fit = _fit().run(nburn=10, nsteps=60, checkpoint=ck,
                     checkpoint_interval=20)
    with h5py.File(ck, "r") as f:
        assert f.attrs["version"] == 2
        assert f.attrs["prng_impl"] == checkpoint.PRNG_IMPL
        assert f.attrs["nsteps_target"] == 60 and f.attrs["nwalkers"] == 32
        assert f.attrs["sampler_backend"] == "torch"
        assert sorted(f["Segments"]) == ["seg00000", "seg00001", "seg00002"]
        st = f["State"]
        assert int(np.asarray(st["seed"])) == fit.final_state.seed
        assert int(np.asarray(st["step"])) == fit.final_state.step
    state, chain, lnp, meta = checkpoint.load_checkpoint(ck)
    np.testing.assert_array_equal(chain, fit.chain_free.numpy())
    assert meta["run_id"] and state.nsteps == 60


def test_geometry_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "g.ckpt.h5")
    _fit().run(nburn=5, nsteps=20, checkpoint=ck, checkpoint_interval=10)
    bad = _fit()
    bad.nwalkers = 64
    with pytest.raises(ValueError, match="geometry"):
        bad.run(nburn=5, nsteps=40, checkpoint=ck, resume=True)
    with pytest.raises(ValueError, match="geometry"):
        _fit().run(nburn=5, nsteps=40, thin=2, checkpoint=ck, resume=True)


def test_resume_refuses_backend_mismatch(tmp_path):
    """Both backends draw one stream, but a resume under the other one is
    refused, as the JAX package refuses it."""
    ck = str(tmp_path / "b.ckpt.h5")
    _fit(backend="torch").run(nburn=10, nsteps=40, checkpoint=ck,
                              checkpoint_interval=20)
    with pytest.raises(ValueError, match="sampler_backend"):
        _fit(backend="fused").run(nburn=10, nsteps=80, checkpoint=ck,
                                  resume=True)


def test_resume_refuses_data_change(tmp_path):
    ck = str(tmp_path / "d.ckpt.h5")
    _fit().run(nburn=10, nsteps=40, checkpoint=ck, checkpoint_interval=20)
    other = _fit()
    phot = other._require_data()
    other.set_data(WAVE, phot.flux * 1.01, phot.unc)
    with pytest.raises(ValueError, match="data_fingerprint"):
        other.run(nburn=10, nsteps=80, checkpoint=ck, resume=True)


def test_resume_refuses_changed_spec(tmp_path):
    ck = str(tmp_path / "spec.ckpt.h5")
    _fit().run(nburn=10, nsteps=40, checkpoint=ck, checkpoint_interval=20)
    changed = _fit()
    changed.set_gaussian_prior("beta", 1.9, 0.2)
    with pytest.raises(ValueError, match="spec_fingerprint"):
        changed.run(nburn=10, nsteps=80, checkpoint=ck, resume=True)


def test_resume_refuses_response_swap(tmp_path):
    """The data fingerprint covers the response pack: a filter-curve swap
    refuses the resume; the unchanged curves resume."""
    names = [f"B{int(w)}" for w in WAVE]

    def fit_with(width):
        rs = T.ResponseSet()
        for n, w in zip(names, WAVE):
            rs.add(n, f"box:{w}:{width}")
        return _fit(responses=rs, names=names)

    ck = str(tmp_path / "r.ckpt.h5")
    fit_with(30.0).run(nburn=10, nsteps=40, checkpoint=ck,
                       checkpoint_interval=20)
    with pytest.raises(ValueError, match="data_fingerprint"):
        fit_with(60.0).run(nburn=10, nsteps=80, checkpoint=ck, resume=True)
    whole = fit_with(30.0).run(nburn=10, nsteps=80)
    resumed = fit_with(30.0).run(nburn=10, nsteps=80, checkpoint=ck,
                                 checkpoint_interval=20, resume=True)
    np.testing.assert_array_equal(resumed.chain, whole.chain)


def test_thin_mismatch_rejected_before_sampling(tmp_path):
    ck = str(tmp_path / "t.ckpt.h5")
    with pytest.raises(ValueError, match="divisible"):
        _fit().run(nburn=5, nsteps=7, thin=3, checkpoint=ck)
    assert not os.path.exists(ck)


def test_fresh_run_overwrites_stale_checkpoint(tmp_path):
    ck = str(tmp_path / "stale.ckpt.h5")
    _fit(seed=1).run(nburn=10, nsteps=80, checkpoint=ck,
                     checkpoint_interval=20)
    fresh = _fit(seed=2).run(nburn=10, nsteps=40, checkpoint=ck,
                             checkpoint_interval=20)
    assert fresh.chain.shape[1] == 40
    np.testing.assert_array_equal(fresh.chain,
                                  _fit(seed=2).run(nburn=10, nsteps=40).chain)
    _, chain, _, _ = checkpoint.load_checkpoint(ck)
    assert chain.shape[0] == 40


def test_run_argument_validation(tmp_path):
    fit = _fit()
    with pytest.raises(ValueError, match="thin=0"):
        fit.run(nburn=2, nsteps=10, thin=0)
    with pytest.raises(ValueError, match="requires checkpoint"):
        fit.run(nburn=2, nsteps=10, resume=True)
    ck = str(tmp_path / "p0.ckpt.h5")
    fit2 = _fit().run(nburn=5, nsteps=20, checkpoint=ck,
                      checkpoint_interval=10)
    p0 = fit2.chain_free[-1].numpy()
    with pytest.raises(ValueError, match="p0"):
        _fit().run(nburn=5, nsteps=40, p0=p0, checkpoint=ck, resume=True)


@pytest.mark.parametrize("thin", [1, 2])
def test_extend_is_the_longer_run(thin):
    """run(n1) + extend(n2) is run(n1 + n2) bit for bit: every launch
    continues the Philox stream (a deliberate difference from the JAX
    package, whose extend draws a fresh stream)."""
    whole = _fit().run(nburn=10, nsteps=60, thin=thin)
    part = _fit().run(nburn=10, nsteps=20, thin=thin).extend(40)
    np.testing.assert_array_equal(part.chain, whole.chain)
    assert torch.equal(part.lnprobability, whole.lnprobability)
    np.testing.assert_array_equal(part.acceptance_fraction,
                                  whole.acceptance_fraction)
    with pytest.raises(ValueError, match="divisible"):
        _fit().run(nburn=2, nsteps=4, thin=2).extend(3)
    with pytest.raises(RuntimeError, match="run"):
        _fit().extend(10)


def test_resumed_run_extends(tmp_path):
    ck = str(tmp_path / "x.ckpt.h5")
    _fit().run(nburn=10, nsteps=20, checkpoint=ck, checkpoint_interval=20)
    res = _fit().run(nburn=10, nsteps=40, checkpoint=ck, resume=True,
                     checkpoint_interval=20).extend(20)
    np.testing.assert_array_equal(res.chain,
                                  _fit().run(nburn=10, nsteps=60).chain)


# -- fingerprints and files crossing between the packages -------------------

@pytest.mark.parametrize("arrays", [
    (WAVE, np.ones(5), 0.1 * np.ones(5), None),
    (WAVE.astype(np.float32), np.arange(5), np.eye(5), ["a", "b"]),
    (np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32))])
def test_data_fingerprint_equals_jax(arrays):
    assert checkpoint.data_fingerprint(*arrays) == \
        jcheckpoint.data_fingerprint(*arrays)


@pytest.mark.parametrize("edit", ["none", "prior", "fixed", "uplim"])
def test_spec_fingerprint_equals_jax(edit):
    jspec = JSpec.default()
    if edit == "prior":
        jspec.prior_mean[2], jspec.prior_isigma[2] = 250.0, 1.0 / 120.0
    elif edit == "fixed":
        jspec.fixed[3], jspec.fixed_values[3] = True, 3.5
    elif edit == "uplim":
        jspec = dataclasses.replace(
            jspec, uplim_bands=np.array([0, 0, 1, 0, 1], bool))
    spec = spec_from_reference(jspec)
    for kw in (dict(), dict(opthin=True, noalpha=True, wavenorm=850.0)):
        assert checkpoint.spec_fingerprint(spec, MBBShape(**kw), 2.0) == \
            jcheckpoint.spec_fingerprint(jspec, JShape(**kw), 2.0)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port refuses a JAX checkpoint (its state is a JAX key, not a
    Philox stream) with an error naming the generator; the JAX package's
    segment reader reads the port's file back to the port's chain, and its
    loader refuses the port's state."""
    flux, unc = _data()
    jfit = J.MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=21)
    jfit.set_data(WAVE, flux, unc)
    jck = str(tmp_path / "jax.ckpt.h5")
    jfit.run(nburn=5, nsteps=20, checkpoint=jck, checkpoint_interval=10)
    with pytest.raises(ValueError, match="another sampler"):
        checkpoint.load_checkpoint(jck)
    with pytest.raises(ValueError, match="another sampler"):
        _fit().run(nburn=5, nsteps=40, checkpoint=jck, resume=True)

    import h5py
    tck = str(tmp_path / "port.ckpt.h5")
    tfit = _fit().run(nburn=5, nsteps=30, checkpoint=tck,
                      checkpoint_interval=10)
    with h5py.File(tck, "r") as f:
        chain, lnp = jcheckpoint._read_segments(f, axis=0)
    np.testing.assert_array_equal(chain, tfit.chain_free.numpy())
    np.testing.assert_array_equal(lnp, tfit.lnprobability.numpy())
    with pytest.raises(Exception):
        jcheckpoint.load_checkpoint(tck)


# -- the batch tier ----------------------------------------------------------

def _multi(seed=5, backend="auto", nsrc=6):
    rng = np.random.default_rng(3)
    flux, unc = _data()
    scale = rng.uniform(0.7, 1.3, (nsrc, 1))
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=seed,
                       device="cpu", sampler_backend=backend)
    mf.set_data(WAVE, flux[None] * scale, unc[None] * scale)
    mf.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    return mf


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_multifit_checkpoint_resume_bitwise(tmp_path, backend):
    """A batch run killed after its first flush resumes to the
    straight-through chain and state, on either backend."""
    full = _multi(backend=backend).run(nburn=4, nsteps=6, thin=1)
    ck = str(tmp_path / "m.ckpt.h5")
    _multi(backend=backend).run(nburn=4, nsteps=2, checkpoint=ck,
                                checkpoint_interval=2)
    resumed = _multi(backend=backend).run(nburn=999, nsteps=6,
                                          checkpoint=ck,
                                          checkpoint_interval=2, resume=True)
    assert resumed.chain_free.shape == (6, 6, 16, 3)
    assert torch.equal(resumed.chain_free, full.chain_free)
    assert torch.equal(resumed.lnprobability, full.lnprobability)
    assert torch.equal(resumed.final_state.pos, full.final_state.pos)
    np.testing.assert_array_equal(resumed.acceptance_fraction,
                                  full.acceptance_fraction)
    resumed.extend(4)
    assert torch.equal(resumed.chain_free,
                       _multi(backend=backend).run(nburn=4,
                                                   nsteps=10).chain_free)


@pytest.mark.parametrize("change,match", [
    ("nwalkers", "geometry"), ("nsources", "geometry"),
    ("data", "data_fingerprint"), ("spec", "spec_fingerprint"),
    ("backend", "sampler_backend"), ("correlation", "data_fingerprint")])
def test_multifit_resume_refusals(tmp_path, change, match):
    ck = str(tmp_path / "e.ckpt.h5")
    _multi().run(nburn=2, nsteps=2, checkpoint=ck, checkpoint_interval=2)
    other = _multi(nsrc=7 if change == "nsources" else 6,
                   backend="fused" if change == "backend" else "auto")
    if change == "nwalkers":
        other.nwalkers = 32
    elif change == "data":
        other.set_data(WAVE, other.flux * 1.01, other.unc)
    elif change == "spec":
        other.set_gaussian_prior("beta", 1.9, 0.2)
    elif change == "correlation":
        other.set_band_correlation(np.eye(5))
    with pytest.raises(ValueError, match=match):
        other.run(nburn=2, nsteps=4, checkpoint=ck, resume=True)


def test_single_and_multi_loaders_refuse_each_other(tmp_path):
    mck = str(tmp_path / "m.ckpt.h5")
    _multi().run(nburn=2, nsteps=2, checkpoint=mck, checkpoint_interval=2)
    with pytest.raises(ValueError, match="MultiFitter"):
        checkpoint.load_checkpoint(mck)
    sck = str(tmp_path / "s.ckpt.h5")
    _fit().run(nburn=2, nsteps=10, checkpoint=sck, checkpoint_interval=10)
    with pytest.raises(ValueError, match="single-fit"):
        checkpoint.load_multi_checkpoint(sck)


def test_n_ensembles_checkpoint_resumes(tmp_path):
    """MBBFitter(n_ensembles > 1) checkpoints through MultiFitter; the
    resumed merged chain is the uninterrupted one."""
    def fit():
        f = T.MBBFitter(nwalkers=16, opthin=True, noalpha=True, seed=8,
                        device="cpu", n_ensembles=2)
        f.set_data(WAVE, *_data())
        return f
    whole = fit().run(nburn=4, nsteps=8)
    ck = str(tmp_path / "k.ckpt.h5")
    fit().run(nburn=4, nsteps=4, checkpoint=ck, checkpoint_interval=4)
    resumed = fit().run(nburn=4, nsteps=8, checkpoint=ck,
                        checkpoint_interval=4, resume=True)
    assert resumed.chain_free.shape == (8, 32, 3)
    assert torch.equal(resumed.chain_free, whole.chain_free)
