"""The port's batch tier against the JAX package's on shared numpy inputs:
the batch likelihood, the signed/whitened error operands, the plain multi
run replaying the JAX stretch move source by source, the per-source Philox
streams, MultiFitter's run/extend protocol and refusals, its batched
summaries and derived posteriors on one injected chain, HDF5 files crossing
between the packages, and MBBFitter(n_ensembles > 1)."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu.likelihood import (  # noqa: E402
    LikelihoodSpec as JSpec, build_lnprob_data as j_build_lnprob_data,
    signed_iunc as j_signed_iunc)
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch.convert import spec_from_reference  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    FreeSpace, LNPROB_FLOOR, build_lnprob_data, signed_iunc)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops.multifit_kernel import (  # noqa: E402
    FusedMultiSampler, mbb_multi_stretch_run)
from mbb_emcee_tpu_torch.ops.philox import stretch_uniforms  # noqa: E402
from mbb_emcee_tpu_torch.response import ResponseSet  # noqa: E402
from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler  # noqa: E402
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    make_initial_ball, multi_stretch_run_plain, stretch_run_plain)

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
BANDS = ["PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350", "SPIRE_500"]
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
F0 = np.array([8.62, 23.3, 41.2, 44.6, 45.0])     # ~ the TRUE greybody
S, NW = 4, 32
# Port vs JAX: fp32 on both sides, same formulas, different op order and
# transcendental implementations (XLA:CPU vs torch's).
RTOL, ATOL = 1e-5, 1e-4
CORR = np.where(np.arange(5)[:, None] // 2 == np.arange(5)[None, :] // 2,
                0.4, 0.1)
np.fill_diagonal(CORR, 1.0)


def _data(nsrc=S, seed=0, missing=True):
    """(flux, unc) (nsrc, 5) around the TRUE greybody, band 0 missing (NaN)
    in source 1."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.6, 1.4, (nsrc, 1))
    unc = 0.05 * F0[None, :] * scale * rng.uniform(0.8, 1.2, (nsrc, 5))
    flux = F0[None, :] * scale + unc * rng.standard_normal((nsrc, 5))
    if missing and nsrc > 1:
        flux[1, 0] = np.nan
        unc[1, 0] = np.nan
    return flux, unc


def _jspec(opthin=False, noalpha=False, uplim=None):
    spec = JSpec.default()
    spec.upper[0] = 100.0
    spec.upper[1] = 5.0
    spec.prior_mean[2] = 250.0
    spec.prior_isigma[2] = 1.0 / 120.0
    if opthin:
        spec.fixed[2], spec.fixed_values[2] = True, 250.0
    if noalpha:
        spec.fixed[3], spec.fixed_values[3] = True, 3.5
    if uplim is not None:
        spec = dataclasses.replace(spec, uplim_bands=uplim)
    return spec


def _whiten(unc):
    """Both packages' batch whitening operand for CORR on `unc`."""
    mf = J.MultiFitter(nwalkers=NW)
    mf.set_data(WAVE, np.ones_like(unc), unc)
    mf.set_band_correlation(CORR)
    return mf._whiten_operand()


def _numpy_pack(nnodes=65):
    u = np.linspace(-0.25, 0.25, nnodes)
    nodes = WAVE[:, None] * np.exp(u)[None, :]
    w = np.full(nnodes, u[1] - u[0])
    w[[0, -1]] *= 0.5
    return nodes, np.broadcast_to(w / w.sum(), nodes.shape).copy()


def _per_source_uplim(nsrc=S):
    ul = np.zeros((nsrc, 5), bool)
    ul[0, 4] = True
    ul[2, 3] = True
    ul[1, 0] = True      # a limit on a MISSING band: weight 0 either way
    return ul


LNP_CASES = {
    "diag": dict(),
    "uplim-shared": dict(uplim="shared"),
    "uplim-per-source": dict(uplim="per_source"),
    "correlated": dict(correlated=True),
    "pack-5x65": dict(pack=True, uplim="per_source"),
    "builtin-5x65": dict(pack=65),
    "builtin-5x129": dict(pack=129, uplim="per_source"),
    "thin3": dict(opthin=True, noalpha=True),
    "alpha-fixed-at-0": dict(alpha0=True),
}


@pytest.mark.parametrize("case", list(LNP_CASES))
def test_build_lnprob_data_matches_jax(case):
    """(S, n, nfree) -> (S, n) against the JAX batch lnprob vmapped over
    walkers and sources, on 4 sources with a NaN missing band."""
    kw = LNP_CASES[case]
    flux, unc = _data()
    uplim = {"shared": np.array([True, False, False, False, True]),
             "per_source": _per_source_uplim(),
             None: None}[kw.get("uplim")]
    jspec = _jspec(kw.get("opthin", False), kw.get("noalpha", False), uplim)
    if kw.get("alpha0"):
        jspec.fixed[3], jspec.fixed_values[3] = True, 0.0
    shape_kw = dict(opthin=kw.get("opthin", False),
                    noalpha=kw.get("noalpha", False))
    pack = kw.get("pack")
    if pack is True:
        pack = _numpy_pack()
    elif pack:
        pack = ResponseSet.builtin(BANDS, nnodes=pack).pack(BANDS)
    correlated = kw.get("correlated", False)
    errs = _whiten(unc) if correlated else j_signed_iunc(unc, uplim)
    flux0 = np.where(np.isfinite(unc), flux, 0.0)
    j_fn, jfs = j_build_lnprob_data(JShape(**shape_kw), jspec,
                                    response_pack=pack,
                                    correlated=correlated)
    t_fn, tfs = build_lnprob_data(MBBShape(**shape_kw),
                                  spec_from_reference(jspec),
                                  response_pack=pack, correlated=correlated)
    np.testing.assert_array_equal(jfs.free_idx, tfs.free_idx)
    rng = np.random.default_rng(3)
    th = TRUE[None, None, :] * rng.uniform(0.6, 1.6, (S, 48, 5))
    th[:, :4, 0] = 150.0                    # T above its upper limit
    th = th[..., tfs.free_idx].astype(np.float32)
    f32 = [np.asarray(a, np.float32) for a in (WAVE, flux0, errs)]
    want = np.asarray(jax.jit(jax.vmap(
        jax.vmap(j_fn, in_axes=(0, None, None, None)),
        in_axes=(0, None, 0, 0)))(jnp.asarray(th), *map(jnp.asarray, f32)))
    got = t_fn(torch.as_tensor(th), *map(torch.as_tensor, f32)).numpy()
    assert got.shape == (S, 48)
    floor = np.float32(LNPROB_FLOOR)
    np.testing.assert_array_equal(got == floor, want == floor)
    assert np.all(got[:, :4] == floor)
    m = want != floor
    rtol, atol = (2e-3, 2e-3) if kw.get("alpha0") else (RTOL, ATOL)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


def test_correlated_errors_refuse_upper_limits():
    spec = spec_from_reference(_jspec(uplim=np.ones(5, bool)))
    with pytest.raises(ValueError, match="correlated"):
        build_lnprob_data(MBBShape(), spec, correlated=True)
    flux, unc = _data()
    with pytest.raises(ValueError, match="correlated"):
        FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(), spec,
                          whiten=_whiten(unc), device="cpu")


def test_signed_iunc_and_whitening_equal_jax():
    """On a ragged pattern (two missing-band patterns, a per-source limit on
    a missing band): the signed 1/sigma and the whitening matrices agree
    with the JAX package's to 1e-12."""
    flux, unc = _data(nsrc=6)
    unc[4, 2] = np.inf
    flux[4, 2] = np.nan
    ul = _per_source_uplim(6)
    np.testing.assert_allclose(signed_iunc(unc, ul), j_signed_iunc(unc, ul),
                               rtol=1e-12, atol=0)
    got_neg = np.signbit(signed_iunc(unc, ul))
    assert got_neg[1, 0] and signed_iunc(unc, ul)[1, 0] == 0.0
    with pytest.raises(ValueError, match="positive"):
        signed_iunc(np.where(unc > 1, 0.0, unc))
    jmf = J.MultiFitter(nwalkers=NW)
    tmf = T.MultiFitter(nwalkers=NW, device="cpu")
    for mf in (jmf, tmf):
        mf.set_data(WAVE, flux, unc)
        mf.set_band_correlation(CORR)
    got, want = tmf._whiten_operand(), jmf._whiten_operand()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    # source 1's missing band 0: zero row and column
    assert np.all(got[1, 0] == 0) and np.all(got[1, :, 0] == 0)
    for mf in (jmf, tmf):
        mf.set_band_correlation(None)
        mf.set_phot_upperlimits(ul)
    np.testing.assert_allclose(tmf._iunc_operand(), jmf._iunc_operand(),
                               rtol=1e-12, atol=0)


def _jax_replay_source(u_s, p0_s, lnprob_batch, half):
    """Source s with the JAX stretch move on its uniform rows
    (nrec, 6 * thin, half), as tests/test_pallas_multifit.py replays."""
    pos_a, pos_b = jnp.asarray(p0_s[:half]), jnp.asarray(p0_s[half:])
    lnp = lnprob_batch(jnp.asarray(p0_s))
    lnp_a, lnp_b = lnp[:half], lnp[half:]
    chain, lnpchain, nacc = [], [], np.zeros(2 * half, np.int64)
    for r in range(u_s.shape[0]):
        for t in range(u_s.shape[1] // 6):
            u = u_s[r, 6 * t:6 * t + 6]
            pos_a, lnp_a, acc_a = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(u[0:3]), pos_a, pos_b, lnp_a, lnprob_batch)
            pos_b, lnp_b, acc_b = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(u[3:6]), pos_b, pos_a, lnp_b, lnprob_batch)
            nacc += np.concatenate([np.asarray(acc_a), np.asarray(acc_b)])
        chain.append(np.concatenate([np.asarray(pos_a), np.asarray(pos_b)]))
        lnpchain.append(np.concatenate([np.asarray(lnp_a),
                                        np.asarray(lnp_b)]))
    return np.stack(chain), np.stack(lnpchain), nacc


def _balls(free_space, nsrc, seed=50):
    c = TRUE[free_space.free_idx]
    return torch.stack([
        make_initial_ball(torch.Generator().manual_seed(seed + s), c,
                          0.05 * c, NW, free_space.lower, free_space.upper)
        for s in range(nsrc)])


@pytest.mark.parametrize("case", ["thin3", "thick4-uplim-per-source",
                                  "full5-correlated"])
def test_plain_multi_run_replays_jax_per_source(case):
    """3 sources x 32 walkers, 2 records x thin 2 on shared uniforms: the
    plain multi run (the plain version of K3) gives each source the chain,
    lnp and accept counts of the JAX stretch move on JAX's batch lnprob
    (tests/test_pallas_multifit.py's tolerances)."""
    nsrc = 3
    flux, unc = _data(nsrc)
    opthin = noalpha = case == "thin3"
    noalpha = noalpha or case.startswith("thick4")
    uplim = _per_source_uplim(nsrc) if "uplim" in case else None
    correlated = "correlated" in case
    jspec = _jspec(opthin, noalpha, uplim)
    shape_kw = dict(opthin=opthin, noalpha=noalpha)
    whiten = _whiten(unc) if correlated else None
    samp = FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(**shape_kw),
                             spec_from_reference(jspec), rng="external",
                             whiten=whiten, device="cpu")
    p0 = _balls(samp.free_space, nsrc)
    nrec, thin = 2, 2
    u = np.random.default_rng(4).uniform(
        0.001, 0.999, (nsrc, nrec, 6 * thin, NW // 2)).astype(np.float32)
    state = samp.init_state(p0, seed=1)
    state, chain, lnp = samp.run_mcmc(state, nrec * thin, thin,
                                      uniforms=torch.as_tensor(u))
    assert chain.shape == (nsrc, nrec, NW, samp.ndim)
    j_fn, _ = j_build_lnprob_data(JShape(**shape_kw), jspec,
                                  correlated=correlated)
    errs = whiten if correlated else j_signed_iunc(unc, uplim)
    flux0 = np.where(np.isfinite(unc), flux, 0.0)
    for s in range(nsrc):
        args = [jnp.asarray(a, jnp.float32) for a in (WAVE, flux0[s],
                                                       errs[s])]
        batch = jax.jit(jax.vmap(lambda th: j_fn(th, *args)))
        ref_chain, ref_lnp, ref_acc = _jax_replay_source(
            u[s], p0[s].numpy(), batch, NW // 2)
        np.testing.assert_allclose(chain[s].numpy(), ref_chain, rtol=2e-5,
                                   atol=1e-4, err_msg=f"src {s}")
        np.testing.assert_allclose(lnp[s].numpy(), ref_lnp, rtol=2e-5,
                                   atol=1e-3, err_msg=f"src {s}")
        np.testing.assert_array_equal(state.naccept[s].numpy(), ref_acc)
    np.testing.assert_array_equal(state.pos.numpy(), chain[:, -1].numpy())
    assert state.nsteps == nrec * thin and state.step == nrec * thin


def test_per_source_philox_streams():
    """Source 0 draws the single-ensemble stream (so the plain multi run of
    one source IS the single run), other sources draw other streams."""
    u1 = stretch_uniforms(0xABCDEF12345, 2 ** 32 - 1, 3, 16, "cpu")
    u3 = stretch_uniforms(0xABCDEF12345, 2 ** 32 - 1, 3, 16, "cpu",
                          source=[0, 1, 2])
    assert u3.shape == (3, 18, 16)
    assert torch.equal(u3[0], u1)
    assert not torch.equal(u3[1], u1) and not torch.equal(u3[2], u3[1])
    assert torch.equal(stretch_uniforms(7, 0, 2, 16, "cpu", source=2),
                       stretch_uniforms(7, 0, 2, 16, "cpu",
                                        source=[1, 2])[1])
    flux, unc = _data(1, missing=False)
    spec = spec_from_reference(_jspec())
    multi = FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(), spec,
                              device="cpu")
    single = FusedSampler(NW, T.Photometry(WAVE, flux[0], unc[0]),
                          MBBShape(), spec, device="cpu")
    p0 = _balls(multi.free_space, 1)
    a = single.run_mcmc(single.init_state(p0[0], seed=99, step=5), 6, 2)
    b = multi.run_mcmc(multi.init_state(p0, seed=99, step=5), 6, 2)
    assert torch.equal(a[1], b[1][0]) and torch.equal(a[2], b[2][0])
    assert torch.equal(a[0].naccept, b[0].naccept[0])
    assert b[0].step == 11


def test_cpu_dispatch_and_sampler_refusals():
    """CPU states run the plain multi run (K3's counter stays); the
    sampler refuses what pallas_multifit.py refuses."""
    flux, unc = _data()
    spec = spec_from_reference(_jspec())
    samp = FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(), spec,
                             device="cpu")
    state = samp.init_state(_balls(samp.free_space, S), seed=3)
    k3, plain = mbb_multi_stretch_run.launches, multi_stretch_run_plain.runs
    single = stretch_run_plain.runs
    st, chain, lnp = samp.run_mcmc(state, 4, thin=2)
    assert chain.shape == (S, 2, NW, 5) and bool(torch.isfinite(lnp).all())
    assert mbb_multi_stretch_run.launches == k3
    assert multi_stretch_run_plain.runs == plain + 1
    assert stretch_run_plain.runs == single
    af = samp.acceptance_fraction(st)
    assert af.shape == (S, NW) and np.all((af >= 0) & (af <= 1))
    assert samp.reset_counters(st).nsteps == 0
    with pytest.raises(ValueError, match="silently ignore"):
        samp.run_mcmc(state, 2, uniforms=torch.zeros(1))
    ext = FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(), spec,
                            rng="external", device="cpu")
    with pytest.raises(ValueError, match="uniforms"):
        ext.run_mcmc(state, 2)
    with pytest.raises(ValueError):
        samp.init_state(torch.zeros((S, NW, 3)), seed=0)
    for bad in (dict(nwalkers=31), dict(rng="bad"), dict(nwalkers=4096),
                dict(flux=flux[:, :3])):
        kw = dict(nwalkers=NW, wave=WAVE, flux=flux, unc=unc,
                  shape=MBBShape(), spec=spec, device="cpu")
        kw.update(bad)
        with pytest.raises(ValueError):
            FusedMultiSampler(**kw)
    with pytest.raises(ValueError, match="rebuild"):
        samp.set_data(flux, unc, whiten=_whiten(unc))
    with pytest.raises(ValueError):
        samp.set_data(flux[:2], unc[:2])
    bad = flux.copy()
    bad[2, 3] = np.nan               # NaN flux at a WEIGHTED band
    with pytest.raises(ValueError, match="weighted band"):
        samp.set_data(bad, unc)


def test_missing_band_flux_is_zeroed_and_weightless():
    """NaN flux at a missing band reaches the likelihood as 0 with weight 0
    (NaN * 0 would freeze that source's chain); the other sources are
    unaffected by the missing band's value."""
    flux, unc = _data()
    spec = spec_from_reference(_jspec())
    samp = FusedMultiSampler(NW, WAVE, flux, unc, MBBShape(), spec,
                             device="cpu")
    assert samp.ops.flux[1, 0] == 0 and samp.ops.errs[1, 0] == 0
    x = _balls(samp.free_space, S)
    base = samp.ops.plain(x)
    flux2 = flux.copy()
    flux2[1, 0] = 1e6
    samp.set_data(flux2, unc)
    assert torch.equal(samp.ops.plain(x), base)
    assert bool(torch.isfinite(base).all())
    st, chain, lnp = samp.run_mcmc(samp.init_state(x, seed=1), 4)
    assert bool(torch.isfinite(lnp).all()) and st.naccept[1].sum() > 0


def _fitter(backend="torch", nsrc=S, seed=7, **kw):
    flux, unc = _data(nsrc)
    mf = T.MultiFitter(nwalkers=NW, device="cpu", seed=seed,
                       sampler_backend=backend, **kw)
    mf.set_data(WAVE, flux, unc, redshifts=np.linspace(0.5, 3.0, nsrc))
    mf.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    return mf


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_run_shapes_and_extend_equals_longer_run(backend):
    """run(nburn, 8) + extend(4) is bitwise run(nburn, 12): the per-source
    Philox streams continue; on the CPU both backends run the plain multi
    run."""
    a = _fitter(backend).run(nburn=10, nsteps=8, thin=2)
    assert a.chain_free.shape == (S, 4, NW, 5)
    assert a.chain.shape == (S, NW, 4, 5)
    assert a.flatchain().shape == (S, 4 * NW, 5)
    assert a.acceptance_fraction.shape == (S, NW)
    assert a.free_param_names == ["T", "beta", "lambda0", "alpha", "fnorm"]
    assert a._backend_used == backend
    a.extend(4)
    b = _fitter(backend).run(nburn=10, nsteps=12, thin=2)
    assert torch.equal(a.chain_free, b.chain_free)
    assert torch.equal(a.lnprobability, b.lnprobability)
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)
    c = _fitter(backend, seed=8).run(nburn=10, nsteps=12, thin=2)
    assert not torch.equal(c.chain_free, b.chain_free)


@pytest.mark.parametrize("change", ["no-run", "set_data", "fix_param",
                                    "uplim-mask", "thin"])
def test_extend_refusals(change):
    """extend() refuses what multifit.py:681-710 refuses."""
    mf = _fitter()
    if change == "no-run":
        with pytest.raises(RuntimeError, match="run"):
            mf.extend(4)
        return
    mf.run(nburn=4, nsteps=4, thin=2)
    if change == "set_data":
        flux, unc = _data(seed=1)
        mf.set_data(WAVE, flux, unc)
        err = RuntimeError
    elif change == "fix_param":
        mf.fix_param("alpha", 3.0)
        err = RuntimeError
    elif change == "uplim-mask":
        mf.set_phot_upperlimits(np.array([0, 0, 0, 0, 1], bool))
        err = RuntimeError
    else:
        err = ValueError
    with pytest.raises(err):
        mf.extend(3)


@pytest.mark.parametrize("nnodes", [65, 129])
def test_multifitter_response_mode(tmp_path, nnodes):
    """MultiFitter(responses=...): the pack of the named bands is the JAX
    package's, runs (plain multi run on the CPU) and extends, persists in
    the batch file both packages reload, and rides each source's
    MBBResults view; without band names it is refused."""
    from mbb_emcee_tpu.response import ResponseSet as JRS
    flux, unc = _data()
    mf = T.MultiFitter(nwalkers=NW, device="cpu", seed=3,
                       responses=ResponseSet.builtin(BANDS, nnodes=nnodes))
    mf.set_data(WAVE, flux, unc, band_names=BANDS)
    mf.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    want = JRS.builtin(BANDS, nnodes=nnodes).pack(BANDS)
    for got, w in zip(mf._response_pack(), want):
        np.testing.assert_array_equal(got, w)
    mf.run(nburn=6, nsteps=8).extend(4)
    assert mf.chain_free.shape == (S, 12, NW, 5)
    assert bool(torch.isfinite(mf.lnprobability).all())
    mf.writeToHDF5(str(tmp_path / "r.h5"))
    jmf = J.MultiFitter.from_h5(str(tmp_path / "r.h5"))
    for got, w in zip(jmf._response_pack(), want):
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)
    res = mf.results(2)
    assert res.response_pack[0].shape == (5, nnodes)
    bad = T.MultiFitter(nwalkers=NW, device="cpu",
                        responses=ResponseSet.builtin(BANDS))
    bad.set_data(WAVE, flux, unc)
    with pytest.raises(ValueError, match="band_names"):
        bad.run(nburn=2, nsteps=2)


def test_multifitter_checkpointed_run(tmp_path):
    """run(checkpoint=...) flushes the batch run and equals the plain run;
    resume=True without a checkpoint path is refused."""
    ck = tmp_path / "m.ckpt.h5"
    a = _fitter().run(nburn=6, nsteps=8, checkpoint=str(ck),
                      checkpoint_interval=4)
    assert ck.is_file()
    assert torch.equal(a.chain_free, _fitter().run(nburn=6,
                                                   nsteps=8).chain_free)
    with pytest.raises(ValueError, match="requires checkpoint"):
        _fitter().run(nburn=2, nsteps=2, resume=True)


@pytest.mark.parametrize("call,item", [
    (lambda: T.MultiFitter(mesh=object(), device="cpu"), "A11")])
def test_multifitter_refuses_unported_surfaces(call, item):
    """mesh= (ROADMAP A11, ported) takes a parallel.walker_mesh and refuses
    anything else by name (tests/test_torch_parallel.py runs the tiers on
    a mesh against the unsharded batch)."""
    with pytest.raises(TypeError, match="walker_mesh"):
        call()


@pytest.mark.parametrize("call,nlive", [
    (lambda mf: mf.compute_evidence(nlive=64, max_iter=3), 64),
    (lambda mf: mf.compute_evidence(nlive=64, max_iter=3, verbose=True), 64),
    (lambda mf: mf.compute_evidence(max_iter=2), 512)])
def test_multifitter_compute_evidence_runs(call, nlive):
    """The batch's compute_evidence (once refused as A9e) runs on the plain
    batch likelihood: cut short by max_iter here, so every source warns as
    truncated; (S,) summaries, full-space samples, stored on the fitter."""
    mf = _fitter()
    with pytest.warns(UserWarning, match=f"{S}/{S} sources"):
        ev = call(mf)
    assert mf.evidence is ev and not ev.converged.any()
    assert ev.logz.shape == (S,) and np.all(np.isfinite(ev.logz))
    assert ev.samples.shape[1:] == (int(ev.n_iter.max()) * 32 + nlive, 5)


def _injected_chain(nsrc=3, nrec=48, nw=16, seed=12):
    """A shared (S, nrec, nw, 5) chain around the truth, AR(1) in steps,
    with one frozen coordinate in source 2."""
    rng = np.random.default_rng(seed)
    x = np.empty((nsrc, nrec, nw, 5))
    x[:, 0] = rng.standard_normal((nsrc, nw, 5))
    for r in range(1, nrec):
        x[:, r] = 0.8 * x[:, r - 1] + 0.6 * rng.standard_normal((nsrc, nw,
                                                                   5))
    scale = np.array([3.0, 0.15, 30.0, 0.4, 3.0])
    chain = (TRUE + scale * x).astype(np.float32)
    chain[2, :, :, 3] = 3.25                  # alpha frozen in source 2
    lnp = (-0.5 * (x ** 2).sum(-1)).astype(np.float32)
    return chain, lnp


@pytest.fixture(scope="module")
def injected():
    """One chain injected into a port MultiFitter and a JAX MultiFitter
    with the same data (a missing band, per-source redshifts)."""
    chain, lnp = _injected_chain()
    flux, unc = _data(3)
    z = np.array([0.7, 1.9, 3.1])
    acc = np.random.default_rng(1).uniform(0.2, 0.5, (3, 16))
    tmf = T.MultiFitter(nwalkers=16, device="cpu")
    jmf = J.MultiFitter(nwalkers=16)
    for mf in (tmf, jmf):
        mf.set_data(WAVE, flux, unc, source_names=["a", "b", "c"],
                    redshifts=z)
        mf.set_uplim("T", 100.0)
        mf.acceptance_fraction = acc
        mf.thin = 1
    tmf.free_space = FreeSpace.from_spec(tmf._effective_spec())
    tmf.chain_free = torch.as_tensor(chain)
    tmf.lnprobability = torch.as_tensor(lnp)
    _, jmf.free_space = j_build_lnprob_data(jmf.shape, jmf._effective_spec())
    jmf.chain_free = jnp.asarray(chain)
    jmf.lnprobability = jnp.asarray(lnp)
    return tmf, jmf


@pytest.mark.parametrize("name", ["par_cen", "best_fit", "gelman_rubin",
                                  "gelman_rubin_window", "tau", "converged",
                                  "sed_percentiles"])
def test_summaries_match_jax_on_one_chain(injected, name):
    tmf, jmf = injected
    if name == "par_cen":
        for p in ("T", "beta", "lambda0", "alpha", "fnorm", 3):
            np.testing.assert_allclose(tmf.par_cen(p), jmf.par_cen(p),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tmf.par_cen("T", 90.0),
                                   jmf.par_cen("T", 90.0), rtol=1e-5)
    elif name == "best_fit":
        for got, want in zip(tmf.best_fit(), jmf.best_fit()):
            np.testing.assert_allclose(got, want, rtol=1e-5)
    elif name in ("gelman_rubin", "gelman_rubin_window", "tau"):
        kw = dict(window=16, stride=2) if name.endswith("window") else {}
        if name == "tau":
            got = tmf.autocorrelation_time()
            want = jmf.autocorrelation_time()
            host = jsampler.autocorrelation_time(
                np.asarray(jmf.chain_free[2]))
        else:
            got, want = tmf.gelman_rubin(**kw), jmf.gelman_rubin(**kw)
            host = jsampler.split_rhat(np.asarray(jmf.chain_free[2]))
        # The frozen coordinate (source 2, alpha) is NaN, as the JAX
        # package's host statistic gives and its device twins document;
        # its fp32 device reduction returns a large finite value there
        # (ROADMAP.md C), so that entry is held against the host one.
        assert np.isnan(got[2, 3]) and np.isnan(host[3])
        live = np.ones(got.shape, bool)
        live[2, 3] = False
        np.testing.assert_allclose(got[live], want[live], rtol=1e-4)
    elif name == "converged":
        for kw in (dict(rhat_max=1.5), dict(rhat_max=1.5, tau_mult=2.0),
                   dict(rhat_max=1.2, window=24, stride=1)):
            np.testing.assert_array_equal(tmf.converged(**kw),
                                          jmf.converged(**kw))
    else:
        got = tmf.sed_percentiles([100.0, 300.0, 1000.0], thin=4)
        want = jmf.sed_percentiles([100.0, 300.0, 1000.0], thin=4)
        assert got.shape == (3, 3, 3)
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("quantity", ["lir", "dustmass", "peaklambda"])
def test_derived_posteriors_match_jax_on_one_chain(injected, quantity):
    """Per-source derived posteriors from the stored redshifts (WMAP9),
    rtol 1e-4; lambda_peak at 2e-3 (ROADMAP.md C: both sides stop the fp32
    golden section anywhere on a ~1e-3-wide plateau)."""
    tmf, jmf = injected
    got = getattr(tmf, f"compute_{quantity}")(thin=4)
    want = np.asarray(getattr(jmf, f"compute_{quantity}")(thin=4))
    assert got.shape == (3, 48 * 16 // 4) and np.all(np.isfinite(got))
    rtol = 2e-3 if quantity == "peaklambda" else 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol)
    # the +/- errors are differences of percentiles: an error of 2e-3
    # relative per sample is an absolute one of that size on each
    cen_atol = 2 * rtol * np.abs(want).max() if quantity == "peaklambda" \
        else 0.0
    np.testing.assert_allclose(getattr(tmf, f"{quantity}_cen")(),
                               getattr(jmf, f"{quantity}_cen")(),
                               rtol=rtol, atol=cen_atol)


def test_hdf5_files_cross_load_and_results_views_agree(injected, tmp_path):
    """A batch file written by the port loads in the JAX package's
    MultiFitter.from_h5 and the reverse; results(i) of both agree."""
    tmf, jmf = injected
    tmf.compute_lir(thin=8)
    tmf.set_phot_upperlimits(_per_source_uplim(3))
    tmf.writeToHDF5(tmp_path / "port.h5", thin=2)
    tmf.set_phot_upperlimits(np.zeros(5, bool))
    jmf.compute_peaklambda(thin=8)
    jmf.writeToHDF5(str(tmp_path / "jax.h5"))

    in_jax = J.MultiFitter.from_h5(str(tmp_path / "port.h5"))
    in_port = T.MultiFitter.from_h5(tmp_path / "jax.h5", device="cpu")
    assert in_jax.chain_free.shape == (3, 24, 16, 5) and in_jax.thin == 2
    np.testing.assert_array_equal(in_jax._spec.uplim_bands,
                                  _per_source_uplim(3))
    np.testing.assert_allclose(in_jax.lir_chain, tmf.lir_chain, rtol=1e-6)
    np.testing.assert_allclose(in_port.peaklambda_chain,
                               np.asarray(jmf.peaklambda_chain), rtol=1e-6)
    assert in_port.source_names == ["a", "b", "c"]
    np.testing.assert_array_equal(in_port.redshifts, jmf.redshifts)
    for p in ("T", "beta", "fnorm"):
        np.testing.assert_allclose(in_port.par_cen(p), jmf.par_cen(p),
                                   rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(in_jax.chain_free),
                                  tmf.chain_free[:, ::2].numpy())
    for i in range(3):
        tr, jr = tmf.results(i), jmf.results(i)
        assert tr.redshift == jr.redshift
        for p in ("T", "beta", "lambda0", "fnorm"):
            np.testing.assert_allclose(tr.par_cen(p), jr.par_cen(p),
                                       rtol=1e-5)
        np.testing.assert_allclose(tr.compute_lir(thin=8),
                                   jr.compute_lir(thin=8), rtol=1e-4)
    np.testing.assert_array_equal(tmf.results(1).phot.unc,
                                  jmf.results(1).phot.unc)


def test_n_ensembles_merge_in_jax_order():
    """MBBFitter(n_ensembles=3): K independent ensembles through the batch
    tier, merged as the JAX package's _merge_ensembles merges them; a
    covariance is refused; extend() goes through MultiFitter.extend."""
    flux, unc = _data(1, missing=False)
    fit = T.MBBFitter(nwalkers=NW, device="cpu", n_ensembles=3, seed=5)
    fit.set_data(WAVE, flux[0], unc[0])
    fit.run(nburn=6, nsteps=8)
    mf = fit._mf
    assert mf.nsources == 3 and fit.chain_free.shape == (8, 3 * NW, 5)
    ref = types.SimpleNamespace()
    J.MBBFitter._merge_ensembles(ref, types.SimpleNamespace(
        chain_free=mf.chain_free.numpy(),
        lnprobability=mf.lnprobability.numpy(),
        acceptance_fraction=mf.acceptance_fraction,
        free_space=mf.free_space, thin=mf.thin))
    np.testing.assert_array_equal(fit.chain_free.numpy(),
                                  np.asarray(ref.chain_free))
    np.testing.assert_array_equal(fit.lnprobability.numpy(),
                                  np.asarray(ref.lnprobability))
    np.testing.assert_array_equal(fit.acceptance_fraction,
                                  ref.acceptance_fraction)
    assert not torch.equal(mf.chain_free[0], mf.chain_free[1])
    res = T.MBBResults(fit=fit, redshift=2.0)
    assert res.chain.shape == (3 * NW, 8, 5) and res.nwalkers == 3 * NW
    assert np.all(np.isfinite(fit.gelman_rubin()))
    fit.extend(4)
    assert fit.chain_free.shape == (12, 3 * NW, 5)

    cov = T.MBBFitter(nwalkers=NW, device="cpu", n_ensembles=2)
    cov.set_data(WAVE, flux[0], unc[0], cov=np.diag(unc[0] ** 2))
    with pytest.raises(ValueError, match="diagonal"):
        cov.run(nburn=2, nsteps=2)
    with pytest.raises(ValueError):
        T.MBBFitter(device="cpu", n_ensembles=0)
    with pytest.raises(RuntimeError, match="run"):
        T.MBBFitter(device="cpu", n_ensembles=2).extend(2)

