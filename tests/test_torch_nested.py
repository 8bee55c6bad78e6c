"""Nested sampling in the port (mbb_emcee_tpu_torch/nested.py) against the
JAX package on the CPU: one iteration replayed from JAX's own draws (the
key splits of mbb_emcee_tpu/nested.py's body and replace, fed to
nested_iteration_from_draws) against _nested_run at rtol 2e-5, including a
batch step in which one source is done and stays frozen; the Philox stream
of the nested runs; then the port's twins of tests/test_nested.py: the
analytic Gaussian evidence, the weighted moments, the wrong-model Bayes
factor, the truncation warning, validation, a batch equal to each single
run bit for bit, MBBFitter and MultiFitter compute_evidence against the JAX
package's within 3x the combined error, and the /Evidence and batch
Evidence groups read by both packages.

Left out by design: test_program_token_shares_ll_unit (the traced-program
LRU is not ported: torch has no trace step) and the slow thin-against-thick
model comparison (chip_smoke.py phase 23 runs it at config 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
from mbb_emcee_tpu import nested as jn  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import nested as tn  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    ModifiedBlackbody)
from mbb_emcee_tpu_torch.ops import philox  # noqa: E402

MU = np.array([0.5, -0.3, 1.0])
SIG = np.array([0.1, 0.2, 0.15])
LOWER = np.array([-2.0, -2.0, -1.0])
UPPER = np.array([3.0, 2.0, 3.0])
LNV = float(np.log(np.prod(UPPER - LOWER)))
LOGNORM = float(np.sum(np.log(SIG * np.sqrt(2.0 * np.pi))))


def _t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _gauss_ll(mu=MU, sig=SIG):
    """Port batched log-likelihood (n, 3) -> (n,) of a normalized Gaussian."""
    m, s = _t32(mu), _t32(sig)
    lognorm = float(np.sum(np.log(np.asarray(sig) * np.sqrt(2.0 * np.pi))))

    def ll(x):
        return -0.5 * torch.sum(((x - m) / s) ** 2, dim=-1) - lognorm

    return ll


def _run(seed=0, **kw):
    kw.setdefault("nlive", 128)
    kw.setdefault("nbatch", 16)
    kw.setdefault("nsteps", 16)
    return tn.nested_sample(_gauss_ll(), LOWER, UPPER, seed, device="cpu",
                            **kw)


# -- one iteration replayed from JAX's draws ------------------------------------

NLIVE, NBATCH, NSTEPS, NITER = 64, 8, 6, 4


def _unit_ll(width):
    """(JAX scalar, port batched) unit-cube log-likelihoods of a Gaussian of
    the given width (per coordinate) at MU in the LOWER..UPPER box; the
    JAX one takes the width as data, as _nested_run passes it."""
    lo32, wd32 = np.float32(LOWER), np.float32(UPPER - LOWER)
    jm = jnp.asarray(MU, jnp.float32)

    def jl(u, w):
        x = lo32 + wd32 * u
        return -0.5 * jnp.sum(((x - jm) / w) ** 2)

    tm, tw = _t32(MU), _t32(width)
    tlo, twd = _t32(lo32), _t32(wd32)

    def tl(u):
        x = tlo + twd * u
        return -0.5 * torch.sum(((x - tm) / tw) ** 2, dim=-1)

    return jl, tl


def _jax_draws(key, niter):
    """The draws of `niter` iterations of _nested_run's body from `key`
    (nested.py: the body's split, then replace's seed and per-step splits),
    as port tensors (seed (niter, B), partner, uz, ua (niter, K, B))."""
    nsurv = NLIVE - NBATCH
    out = [[], [], [], []]
    for _ in range(niter):
        key, krep = jax.random.split(key)
        k2, kseed = jax.random.split(krep)
        out[0].append(jax.random.randint(kseed, (NBATCH,), 0, nsurv))
        parts, uz, ua = [], [], []
        for k in jax.random.split(k2, NSTEPS):
            kp, kz, ku = jax.random.split(k, 3)
            parts.append(jax.random.randint(kp, (NBATCH,), 0, nsurv))
            uz.append(jax.random.uniform(kz, (NBATCH,), jnp.float32))
            ua.append(jax.random.uniform(ku, (NBATCH,), jnp.float32))
        for lst, v in zip(out[1:], (parts, uz, ua)):
            lst.append(jnp.stack(v))
    return tuple(torch.as_tensor(np.array(jnp.stack(v))).to(
        torch.int64 if i < 2 else torch.float32) for i, v in enumerate(out))


def _jax_run(width, key, u0, tol):
    jl, _ = _unit_ll(width)
    w = jnp.asarray(width, jnp.float32)
    lnl0 = jax.vmap(lambda u: jl(u, w))(jnp.asarray(u0))
    out = jn._nested_run(key, jl, jnp.asarray(u0), lnl0, (w,), NLIVE, NBATCH,
                         NSTEPS, NITER, 2.0, float(np.log(tol)))
    return [np.asarray(a) for a in out]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                               err_msg=what)


def _check_source(state, dead, jout, s=None):
    """Port state + dead buffers of (source s of) a run against _nested_run's
    (it, done, lnz, live, lnl, live_w, dead_x, dead_l, dead_w)."""
    pick = (lambda t: t) if s is None else (lambda t: t[s])
    lnz, live_w = tn._close_out(
        tn.NestedState(*(getattr(state, f)[None] if s is None
                         else getattr(state, f)[s:s + 1]
                         for f in ("it", "done", "live", "lnl", "lnx",
                                   "lnz"))), NLIVE)
    it, done = int(pick(state.it)), bool(pick(state.done))
    assert it == int(jout[0]) and done == bool(jout[1])
    _close(float(lnz[0]), float(jout[2]), "lnz")
    _close(pick(state.live).numpy(), jout[3], "live")
    _close(pick(state.lnl).numpy(), jout[4], "lnl")
    _close(live_w[0].numpy(), jout[5], "live_w")
    for got, want, what in zip(dead, jout[6:], ("dead_x", "dead_l",
                                                "dead_w")):
        _close(pick(got).numpy(), want, what)


def test_iteration_replays_jax_nested_run():
    """NITER iterations of nested_iteration_from_draws on JAX's own draws
    reproduce _nested_run(max_iter=NITER) on the same start: dead points,
    their likelihoods and weights, the live set and lnZ at rtol 2e-5."""
    width = 0.3 * np.ones(3)
    rng = np.random.default_rng(5)
    u0 = rng.uniform(size=(NLIVE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    jout = _jax_run(width, key, u0, 1e-4)
    _, tl = _unit_ll(width)
    state = tn.init_nested_state(_t32(u0), tl(_t32(u0)))
    draws = _jax_draws(key, NITER)
    dead = [[], [], []]
    for i in range(NITER):
        state, d = tn.nested_iteration_from_draws(
            state, tl, tuple(x[i] for x in draws))
        for lst, v in zip(dead, d):
            lst.append(v)
    _check_source(state, [torch.cat(v) for v in dead], jout)


def test_batch_iteration_freezes_a_done_source():
    """Two sources in one batched iteration on their own JAX draws: a wide,
    nearly flat source whose stopping rule fires after the first iteration
    (tol 10) is left bit for bit as it was for the other NITER - 1, its dead
    slots empty, while the narrow source keeps going; each equals its own
    _nested_run."""
    widths = np.stack([0.3 * np.ones(3), 50.0 * np.ones(3)])
    rng = np.random.default_rng(8)
    u0 = rng.uniform(size=(2, NLIVE, 3)).astype(np.float32)
    keys = (jax.random.PRNGKey(21), jax.random.PRNGKey(22))
    jouts = [_jax_run(widths[s], keys[s], u0[s], 10.0) for s in range(2)]
    assert int(jouts[1][0]) == 1 and bool(jouts[1][1])
    assert int(jouts[0][0]) == NITER and not bool(jouts[0][1])
    tls = [_unit_ll(w)[1] for w in widths]

    def lnprob(u):
        return torch.stack([tls[s](u[s]) for s in range(2)])

    state = tn.init_nested_state(_t32(u0), lnprob(_t32(u0)))
    draws = [_jax_draws(k, NITER) for k in keys]
    dead, frozen = [[], [], []], None
    for i in range(NITER):
        state, d = tn.nested_iteration_from_draws(
            state, lnprob, tuple(torch.stack([dr[j][i] for dr in draws])
                                 for j in range(4)), logtol=float(np.log(10.0)))
        for lst, v in zip(dead, d):
            lst.append(v)
        if i == 0:
            frozen = (state.live[1].clone(), state.lnl[1].clone(),
                      state.lnx[1].clone(), state.lnz[1].clone())
    assert torch.equal(state.live[1], frozen[0])
    assert torch.equal(state.lnl[1], frozen[1])
    assert torch.equal(state.lnx[1], frozen[2])
    assert torch.equal(state.lnz[1], frozen[3])
    dead = [torch.cat(v, dim=1) for v in dead]
    for s in range(2):
        _check_source(state, dead, jouts[s], s)


def test_nested_streams():
    """The nested draws of a source depend on its index, not its batch, and
    of an iteration on the iteration, not the block; their counters never
    meet the stretch move's or the start's; indices stay in range."""
    key = 0x1234_5678_9ABC
    seed, part, uz, ua = philox.nested_draws(key, 3, 4, 8, 6, 40, "cpu",
                                             source=[1, 4])
    assert seed.shape == (4, 2, 8) and part.shape == (4, 2, 6, 8)
    assert uz.shape == ua.shape == (4, 2, 6, 8)
    one = philox.nested_draws(key, 5, 2, 8, 6, 40, "cpu", source=4)
    for a, b in zip((seed, part, uz, ua), one):
        assert torch.equal(a[2:, 1], b)
    assert int(seed.min()) >= 0 and int(seed.max()) < 40
    assert int(part.min()) >= 0 and int(part.max()) < 40
    tags = (philox.PT_TAG, philox.HMC_TAG_A, philox.HMC_TAG_B,
            philox.NESTED_TAG)
    assert len(set(tags)) == 4
    assert philox._TAG_BASE + (philox.NESTED_TAG << 20) >= 2 ** 31
    s = philox.stretch_uniforms(key, 0, 2, 8, "cpu")
    _, _, uz2, ua2 = philox.nested_draws(key, 0, 2, 4, 2, 40, "cpu")
    assert not np.isin(uz2.numpy(), s.numpy()).any()
    assert not np.isin(ua2.numpy(), s.numpy()).any()
    u0 = philox.nested_start(key, 16, 3, "cpu", source=[1, 4])
    assert u0.shape == (2, 16, 3)
    assert torch.equal(u0[1], philox.nested_start(key, 16, 3, "cpu",
                                                  source=4))
    assert not np.isin(philox.nested_start(key, 4, 3, "cpu").numpy(),
                       uz2.numpy()).any()
    with pytest.raises(ValueError, match="2\\^31"):
        philox.nested_draws(key, 0, 1, 1 << 16, 1 << 16, 40, "cpu")


# -- twins of tests/test_nested.py ---------------------------------------------

def test_truncated_run_flagged_and_warned():
    with pytest.warns(UserWarning, match="max_iter"):
        r = _run(max_iter=3, nlive=64, nbatch=8, nsteps=4)
    assert r.converged is False and r.n_iter == 3
    assert _run(nlive=64, nbatch=8, nsteps=8).converged is True
    cent = _t32(np.stack([MU, MU + 0.1]))

    def ll(x, mu):
        return -0.5 * torch.sum(((x - mu[:, None]) / 0.1) ** 2, dim=-1)

    with pytest.warns(UserWarning, match="2/2 sources"):
        rb = tn.nested_sample_batch(ll, LOWER, UPPER, 0, (cent,), nlive=64,
                                    nbatch=8, nsteps=4, max_iter=3,
                                    device="cpu")
    assert rb.converged.tolist() == [False, False]
    assert rb[0].converged is False


def test_gaussian_evidence_analytic():
    """lnZ of a normalized Gaussian well inside the box is -ln V; the
    information H is near its analytic value."""
    r = _run()
    assert r.logz_err < 0.3
    assert abs(r.logz - (-LNV)) < max(4.0 * r.logz_err, 0.05)
    h_true = LNV - np.sum(np.log(SIG * np.sqrt(2 * np.pi * np.e)))
    assert abs(r.h - h_true) < 1.0
    assert r.n_like == 128 + r.n_iter * 16 * 16


def test_posterior_moments_from_weighted_samples():
    r = _run(seed=1)
    w = r.posterior_weights()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    assert np.all(w >= 0.0)
    mean = r.posterior_mean()
    np.testing.assert_allclose(mean, MU, atol=0.03)
    var = ((r.samples - mean) ** 2 * w[:, None]).sum(axis=0)
    np.testing.assert_allclose(np.sqrt(var), SIG, rtol=0.15)
    draws = r.resample(4000, seed=3)
    np.testing.assert_allclose(draws.mean(axis=0), MU, atol=0.04)


def test_bayes_factor_detects_wrong_model():
    ll = _gauss_ll()
    ra = tn.nested_sample(ll, LOWER, UPPER, 2, nlive=128, nbatch=16,
                          nsteps=16, device="cpu")
    rfar = tn.nested_sample(ll, MU + 4.0 * SIG, MU + 24.0 * SIG, 2,
                            nlive=128, nbatch=16, nsteps=16, device="cpu")
    assert ra.logz - rfar.logz > 5.0
    rb = tn.nested_sample(_gauss_ll(mu=MU - 5.0 * SIG), LOWER, UPPER, 2,
                          nlive=128, nbatch=16, nsteps=16, device="cpu")
    assert abs(ra.logz - rb.logz) < max(
        6.0 * np.hypot(ra.logz_err, rb.logz_err), 0.1)


def test_determinism_and_validation():
    r1, r2, r3 = (_run(seed=s, nlive=64, nbatch=8, nsteps=8)
                  for s in (7, 7, 8))
    assert r1.logz == r2.logz
    assert np.array_equal(r1.samples, r2.samples)
    assert r1.logz != r3.logz
    with pytest.raises(ValueError, match="finite"):
        tn.nested_sample(_gauss_ll(), np.array([-np.inf, 0, 0]), UPPER, 0,
                         device="cpu")
    with pytest.raises(ValueError, match="nbatch"):
        tn.nested_sample(_gauss_ll(), LOWER, UPPER, 0, nlive=32, nbatch=32,
                         device="cpu")
    with pytest.raises(TypeError, match="walker_mesh"):
        tn.make_nested_batch_runner(_gauss_ll(), LOWER, UPPER, mesh=object())


def _batch_ll():
    sig = _t32(SIG)

    def ll(x, mu):
        return -0.5 * torch.sum(((x - mu[:, None]) / sig) ** 2,
                                dim=-1) - LOGNORM

    return ll


def test_batch_gaussian_evidences():
    centers = np.stack([MU, MU + 0.8, MU - 0.5, MU * 0.0], axis=0)
    r = tn.nested_sample_batch(_batch_ll(), LOWER, UPPER, 3,
                               (_t32(centers),), nlive=128, nbatch=16,
                               nsteps=16, device="cpu")
    assert r.nsources == 4
    for s in range(4):
        assert abs(r.logz[s] - (-LNV)) < max(4.0 * r.logz_err[s], 0.06), s
    np.testing.assert_allclose(r.posterior_mean(), centers, atol=0.05)
    np.testing.assert_allclose(r.posterior_weights().sum(axis=1), 1.0,
                               rtol=1e-6)
    one = r[2]
    assert one.logz == float(r.logz[2])
    np.testing.assert_allclose(one.posterior_mean(), centers[2], atol=0.05)


def test_batch_matches_single_bitwise():
    """Source 1's wide Gaussian finishes early and sits frozen while source
    0 goes on; each source of the batch equals the single run on its data
    with its source index, bit for bit."""
    widths = np.stack([0.3 * np.ones(3), 3.0 * np.ones(3)], axis=0)
    m = _t32(MU)

    def ll(x, w):
        return -0.5 * torch.sum(((x - m) / w[:, None]) ** 2, dim=-1)

    kw = dict(nlive=64, nbatch=8, nsteps=8)
    r = tn.nested_sample_batch(ll, LOWER, UPPER, 9, (_t32(widths),),
                               device="cpu", **kw)
    assert r.n_iter[1] < r.n_iter[0]
    for s in range(2):
        w = _t32(widths[s])
        one = tn.nested_sample(lambda x: ll(x[None], w[None])[0], LOWER,
                               UPPER, 9, device="cpu", source=s, **kw)
        assert one.n_iter == int(r.n_iter[s]) and one.converged
        assert one.logz == float(r.logz[s])
        assert np.array_equal(one.samples, r[s].samples)
        assert np.array_equal(one.logwt, r[s].logwt)


def _mock_data(S=1, seed=11, wave=(250.0, 350.0, 500.0, 850.0, 1100.0),
               T=(32.0,), fn=(40.0,)):
    rng = np.random.default_rng(seed)
    wave = np.asarray(wave)
    flux = np.stack([ModifiedBlackbody(
        T=T[i], beta=1.9, lambda0=250.0, alpha=2.0, fnorm=fn[i],
        opthin=True, noalpha=True)(_t32(wave)).double().numpy()
        for i in range(S)])
    unc = 0.05 * flux
    return wave, flux + rng.normal(0.0, unc), unc


def _limits(f, t_hi=60.0, fn_hi=200.0):
    f.set_lowlim("T", 15.0 if t_hi == 60.0 else 10.0)
    f.set_uplim("T", t_hi)
    f.set_lowlim("beta", 0.5)
    f.set_uplim("beta", 4.0)
    f.set_lowlim("fnorm", 5.0)
    f.set_uplim("fnorm", fn_hi)
    return f


def _fits(seed):
    wave, flux, unc = _mock_data()
    t = T.MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=seed,
                    device="cpu")
    t.set_data(wave, flux[0], unc[0])
    j = J.MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=seed)
    j.set_data(wave, flux[0], unc[0])
    return _limits(t), _limits(j)


def test_fitter_compute_evidence_matches_jax():
    """MBBFitter.compute_evidence (the lnprob kernel's plain version on the
    CPU) against the JAX package's on the same data and prior box: lnZ
    within 3x the combined error; the samples in the full 5-parameter
    space, their weighted mean on the stretch-move posterior; deterministic
    by seed."""
    t, j = _fits(5)
    kw = dict(nlive=128, nbatch=16, nsteps=16, seed=5)
    ev = t.compute_evidence(**kw)
    ej = j.compute_evidence(**kw)
    assert t.evidence is ev and ev.converged
    assert ev.samples.shape[1] == 5
    assert abs(ev.logz - ej.logz) < 3.0 * np.hypot(ev.logz_err, ej.logz_err)
    mean = ev.posterior_mean()
    t.run(nburn=100, nsteps=300)
    rm = T.MBBResults(fit=t)
    for i, p in ((0, "T"), (1, "beta"), (4, "fnorm")):
        med, up, lo = rm.par_cen(p)
        assert abs(mean[i] - med) < 0.5 * (up + lo), p
    assert _fits(5)[0].compute_evidence(**kw).logz == ev.logz


def _batches():
    Ts, fn = (25.0, 32.0, 40.0), (30.0, 50.0, 80.0)
    wave, flux, unc = _mock_data(3, 21, (250.0, 350.0, 500.0, 850.0), Ts,
                                 fn)
    t = T.MultiFitter(nwalkers=64, opthin=True, noalpha=True, device="cpu")
    j = J.MultiFitter(nwalkers=64, opthin=True, noalpha=True)
    for m in (t, j):
        m.set_data(wave, flux, unc)
        _limits(m, t_hi=70.0, fn_hi=300.0)
    return t, j


def test_multifitter_compute_evidence_matches_jax():
    """Per-source evidences through MultiFitter (the plain batch likelihood)
    against the JAX package's batch: each source's lnZ within 3x the
    combined error; results(i) carries its source's NestedResult."""
    t, j = _batches()
    kw = dict(nlive=128, nbatch=16, nsteps=16, seed=4)
    r = t.compute_evidence(**kw)
    rj = j.compute_evidence(**kw)
    assert r is t.evidence and r.converged.all()
    assert r.logz.shape == (3,) and r.samples.shape[2] == 5
    np.testing.assert_array_less(
        np.abs(r.logz - rj.logz), 3.0 * np.hypot(r.logz_err, rj.logz_err))
    t.run(nburn=20, nsteps=20)
    res0 = t.results(0)
    assert res0.evidence.logz == pytest.approx(float(r.logz[0]))
    np.testing.assert_array_equal(t.compute_evidence(**kw).logz, r.logz)


def test_evidence_files_cross_both_ways(tmp_path):
    """The single fit's /Evidence group and the batch file's Evidence group
    written by the port load in the JAX package, and the JAX package's
    writer's files of them load in the port."""
    t, _ = _fits(6)
    t.run(nburn=20, nsteps=30)
    t.compute_evidence(nlive=64, nbatch=8, nsteps=8, seed=6)
    p1, p2 = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    T.MBBResults(fit=t).writeToHDF5(p1)
    jr = J.MBBResults(h5file=p1)
    jr.writeToHDF5(p2)
    back = T.MBBResults(h5file=p2, device="cpu")
    for got in (jr.evidence, back.evidence):
        assert got.logz == t.evidence.logz and got.n_like == t.evidence.n_like
        assert got.converged == t.evidence.converged
        np.testing.assert_allclose(got.samples, t.evidence.samples,
                                   rtol=1e-6)
        np.testing.assert_allclose(got.posterior_weights().sum(), 1.0,
                                   rtol=1e-6)

    mf, _ = _batches()
    mf.run(nburn=10, nsteps=10)
    ev = mf.compute_evidence(nlive=64, nbatch=8, nsteps=8, seed=2)
    p3, p4 = str(tmp_path / "bport.h5"), str(tmp_path / "bjax.h5")
    mf.writeToHDF5(p3)
    jm = J.MultiFitter.from_h5(p3)
    jm.writeToHDF5(p4)
    tb = T.MultiFitter.from_h5(p4, device="cpu")
    for got in (jm.evidence, tb.evidence):
        np.testing.assert_array_equal(got.logz, ev.logz)
        np.testing.assert_array_equal(got.n_iter, ev.n_iter)
        assert got.nlive == 64 and got.nbatch == 8
        np.testing.assert_allclose(got.samples, ev.samples, rtol=1e-6)
    assert tb.results(1).evidence.logz == pytest.approx(float(ev.logz[1]))
