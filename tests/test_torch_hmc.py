"""Hamiltonian MC in the port (mbb_emcee_tpu_torch/hmc.py) against the JAX
package on the CPU: the leapfrog + Metropolis step replayed from JAX's own
draws (a boxed Gaussian over 3 steps at rtol 1e-5; config 2's likelihood
over one at rtol 1e-3, torch.autograd against jax.grad), the dual-averaging
warmup and its diagonal mass over the same deterministic stepper, the same
refusals with the same messages; then the port's twins of
tests/test_hmc.py (single fit and batch, without the mesh case)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import hmc as jh  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import hmc as th  # noqa: E402
from mbb_emcee_tpu_torch.mapfit import _to_unconstrained  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    ModifiedBlackbody)
from tools import validate_tpu_parity as vp  # noqa: E402

MEAN = np.array([1.0, -2.0, 0.5])
SIG = np.array([0.8, 1.5, 0.3])
LOWER = MEAN - 12.0 * SIG
UPPER = MEAN + 12.0 * SIG


def _t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def _gauss():
    """(JAX scalar lnprob, port batched lnprob) of the same fp32 Gaussian."""
    jm, js = jnp.asarray(MEAN, jnp.float32), jnp.asarray(SIG, jnp.float32)
    tm, ts = _t32(MEAN), _t32(SIG)

    def jl(x):
        d = (x - jm) / js
        return -0.5 * jnp.sum(d * d)

    def tl(x):
        d = (x - tm) / ts
        return -0.5 * torch.sum(d * d, dim=-1)

    return jl, tl


def _jax_draws(key, nchains, nfree):
    """The draws jax hmc_step makes from `key`, as port tensors."""
    kp, kj, ka = jax.random.split(key, 3)
    normals = jax.random.normal(kp, (nchains, nfree), jnp.float32)
    jitter = jax.random.uniform(kj, (nchains, 1), jnp.float32, 0.8, 1.2)
    ua = jax.random.uniform(ka, (nchains,), jnp.float32)
    return tuple(torch.tensor(np.asarray(a)) for a in (normals, jitter, ua))


def _replay(jl, tl, lower, upper, x0, nsteps, n_leapfrog, eps, mass, rtol,
            seed=0):
    """nsteps MH-corrected leapfrog transitions of both packages from x0 on
    JAX's draws, each port step started from the JAX state (a replay does
    not let fp32 differences compound); returns the per-step (port, JAX)
    states."""
    nchains, nfree = x0.shape
    lo, hi = np.asarray(lower, np.float32), np.asarray(upper, np.float32)
    width = hi - lo
    jvg, jstep = (jax.jit(f) for f in jh._make_stepper(
        jl, jnp.asarray(lo), jnp.asarray(width), n_leapfrog, jnp.float32,
        nchains, nfree))
    tvg, tstep = th._make_stepper(tl, _t32(lo), _t32(width), n_leapfrog)
    u0 = np.asarray(jh._to_unconstrained(jnp.asarray(x0), jnp.asarray(lo),
                                         jnp.asarray(width)))
    tu0 = _to_unconstrained(_t32(x0), _t32(lo), _t32(width))
    np.testing.assert_allclose(tu0.numpy(), u0, rtol=1e-6, atol=1e-6)
    (jlp, jraw), jg = jvg(jnp.asarray(u0))
    tlp, traw, tg = tvg(torch.tensor(u0))
    ju, tu = jnp.asarray(u0), torch.tensor(u0)
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(nsteps):
        key, ks = jax.random.split(key)
        ju, jg, jlp, jraw, jacc, jam = jstep(
            ks, ju, jg, jlp, jraw, jnp.float32(eps), jnp.asarray(mass))
        tu, tg, tlp, traw, tacc, tam = tstep(
            _jax_draws(ks, nchains, nfree), tu, tg, tlp, traw,
            torch.tensor(eps, dtype=torch.float32), _t32(mass))
        out.append(((tu, tg, tlp, traw, tacc, tam),
                    (ju, jg, jlp, jraw, jacc, jam)))
        tu, tg, tlp, traw = (torch.tensor(np.asarray(a))
                             for a in (ju, jg, jlp, jraw))
    return out


def test_hmc_step_replays_jax_on_a_boxed_gaussian():
    """Three leapfrog + Metropolis transitions (4 leapfrog steps each) from
    JAX's draws: positions, gradients, target values and the acceptance
    statistic at rtol 1e-5 (of each array's scale), the same accept
    decisions."""
    jl, tl = _gauss()
    rng = np.random.default_rng(1)
    x0 = (MEAN + SIG * rng.standard_normal((16, 3))).astype(np.float32)
    for (t, j) in _replay(jl, tl, LOWER, UPPER, x0, 3, 4, 0.15,
                          np.array([1.0, 2.0, 0.5], np.float32), 1e-5):
        for a, b in zip(t[:4], j[:4]):
            # rtol 1e-5 of each array's scale: a gradient component near 0
            # is a cancellation of terms of the array's size
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
        np.testing.assert_allclose(float(t[5]), float(j[5]), rtol=1e-5)


def test_hmc_step_replays_jax_on_config_2():
    """One transition on config 2's likelihood (5 free parameters, the
    Wien merge solve) from JAX's draws at rtol 1e-3: torch.autograd
    against jax.grad of the plain likelihoods; a decision may differ only
    where its statistic sits within 1e-3 of the uniform."""
    from tests.test_torch_mapfit import _lnprobs
    jl, tl, fs = _lnprobs(2)
    c = vp.TRUE[fs.free_idx]
    rng = np.random.default_rng(2)
    x0 = np.clip(c * (1 + 0.02 * rng.standard_normal((16, c.size))),
                 fs.lower, fs.upper).astype(np.float32)
    (t, j), = _replay(jl, tl, fs.lower, fs.upper, x0, 1, 8, 0.02,
                      np.ones(c.size, np.float32), 1e-3)
    tacc, jacc = t[4].numpy(), np.asarray(j[4])
    same = tacc == jacc
    for a, b in zip(t[:4], j[:4]):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-3, atol=1e-3)
    assert same.sum() >= 15
    np.testing.assert_allclose(float(t[5]), float(j[5]), rtol=1e-3,
                               atol=1e-3)


def _fake_steppers(monkeypatch):
    """Replace both packages' steppers with one deterministic map: u moves
    by 0.05 cos(3u) / sqrt(mass) and the acceptance statistic is a fixed
    function of u, so the warmup's dual averaging sees the same alpha
    sequence in both and its mass the same u samples."""
    def jfake(lnprob, lower, width, n_leapfrog, dtype, nchains, nfree):
        def vg(u):
            z = jnp.zeros(u.shape[0], jnp.float32)
            return (z, z), jnp.zeros_like(u)

        def step(key, u, g, lp, raw, eps, mass):
            u = u + 0.05 * jnp.cos(3.0 * u) / jnp.sqrt(mass)
            alpha = 0.5 + 0.45 * jnp.sin(jnp.sum(u, axis=-1))
            return u, g, lp, raw, alpha > 0.5, jnp.mean(alpha)
        return vg, step

    def tfake(lnprob, lower, width, n_leapfrog):
        def vg(u):
            z = torch.zeros(u.shape[:-1])
            return z, z, torch.zeros_like(u)

        def step(draws, u, g, lp, raw, eps, mass):
            u = u + 0.05 * torch.cos(3.0 * u) / torch.sqrt(mass)[..., None, :]
            alpha = 0.5 + 0.45 * torch.sin(torch.sum(u, dim=-1))
            return u, g, lp, raw, alpha > 0.5, alpha.mean(dim=-1)
        return vg, step

    monkeypatch.setattr(jh, "_make_stepper", jfake)
    monkeypatch.setattr(th, "_make_stepper", tfake)


@pytest.mark.parametrize("nwarmup", [0, 3, 40])
def test_dual_averaging_and_warmup_mass_match_jax(monkeypatch, nwarmup):
    """The two-phase warmup over a fixed alpha sequence: the dual-averaged
    step size at rtol 1e-6 and the diagonal mass from the same u-sample
    stream at rtol 1e-5 (nwarmup 0: eps0 and unit mass; 3: eps only; 40:
    both phases)."""
    _fake_steppers(monkeypatch)
    rng = np.random.default_rng(3)
    u0 = rng.normal(0.0, 0.7, (12, 3)).astype(np.float32)
    lo, w = np.zeros(3, np.float32), np.ones(3, np.float32)
    ju = jh.hmc_warmup_core(jax.random.PRNGKey(0), None, lo, w,
                            jnp.asarray(u0), nwarmup, 8, 0.8)
    tu = th.hmc_warmup_core(None, _t32(lo), _t32(w), torch.tensor(u0),
                            nwarmup, 8, 0.8, seed=5)
    np.testing.assert_allclose(float(tu[4]), float(ju[5]), rtol=1e-6)
    np.testing.assert_allclose(tu[5].numpy(), np.asarray(ju[6]), rtol=1e-5)
    np.testing.assert_allclose(tu[0].numpy(), np.asarray(ju[1]), rtol=1e-5,
                               atol=1e-6)
    assert tu[6] == max(nwarmup, 0)             # the stream position
    if nwarmup >= 4:
        assert not np.allclose(tu[5].numpy(), 1.0)


@pytest.mark.parametrize("case", ["infinite", "zero", "thin"])
def test_hmc_sample_refusals_match_jax(case):
    jl, tl = _gauss()
    x0 = np.tile(MEAN, (4, 1)).astype(np.float32)
    lo = LOWER.copy()
    kw = {"nwarmup": 10, "nsteps": 10}
    if case == "infinite":
        lo[0] = -np.inf
    elif case == "zero":
        kw["nsteps"] = 0
    else:
        kw["thin"] = 3
    with pytest.raises(ValueError) as want:
        jh.hmc_sample(jl, lo, UPPER, x0, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError) as got:
        th.hmc_sample(tl, lo, UPPER, x0, 0, **kw)
    assert str(got.value) == str(want.value)


# -- twins of tests/test_hmc.py -------------------------------------------------

_GAUSS_RUNS = {}


def _run_gauss(seed=0, nchains=32, nwarmup=300, nsteps=600):
    k = (seed, nchains, nwarmup, nsteps)
    if k not in _GAUSS_RUNS:
        _, tl = _gauss()
        rng = np.random.default_rng(seed + 100)
        x0 = (MEAN + 0.1 * SIG * rng.standard_normal((nchains, 3)))
        _GAUSS_RUNS[k] = th.hmc_sample(tl, LOWER, UPPER, x0.astype(
            np.float32), seed, nwarmup=nwarmup, nsteps=nsteps)
    return _GAUSS_RUNS[k]


def test_gaussian_moments():
    res = _run_gauss()
    flat = res.chain.double().numpy().reshape(-1, 3)
    assert np.all(np.abs(flat.mean(axis=0) - MEAN) < 0.08 * SIG)
    np.testing.assert_allclose(flat.std(axis=0), SIG, rtol=0.08)
    # the adapted metric follows the (logit-warped) posterior scales: each
    # box is +/-12 sigma, so the three have one u-space scale (the JAX
    # test's ordering of them is its stream's noise) far below 1
    assert np.all(res.mass > 10.0)
    assert res.mass.max() < 1.5 * res.mass.min()


def test_acceptance_near_target():
    af = _run_gauss().acceptance_fraction
    assert 0.6 < af.mean() < 0.95
    assert af.min() > 0.3


def test_determinism_bitwise():
    c1 = _run_gauss(seed=5, nwarmup=60, nsteps=60).chain
    _GAUSS_RUNS.clear()
    c2 = _run_gauss(seed=5, nwarmup=60, nsteps=60).chain
    c3 = _run_gauss(seed=6, nwarmup=60, nsteps=60).chain
    assert torch.equal(c1, c2)
    assert not torch.equal(c1, c3)


def test_thin_and_shapes():
    assert _run_gauss(nsteps=100, nwarmup=40).chain.shape == (100, 32, 3)
    _, tl = _gauss()
    x0 = np.tile(MEAN, (8, 1)).astype(np.float32)
    res = th.hmc_sample(tl, LOWER, UPPER, x0, 0, nwarmup=50, nsteps=60,
                        thin=3, n_leapfrog=4)
    assert res.chain.shape == (20, 8, 3)
    assert res.lnprob.shape == (20, 8)


def _mbb_data(S=1, seed=11, T=(32.0,), fn=(40.0,)):
    rng = np.random.default_rng(seed)
    wave = np.array([250.0, 350.0, 500.0, 850.0, 1100.0])
    flux = np.stack([ModifiedBlackbody(
        T=T[i], beta=1.9, lambda0=250.0, alpha=2.0, fnorm=fn[i],
        opthin=True, noalpha=True)(torch.tensor(wave, dtype=torch.float32))
        .double().numpy() for i in range(S)])
    unc = 0.05 * flux
    return wave, flux + rng.normal(0.0, unc), unc


def _mock_fit(seed, nwalkers=64):
    wave, flux, unc = _mbb_data()
    f = T.MBBFitter(nwalkers=nwalkers, opthin=True, noalpha=True, seed=seed,
                    device="cpu")
    f.set_data(wave, flux[0], unc[0])
    return f


def test_run_hmc_matches_stretch_posterior():
    """HMC and the stretch move target the same posterior: medians and
    widths of a 3-parameter thin fit agree within MC error."""
    fh = _mock_fit(seed=3).run_hmc(nwarmup=200, nsteps=400, nchains=32,
                                   n_leapfrog=8)
    fs = _mock_fit(seed=4).run(nburn=300, nsteps=800)
    rh, rs = T.MBBResults(fit=fh), T.MBBResults(fit=fs)
    for p in ("T", "beta", "fnorm"):
        ch, cs = rh.par_cen(p), rs.par_cen(p)
        assert abs(ch[0] - cs[0]) < 0.35 * (cs[1] + cs[2]), p
        np.testing.assert_allclose(ch[1] + ch[2], cs[1] + cs[2], rtol=0.30,
                                   err_msg=p)
    assert 0.5 < fh.acceptance_fraction.mean() < 0.95


def test_run_hmc_downstream_analysis():
    f = _mock_fit(seed=9)
    f.run_hmc(nwarmup=120, nsteps=200, nchains=16, thin=2, n_leapfrog=8)
    assert f.chain_free.shape == (100, 16, 3)
    r = T.MBBResults(fit=f)
    assert r.nwalkers == 16 and r.chain.shape[0] == 16
    assert np.isfinite(r.best_fit[1])
    assert np.all(np.isfinite(f.gelman_rubin()))
    assert np.all(np.isfinite(f.autocorrelation_time()))
    with pytest.raises(RuntimeError, match="run_hmc"):
        f.extend(100)
    with pytest.raises(ValueError, match="n_ensembles > 1 applies"):
        T.MBBFitter(nwalkers=16, n_ensembles=2, device="cpu").run_hmc()


def test_run_hmc_uplims_and_covariance():
    """HMC differentiates through the one-sided upper-limit penalty and the
    covariance whitening; posteriors stay finite and constrained."""
    rng = np.random.default_rng(21)
    wave, flux, unc = _mbb_data()
    flux, unc = flux[0], 0.05 * flux[0]
    cov = np.diag(unc ** 2) + 0.2 * np.outer(unc, unc) * (1 - np.eye(5))
    flux = flux + rng.multivariate_normal(np.zeros(5), cov)
    flux[4] = 0.5 * flux[4]
    f = T.MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=6,
                    device="cpu")
    f.set_data(wave, flux, unc, cov=cov)
    f.set_phot_upperlimits([False, False, False, False, True])
    f.run_hmc(nwarmup=150, nsteps=250, nchains=24, n_leapfrog=8)
    assert 0.3 < f.acceptance_fraction.mean() <= 1.0
    c = T.MBBResults(fit=f).par_cen("T")
    assert np.all(np.isfinite(c)) and c[0] > 0


def _mock_batch(S=3, seed=7, nwalkers=32):
    wave, flux, unc = _mbb_data(S, seed, np.linspace(26.0, 34.0, S),
                                np.linspace(30.0, 55.0, S))
    mf = T.MultiFitter(nwalkers=nwalkers, opthin=True, noalpha=True,
                       device="cpu")
    mf.set_uplim("T", 80.0)
    mf.set_data(wave, flux, unc)
    return mf


def test_multifit_run_hmc_matches_plain_run():
    """Batched HMC targets each source's own posterior, each source with
    its own step size and metric."""
    mh = _mock_batch(seed=7).run_hmc(nwarmup=200, nsteps=400, n_leapfrog=8)
    assert mh.chain_free.shape == (3, 400, 32, 3)
    assert mh.acceptance_fraction.shape == (3, 32)
    assert 0.5 < mh.acceptance_fraction.mean() < 0.95
    assert mh.hmc_step_size.shape == (3,) and mh.hmc_mass.shape == (3, 3)
    assert np.all(mh.hmc_step_size > 0)
    assert len(np.unique(mh.hmc_step_size)) == 3
    ms = _mock_batch(seed=7).run(nburn=300, nsteps=700)
    for p in ("T", "fnorm"):
        ch, cs = mh.par_cen(p), ms.par_cen(p)
        assert np.all(np.abs(ch[:, 0] - cs[:, 0])
                      < 0.45 * (cs[:, 1] + cs[:, 2])), p
        np.testing.assert_allclose(ch[:, 1] + ch[:, 2], cs[:, 1] + cs[:, 2],
                                   rtol=0.35, err_msg=p)


def test_multifit_run_hmc_downstream(tmp_path):
    mf = _mock_batch(seed=11, nwalkers=16)
    mf.run_hmc(nwarmup=120, nsteps=150, thin=3, n_leapfrog=8)
    assert mf.chain_free.shape == (3, 50, 16, 3)
    assert np.all(np.isfinite(mf.gelman_rubin()))
    assert np.all(np.isfinite(mf.autocorrelation_time()))
    with pytest.raises(RuntimeError, match="extend"):
        mf.extend(100)
    r0 = mf.results(0, redshift=1.5)
    assert np.isfinite(r0.par_cen("T")[0])
    path = str(tmp_path / "batch_hmc.h5")
    mf.writeToHDF5(path)
    back = T.MultiFitter.from_h5(path, device="cpu")
    assert back.chain_free.shape == mf.chain_free.shape
    np.testing.assert_array_equal(back.hmc_step_size, mf.hmc_step_size)
    np.testing.assert_array_equal(back.hmc_mass, mf.hmc_mass)
    mf.run_pt(nrungs=4, beta_min=1e-2, nburn=5, nsteps=5)
    assert mf.hmc_step_size is None and mf.hmc_mass is None
