"""Parallel tempering in the port (mbb_emcee_tpu_torch/tempering.py) against
the JAX package on the CPU: the ladders, the stepping-stone accumulators and
the thermodynamic integration exactly or to rounding, the tempered step
replayed from JAX's own draws (a boxed Gaussian over 5 steps, configs 0-3
of tools/validate_tpu_parity.py over one), the same refusals with the same
messages; the Philox streams of the tempered and HMC runs; then the port's
twins of tests/test_tempering.py (single fit and batch, without the mesh
and trace-count cases), with their cross-checks against the port's nested
sampling (nested.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import tempering as jt  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch import tempering as tt  # noqa: E402
from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    ModifiedBlackbody)
from mbb_emcee_tpu_torch.ops import philox  # noqa: E402
from mbb_emcee_tpu_torch.sampler import EnsembleSampler  # noqa: E402
from tools import validate_tpu_parity as vp  # noqa: E402

MU = np.array([1.0, -0.5, 2.0])
SIG = np.array([0.4, 0.8, 0.25])
LOWER = MU - 6.0 * SIG
UPPER = MU + 6.0 * SIG
LNV = float(np.sum(np.log(UPPER - LOWER)))
FLOOR = -1e30


def _t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _boxed_gauss(mu=MU, sig=SIG, lower=LOWER, upper=UPPER):
    """(JAX scalar lnprob, port batched lnprob) of a normalized Gaussian in
    a box, the same fp32 formula in both."""
    lognorm = float(np.sum(np.log(np.asarray(sig) * np.sqrt(2 * np.pi))))
    jm, js, jlo, jhi = (jnp.asarray(a, jnp.float32)
                        for a in (mu, sig, lower, upper))
    tm, ts, tlo, thi = (_t32(a) for a in (mu, sig, lower, upper))

    def jl(x):
        inbox = jnp.all((x >= jlo) & (x <= jhi))
        lnl = -0.5 * jnp.sum(((x - jm) / js) ** 2) - lognorm
        return jnp.where(inbox, lnl, jnp.float32(FLOOR))

    def tl(x):
        inbox = torch.all((x >= tlo) & (x <= thi), dim=-1)
        lnl = -0.5 * torch.sum(((x - tm) / ts) ** 2, dim=-1) - lognorm
        return torch.where(inbox, lnl, torch.full_like(lnl, FLOOR))

    return jl, tl


def _ball(seed, center, scatter, n):
    rng = np.random.default_rng(seed)
    return (np.asarray(center) + np.asarray(scatter)
            * rng.standard_normal((n, len(center)))).astype(np.float32)


# -- numpy helpers, exactly --------------------------------------------------

@pytest.mark.parametrize("nrungs,beta_min", [(3, 0.5), (8, 1e-3),
                                             (12, 2.7e-7)])
def test_geometric_ladder_matches_jax(nrungs, beta_min):
    np.testing.assert_array_equal(tt.geometric_ladder(nrungs, beta_min),
                                  jt.geometric_ladder(nrungs, beta_min))


@pytest.mark.parametrize("worst", [-0.3, -54.0, -3.1e4, -1.5e10, -1e40])
def test_auto_ladders_match_jax(worst):
    np.testing.assert_array_equal(tt.auto_ladder(worst, nrungs_min=6),
                                  jt.auto_ladder(worst, nrungs_min=6))
    w = np.array([worst, worst / 7.0, -2.0])
    np.testing.assert_array_equal(tt.auto_ladder_batch(w, nrungs_min=5),
                                  jt.auto_ladder_batch(w, nrungs_min=5))


def test_thermodynamic_logz_and_ssstats_match_jax():
    rng = np.random.default_rng(4)
    b = jt.geometric_ladder(9, 1e-4)
    m = -np.abs(rng.normal(3.0, 40.0, (4, 9)))
    for got, want in zip(tt.thermodynamic_logz(b, m),
                         jt.thermodynamic_logz(b, m)):
        np.testing.assert_array_equal(got, want)
    parts = [(rng.normal(-5, 3, (4, 8)), rng.uniform(1, 9, (4, 8)),
              rng.uniform(1, 90, (4, 8)), float(n)) for n in (64, 128)]
    tm = tt.SSStats(*parts[0]).merge(tt.SSStats(*parts[1]))
    jm = jt.SSStats(*parts[0]).merge(jt.SSStats(*parts[1]))
    for a, b2 in zip(tm, jm):
        np.testing.assert_allclose(a, b2, rtol=1e-12)
    for a, b2 in zip(tm.logz(), jm.logz()):
        np.testing.assert_allclose(a, b2, rtol=1e-12)


def test_ss_stream_update_matches_jax():
    rng = np.random.default_rng(5)
    dbeta = np.array([0.5, 0.1, 0.02], np.float32)
    m = np.array([-np.inf, -3.0, -1.0], np.float32)
    s1 = np.array([0.0, 2.5, 7.0], np.float32)
    s2 = np.array([0.0, 1.5, 3.0], np.float32)
    lnp = rng.normal(-20.0, 8.0, (3, 16)).astype(np.float32)
    got = tt.ss_stream_update(*(_t32(a) for a in (m, s1, s2, dbeta, lnp)))
    want = jt.ss_stream_update(*(jnp.asarray(a) for a in (m, s1, s2, dbeta,
                                                          lnp)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# -- the tempered step from JAX's draws --------------------------------------

def _jax_draws(key, K, W):
    """The draws jax tempering.pt_step makes from `key`, and its next key."""
    key, km, ks = jax.random.split(key, 3)
    u = jax.random.uniform(km, (3, K, W), dtype=jnp.float32)
    us = jax.random.uniform(ks, (K - 1, W), dtype=jnp.float32)
    return key, torch.tensor(np.asarray(u)), torch.tensor(np.asarray(us))


def _states(p0, jl, tl):
    K, W, _ = p0.shape
    jb = jax.vmap(jl)
    js = jt.PTState(
        key=jax.random.PRNGKey(3), pos=jnp.asarray(p0),
        lnp=jb(jnp.asarray(p0).reshape(K * W, -1)).reshape(K, W),
        naccept=jnp.zeros((K, W), jnp.int32),
        nswap=jnp.zeros(K - 1, jnp.int32),
        nswap_prop=jnp.zeros(K - 1, jnp.int32),
        nsteps=jnp.array(0, jnp.int32))
    return jb, js, tt.init_pt_state(torch.as_tensor(p0), tl, seed=0)


def _close(tstate, jstate, rtol=2e-5):
    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(jstate.pos),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(tstate.lnp.numpy(), np.asarray(jstate.lnp),
                               rtol=rtol, atol=1e-4)
    for k in ("naccept", "nswap", "nswap_prop"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)))


def test_tempered_half_matches_jax():
    jl, tl = _boxed_gauss()
    K, W = 4, 16
    p0 = np.stack([_ball(10 + k, MU, SIG, W) for k in range(K)])
    jb, js, ts = _states(p0, jl, tl)
    _, u, _ = _jax_draws(jax.random.PRNGKey(8), K, W)
    betas = jt.geometric_ladder(K, 0.05).astype(np.float32)
    h = W // 2
    got = tt._tempered_half(u[..., :h], ts.pos[:, :h], ts.pos[:, h:],
                            ts.lnp[:, :h], tl, _t32(betas), 2.0)
    want = jt._tempered_half(jnp.asarray(u.numpy())[..., :h], js.pos[:, :h],
                             js.pos[:, h:], js.lnp[:, :h], jb,
                             jnp.asarray(betas), 2.0)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_pt_step_replays_jax_on_a_boxed_gaussian():
    """Five tempered steps (K=4, W=16) from JAX's own draws: positions and
    lnprob at rtol 2e-5, accept and swap counts equal."""
    jl, tl = _boxed_gauss()
    K, W = 4, 16
    p0 = np.stack([_ball(20 + k, MU, (k + 1) * SIG, W) for k in range(K)])
    jb, js, ts = _states(p0, jl, tl)
    betas = jt.geometric_ladder(K, 0.05).astype(np.float32)
    key = js.key
    for i in range(5):
        key, u, us = _jax_draws(key, K, W)
        js = jt.pt_step(js, jb, jnp.asarray(betas), 2.0, swap_parity=i)
        ts = tt.pt_step_from_uniforms(ts, tl, _t32(betas), u, us, 2.0)
        assert ts.nsteps == i + 1
        _close(ts, js)
    assert int(js.nswap.sum()) > 0 and int(js.naccept.sum()) > 0


def _decisions(state, lnprob, betas, u, us, a=2.0):
    """The port's accept decisions of one step (half-step accepts (K, W),
    swap accepts (K-1, W)) and their margins log(u) - threshold."""
    K, W, d = state.pos.shape
    h = W // 2
    pos, lnp = state.pos, state.lnp.clone()
    acc, marg, new = [], [], []
    for act in (slice(0, h), slice(h, W)):
        u3 = u[..., act]
        passive = pos[:, h:] if act.start == 0 else new[0]
        active = pos[:, act]
        z = ((a - 1.0) * u3[0] + 1.0) ** 2 / a
        j = torch.clamp((u3[1] * h).to(torch.int64), max=h - 1)
        prop = (torch.take_along_dim(passive, j[..., None], dim=-2)
                + z[..., None] * (active - torch.take_along_dim(
                    passive, j[..., None], dim=-2)))
        lp = lnprob(prop.reshape(-1, d)).reshape(K, h)
        ratio = (d - 1) * torch.log(z) + betas[:, None] * (lp - lnp[:, act])
        ok = (torch.log(u3[2]) < ratio) & (lp > SUPPORT_FLOOR)
        acc.append(ok)
        marg.append(torch.log(u3[2]) - ratio)
        new.append(torch.where(ok[..., None], prop, active))
        lnp[:, act] = torch.where(ok, lp, lnp[:, act])
    _, _, ok_s, _ = tt._swap(torch.cat(new, 1), lnp, betas, us, state.nsteps)
    thr = (betas[:-1] - betas[1:])[:, None] * (lnp[1:] - lnp[:-1])
    return (torch.cat(acc, 1), torch.cat(marg, 1), ok_s,
            torch.log(us) - thr)


@pytest.mark.parametrize("ci", [0, 1, 2, 3])
def test_pt_step_replays_jax_on_parity_configs(ci):
    """One tempered step on configs 0-3's likelihoods from JAX's draws: at
    rtol 2e-5 where every decision agrees; a decision may fall differently
    only within 1e-4 of its threshold."""
    from tests.test_torch_mapfit import _lnprobs
    jl, tl, fs = _lnprobs(ci)
    K, W = 4, 16
    c = vp.TRUE[fs.free_idx]
    p0 = np.stack([_ball(30 + k, c, 0.03 * (k + 1) * np.abs(c), W)
                   for k in range(K)])
    p0 = np.clip(p0, fs.lower, fs.upper).astype(np.float32)
    jb, js, ts = _states(p0, jl, tl)
    betas = jt.geometric_ladder(K, 1e-3).astype(np.float32)
    _, u, us = _jax_draws(js.key, K, W)
    js = jt.pt_step(js, jb, jnp.asarray(betas), 2.0, swap_parity=0)
    acc, marg, ok_s, marg_s = _decisions(ts, tl, _t32(betas), u, us)
    ts = tt.pt_step_from_uniforms(ts, tl, _t32(betas), u, us, 2.0)
    moved = acc.numpy() != np.asarray(js.naccept).astype(bool)
    assert np.all(np.abs(marg.numpy()[moved]) < 1e-4)
    swaps = ok_s.sum(-1).numpy() != np.asarray(js.nswap)
    for k in np.nonzero(swaps)[0]:
        assert np.min(np.abs(marg_s.numpy()[k])) < 1e-4
    if not moved.any() and not swaps.any():
        _close(ts, js)


# -- refusals, with the JAX package's messages -------------------------------

@pytest.mark.parametrize("nwalkers,betas", [
    (32, [0.5, 0.1, 0.0]), (32, [1.0, 0.5, 0.7, 0.0]),
    (33, [1.0, 0.1, 0.0]), (8, list(np.geomspace(1.0, 1e-3, 6)))])
def test_sampler_refusals_match_jax(nwalkers, betas):
    jl, tl = _boxed_gauss()
    with pytest.raises(ValueError) as want:
        jt.ParallelTemperingSampler(nwalkers, 3, jl, betas)
    with pytest.raises(ValueError) as got:
        tt.ParallelTemperingSampler(nwalkers, 3, tl, betas)
    assert str(got.value) == str(want.value)
    p0 = _ball(2, MU, SIG, nwalkers)
    with pytest.raises(ValueError) as want:
        jt.pt_sample(jl, p0, jax.random.PRNGKey(0), betas=betas)
    with pytest.raises(ValueError) as got:
        tt.pt_sample(tl, p0, 0, betas=betas)
    assert str(got.value) == str(want.value)


def test_set_betas_and_run_refusals_match_jax():
    jl, tl = _boxed_gauss()
    b = jt.geometric_ladder(5, 1e-2)
    js = jt.ParallelTemperingSampler(8, 3, jl, b)
    ts = tt.ParallelTemperingSampler(8, 3, tl, b)
    for bad in (jt.geometric_ladder(6, 1e-2), [1.0, 0.5, 0.2, 0.1, 0.05],
                [1.0, 0.6, 0.6, 0.1, 0.0]):
        with pytest.raises(ValueError) as want:
            js.set_betas(bad)
        with pytest.raises(ValueError) as got:
            ts.set_betas(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jt.geometric_ladder(2)
    with pytest.raises(ValueError) as got:
        tt.geometric_ladder(2)
    assert str(got.value) == str(want.value)
    p0 = torch.tensor(np.broadcast_to(_ball(1, MU, SIG, 8), (5, 8, 3)))
    st = ts.init_state(p0, seed=1)
    for n, thin in ((10, 3), (0, 1)):
        with pytest.raises(ValueError) as got:
            ts.run_mcmc(st, n, thin)
        with pytest.raises(ValueError) as want:
            js.run_mcmc(None, n, thin)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="p0 shape"):
        ts.init_state(p0[:3], seed=1)


# -- the Philox streams ------------------------------------------------------

def test_tempered_and_hmc_streams():
    """A source's draws depend on its index, not its batch; a step's draws
    on the step, not the block; the tagged counters (PT, HMC and nested
    sampling) never meet the stretch move's; Box-Muller normals are standard
    normal."""
    key = 0x1234_5678_9ABC
    u, us = philox.pt_uniforms(key, 7, 3, 4, 6, "cpu", source=[2, 5])
    u5, us5 = philox.pt_uniforms(key, 8, 2, 4, 6, "cpu", source=5)
    assert u.shape == (3, 2, 3, 4, 6) and us.shape == (3, 2, 3, 6)
    assert torch.equal(u[1:, 1], u5) and torch.equal(us[1:, 1], us5)
    x = philox.tagged_bits(key, philox.PT_TAG, 0, 2, 8, "cpu")
    c3 = np.array([philox._TAG_BASE + (philox.PT_TAG << 20)])
    assert c3[0] >= 2 ** 31          # stretch_uniforms' word 3 is < 2^31
    s = philox.stretch_uniforms(key, 0, 2, 8, "cpu")
    assert not np.isin(philox.bits_to_uniform(x[0]).numpy(),
                       s.numpy()).any()
    tags = (philox.PT_TAG, philox.HMC_TAG_A, philox.HMC_TAG_B,
            philox.NESTED_TAG)
    assert len(set(tags)) == 4 and philox.NESTED_TAG == 4
    xn = philox.tagged_bits(key, philox.NESTED_TAG, 0, 2, 8, "cpu")
    assert not np.isin(philox.bits_to_uniform(xn[0]).numpy(),
                       s.numpy()).any()
    assert not np.isin(xn[0].numpy(), x[0].numpy()).any()
    nrm, jit, ua = philox.hmc_draws(key, 0, 50, 400, 5, "cpu", source=[0, 1])
    assert nrm.shape == (50, 2, 400, 5) and jit.shape == (50, 2, 400, 1)
    assert ua.shape == (50, 2, 400)
    n = nrm.double().numpy().reshape(-1, 5)
    assert np.all(np.abs(n.mean(0)) < 0.02)
    assert np.all(np.abs(n.std(0) - 1.0) < 0.02)
    assert float(jit.min()) >= 0.8 and float(jit.max()) <= 1.2
    one = philox.hmc_draws(key, 10, 1, 400, 5, "cpu", source=1)
    assert torch.equal(one[0][0], nrm[10, 1])
    _, tl = _boxed_gauss()
    st = tt.init_pt_state(torch.tensor(np.stack(
        [_ball(k, MU, SIG, 6) for k in range(4)])), tl, seed=key, step=9)
    one = tt.pt_step(st, tl, _t32(tt.geometric_ladder(4, 0.1)))
    u9, us9 = philox.pt_uniforms(key, 9, 1, 4, 6, "cpu")
    ref = tt.pt_step_from_uniforms(st, tl, _t32(tt.geometric_ladder(4, 0.1)),
                                   u9[0], us9[0])
    assert torch.equal(one.pos, ref.pos) and one.step == 10
    blocks = list(philox.step_blocks(
        lambda s0, k: philox.pt_uniforms(key, s0, k, 4, 6, "cpu"), 5, 9,
        philox.BLOCK_ELEMS // 2))
    whole = philox.pt_uniforms(key, 5, 9, 4, 6, "cpu")
    assert all(torch.equal(b[0], whole[0][t]) for t, b in enumerate(blocks))


# -- twins of tests/test_tempering.py ----------------------------------------

def test_cold_chain_moments_and_swaps():
    _, tl = _boxed_gauss()
    res = tt.pt_sample(tl, _ball(1, MU, 0.1 * SIG, 64), seed=0, nrungs=10,
                       nburn=300, nsteps=1200)
    flat = res.chain.double().numpy().reshape(-1, 3)
    assert np.all(np.abs(flat.mean(axis=0) - MU) < 0.1 * SIG)
    np.testing.assert_allclose(flat.std(axis=0), SIG, rtol=0.1)
    assert np.all(res.swap_fraction > 0.05)
    assert 0.1 < res.acceptance_fraction.mean() < 0.9


def test_evidence_analytic():
    """lnZ against the normalized uniform box prior is -ln V for a
    normalized Gaussian well inside the box: stepping stone within
    max(3 x err, 0.15 nats), thermodynamic integration within its own
    discretization bound, and the nested sampler agrees with stepping
    stone (tests/test_tempering.py's test_evidence_analytic_and_vs_nested)."""
    from mbb_emcee_tpu_torch.nested import nested_sample
    _, tl = _boxed_gauss()
    res = tt.pt_sample(tl, _ball(3, MU, 0.1 * SIG, 64), seed=2, nrungs=16,
                       nburn=300, nsteps=1500)
    assert abs(res.logz - (-LNV)) < max(0.15, 3.0 * res.logz_err)
    assert abs(res.logz_ti - (-LNV)) < max(0.35, 3.0 * res.logz_ti_err)
    rn = nested_sample(tl, LOWER, UPPER, 4, nlive=400, nbatch=32, nsteps=24,
                       device="cpu")
    assert abs(res.logz - rn.logz) < max(
        0.4, 3.0 * np.hypot(res.logz_err, rn.logz_err))


def test_evidence_wide_prior():
    """A sharp Gaussian (sigma 1e-3) in a +/-100 box: prior-corner lnL of
    order -1e10, which a fixed beta_min = 1e-3 ladder cannot bridge. The
    auto ladder must extend far below it and recover -ln V."""
    d = 3
    lo, hi = -100.0, 100.0
    lnz_true = -d * np.log(hi - lo)
    _, tl = _boxed_gauss(np.zeros(d), np.full(d, 1e-3), np.full(d, lo),
                         np.full(d, hi))
    res = tt.pt_sample(tl, _ball(13, np.zeros(d), np.full(d, 1e-4), 64),
                       seed=14, nburn=500, nsteps=1200)
    assert res.betas[-2] < 1e-6
    assert res.betas.size > 12
    assert abs(res.logz - lnz_true) < max(0.15, 3.0 * res.logz_err), (
        res.logz, lnz_true, res.logz_err)


def _bimodal(sep=8.0):
    s, c = 0.5, sep / 2.0

    def lnprob(x):
        inbox = torch.all((x >= -12.0) & (x <= 12.0), dim=-1)
        a = -0.5 * ((x[..., 0] - c) ** 2 + x[..., 1] ** 2) / s ** 2
        b = -0.5 * ((x[..., 0] + c) ** 2 + x[..., 1] ** 2) / s ** 2
        return torch.where(inbox, torch.logaddexp(a, b),
                           torch.full_like(a, FLOOR))

    return lnprob


def test_bimodal_mixing_beats_cold_stretch():
    """Started in ONE mode of a well-separated bimodal target, the plain
    stretch ensemble stays trapped while parallel tempering recovers both
    modes at ~equal mass."""
    lnprob = _bimodal(sep=8.0)
    p0 = np.array([4.0, 0.0], np.float32) + 0.3 * _ball(5, [0, 0], [1, 1],
                                                         64)
    samp = EnsembleSampler(64, 2, lnprob)
    st = samp.advance(samp.init_state(torch.as_tensor(p0), seed=6), 300)
    _, chain, _ = samp.run_mcmc(st, 1500)
    assert float((chain[..., 0] < 0).double().mean()) < 0.05
    res = tt.pt_sample(lnprob, p0, seed=7, nrungs=10, beta_min=3e-3,
                       nburn=400, nsteps=1500)
    frac = float((res.chain[..., 0] < 0).double().mean())
    assert 0.30 < frac < 0.70, frac


def test_determinism():
    _, tl = _boxed_gauss()
    p0 = _ball(8, MU, 0.1 * SIG, 32)

    def run(seed):
        return tt.pt_sample(tl, p0, seed=seed, nrungs=6, nburn=50,
                            nsteps=100)

    r1, r2, r3 = run(11), run(11), run(12)
    assert torch.equal(r1.chain, r2.chain)
    assert r1.logz_ti == r2.logz_ti and r1.logz == r2.logz
    assert not torch.equal(r1.chain, r3.chain)


def test_ladder_and_validation():
    b = tt.geometric_ladder(8, 1e-3)
    assert b[0] == 1.0 and b[-1] == 0.0 and b.size == 8
    assert np.all(np.diff(b) < 0)
    lz, _ = tt.thermodynamic_logz(b, np.full(8, -3.0))
    np.testing.assert_allclose(lz, -3.0, rtol=1e-12)
    m = np.full(8, -3.0)
    m[::2] += 1.0
    _, err_osc = tt.thermodynamic_logz(b, m)
    per = np.abs(np.diff(b[::-1]) * 0.5 * np.diff(m[::-1])).sum() / 2.0
    np.testing.assert_allclose(err_osc, per, rtol=1e-12)
    assert err_osc > 0.05


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


def test_run_pt_matches_stretch_posterior():
    """PT's cold rung and the plain stretch ensemble sample the same
    posterior: medians and widths of a 3-parameter thin fit agree within
    MC error, and PT's stepping-stone evidence agrees with the nested
    sampler's. The nested run takes 96 constrained steps per iteration
    where the JAX package's twin takes 24: on this fit's default box (fnorm
    up to 1e7) 24 steps under-mix, and a run now and then loses a nat or
    two of evidence, in both packages."""
    fp = _mock_fit(seed=3).run_pt(nrungs=8, nburn=250, nsteps=600)
    fs = _mock_fit(seed=4).run(nburn=300, nsteps=800)
    rp, rs = T.MBBResults(fit=fp), T.MBBResults(fit=fs)
    for p in ("T", "beta", "fnorm"):
        cp, cs = rp.par_cen(p), rs.par_cen(p)
        assert abs(cp[0] - cs[0]) < 0.35 * (cs[1] + cs[2]), p
        np.testing.assert_allclose(cp[1] + cp[2], cs[1] + cs[2], rtol=0.30,
                                   err_msg=p)
    assert np.isfinite(fp.logz_pt[0]) and fp.logz_pt[1] > 0
    lz, lz_err = fp.logz_pt
    ev = fs.compute_evidence(nlive=256, nbatch=32, nsteps=96)
    assert abs(lz - ev.logz) < max(1.0, 3.0 * np.hypot(lz_err, ev.logz_err))


def test_run_pt_downstream_analysis():
    f = _mock_fit(seed=9)
    f.run_pt(nrungs=6, nburn=100, nsteps=200, nchains=16, thin=2)
    assert f.chain_free.shape == (100, 16, 3)
    r = T.MBBResults(fit=f)
    assert r.nwalkers == 16 and np.isfinite(r.best_fit[1])
    assert r.logz_pt == f.logz_pt and r.logz_ti == f.logz_ti
    assert np.all(np.isfinite(f.gelman_rubin()))
    assert np.all(np.isfinite(f.autocorrelation_time()))
    assert np.all(f.pt_result.swap_fraction >= 0)
    with pytest.raises(RuntimeError, match="run_pt"):
        f.extend(100)
    f.run(nburn=10, nsteps=10)         # a stretch run drops PT's evidence
    assert f.logz_pt is None and T.MBBResults(fit=f).logz_pt is None


def test_run_pt_takes_every_proposal_through_the_lnprob_wrapper(
        monkeypatch):
    """run_pt evaluates through ops.lnprob_kernel.mbb_lnprob (K1 on a CUDA
    device): 2 calls per tempered step plus one per ladder start; on the
    CPU the wrapper runs the plain likelihood. n_ensembles > 1 and a bad
    p0 are refused as in the JAX package."""
    from mbb_emcee_tpu_torch.ops import lnprob_kernel
    calls = []
    orig = lnprob_kernel.mbb_lnprob
    monkeypatch.setattr(lnprob_kernel, "mbb_lnprob",
                        lambda x, ops, *a, **k: calls.append(x.shape[0])
                        or orig(x, ops, *a, **k))
    f = _mock_fit(seed=5, nwalkers=16)
    f.run_pt(nrungs=4, beta_min=1e-2, nburn=20, nsteps=30)
    assert calls == [4 * 16] + [4 * 8] * (2 * 50)
    calls.clear()
    f.run_pt(nrungs=4, nburn=20, nsteps=30)            # auto: K grows
    K = f.pt_result.betas.size
    assert K > 4 and calls.count(K * 16) == 1 and calls.count(4 * 16) == 1
    assert len(calls) == 2 + 2 * (20 + 50 + 30)
    full = np.tile([30.0, 1.9, 250.0, 2.0, 40.0], (16, 1))
    calls.clear()
    f.run_pt(nrungs=4, beta_min=1e-2, nburn=0, nsteps=2, p0=full)
    assert calls[0] == 4 * 16
    with pytest.raises(ValueError, match="n_ensembles > 1 applies"):
        T.MBBFitter(nwalkers=16, n_ensembles=2, device="cpu").run_pt()


def _mock_batch(S=3, seed=7, nwalkers=64):
    wave, flux, unc = _mbb_data(S, seed, np.linspace(25.0, 38.0, S),
                                np.linspace(30.0, 55.0, S))
    mf = T.MultiFitter(nwalkers=nwalkers, opthin=True, noalpha=True,
                       device="cpu")
    mf.set_data(wave, flux, unc)
    return mf


def test_multifit_run_pt_matches_plain_run():
    """Batched PT cold chains target each source's own posterior, with
    per-source auto ladders ending at beta = 0, and each source's
    stepping-stone lnZ agrees with the batch's nested-sampling evidence."""
    mp = _mock_batch(seed=7).run_pt(nrungs=8, nburn=200, nsteps=500)
    assert mp.chain_free.shape == (3, 500, 64, 3)
    assert mp.acceptance_fraction.shape == (3, 64)
    assert np.all(mp.swap_fraction > 0.02)
    ms = _mock_batch(seed=7).run(nburn=250, nsteps=700)
    for p in ("T", "fnorm"):
        cp, cs = mp.par_cen(p), ms.par_cen(p)
        assert np.all(np.abs(cp[:, 0] - cs[:, 0])
                      < 0.4 * (cs[:, 1] + cs[:, 2])), p
    assert np.all(np.isfinite(mp.logz_pt[0]))
    lz, lz_err = mp.logz_pt
    ev = ms.compute_evidence(nlive=256, nbatch=32, nsteps=24)
    assert np.all(np.abs(lz - ev.logz)
                  < np.maximum(1.5, 4.0 * np.hypot(lz_err, ev.logz_err)))
    assert mp.pt_betas.shape[0] == 3
    assert np.all(mp.pt_betas[:, -1] == 0.0)
    assert np.all(mp.pt_betas[:, 0] == 1.0)
    assert len(np.unique(mp.pt_betas[:, -2])) == 3


def test_multifit_run_pt_downstream_and_persistence(tmp_path):
    mf = _mock_batch(seed=11, nwalkers=16)
    mf.run_pt(nrungs=6, nburn=80, nsteps=150, thin=3)
    assert mf.chain_free.shape == (3, 50, 16, 3)
    assert np.all(np.isfinite(mf.gelman_rubin()))
    assert np.all(np.isfinite(mf.autocorrelation_time()))
    with pytest.raises(RuntimeError, match="extend"):
        mf.extend(100)
    r0 = mf.results(0, redshift=1.5)
    assert r0.logz_pt == (mf.logz_pt[0][0], mf.logz_pt[1][0])
    path = str(tmp_path / "batch_pt.h5")
    mf.writeToHDF5(path)
    back = T.MultiFitter.from_h5(path, device="cpu")
    np.testing.assert_array_equal(back.logz_pt[0], mf.logz_pt[0])
    np.testing.assert_array_equal(back.logz_ti[1], mf.logz_ti[1])
    np.testing.assert_array_equal(back.pt_betas, mf.pt_betas)
    np.testing.assert_array_equal(back.swap_fraction, mf.swap_fraction)
    mf.run(nburn=5, nsteps=5)          # a stretch run drops PT's results
    assert mf.logz_pt is None and mf.pt_betas is None


def test_multifit_run_pt_different_nrungs_and_fixed_beta_min():
    wave = np.array([250.0, 350.0, 500.0])
    rng = np.random.default_rng(3)
    flux = np.array([[30.0, 25.0, 15.0], [50.0, 42.0, 26.0]])
    unc = 0.06 * flux
    flux = flux + unc * rng.standard_normal(flux.shape)
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=5,
                       device="cpu")
    mf.set_data(wave, flux, unc)
    mf.run_pt(nrungs=4, beta_min=1e-2, nburn=10, nsteps=20)
    lz4 = np.array(mf.logz_pt[0])
    np.testing.assert_array_equal(mf.pt_betas,
                                  np.tile(tt.geometric_ladder(4, 1e-2),
                                          (2, 1)))
    mf.run_pt(nrungs=6, beta_min=1e-2, nburn=10, nsteps=20)
    assert mf.pt_betas.shape == (2, 6)
    assert np.all(np.isfinite(mf.logz_pt[0])) and np.all(np.isfinite(lz4))
    with pytest.raises(ValueError, match="zero recorded"):
        mf.run_pt(nsteps=0, thin=1)
