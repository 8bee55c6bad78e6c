"""The port's stretch-move sampler (the plain version of the stretch-move
kernel) against the JAX package's: a replay on shared uniforms, the walker
ball's reflection, the convergence diagnostics on one shared chain, and the
Philox stream the kernel and the plain sampler share."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu.likelihood import (  # noqa: E402
    LikelihoodSpec as JSpec, Photometry as JPhotometry,
    build_lnprob as j_build_lnprob)
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
from mbb_emcee_tpu_torch import sampler as tsampler  # noqa: E402
from mbb_emcee_tpu_torch.convert import (  # noqa: E402
    photometry_from_arrays, spec_from_reference, state_from_arrays)
from mbb_emcee_tpu_torch.likelihood import build_lnprob  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape)
from mbb_emcee_tpu_torch.ops.philox import (  # noqa: E402
    philox4x32, stretch_uniforms)
from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler  # noqa: E402

NW = 64
WAVE = np.linspace(100.0, 500.0, 5)
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
FLUX = np.array([8.62, 23.3, 41.2, 44.6, 45.0])


def _problem(opthin=False, noalpha=False):
    unc = 0.05 * FLUX
    rng = np.random.default_rng(7)
    jphot = JPhotometry(WAVE, FLUX + unc * rng.standard_normal(5), unc)
    jspec = JSpec.default()
    jspec.upper[0] = 100.0
    jspec.upper[1] = 5.0
    if opthin:
        jspec.fixed[2], jspec.fixed_values[2] = True, 250.0
    if noalpha:
        jspec.fixed[3], jspec.fixed_values[3] = True, 3.5
    return jphot, JShape(opthin=opthin, noalpha=noalpha), jspec


def _jax_replay(uniforms, p0, lnprob_batch):
    """tests/test_pallas_sampler.py's replay: per step half A against half
    B (rows 0-2), then half B against the NEW half A (rows 3-5)."""
    half = p0.shape[0] // 2
    pos_a, pos_b = jnp.asarray(p0[:half]), jnp.asarray(p0[half:])
    lnp = lnprob_batch(jnp.asarray(p0))
    lnp_a, lnp_b = lnp[:half], lnp[half:]
    nrec, nthin6, _ = uniforms.shape
    chain, lnpchain, nacc = [], [], np.zeros(2 * half, np.int64)
    for r in range(nrec):
        for t in range(nthin6 // 6):
            u = uniforms[r, 6 * t:6 * t + 6]
            pos_a, lnp_a, acc_a = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(u[0:3]), pos_a, pos_b, lnp_a, lnprob_batch)
            pos_b, lnp_b, acc_b = jsampler.stretch_half_step_from_uniforms(
                jnp.asarray(u[3:6]), pos_b, pos_a, lnp_b, lnprob_batch)
            nacc += np.concatenate([np.asarray(acc_a), np.asarray(acc_b)])
        chain.append(np.concatenate([np.asarray(pos_a), np.asarray(pos_b)]))
        lnpchain.append(np.concatenate([np.asarray(lnp_a),
                                        np.asarray(lnp_b)]))
    return np.stack(chain), np.stack(lnpchain), nacc


@pytest.mark.parametrize("opthin,noalpha", [(False, False), (False, True),
                                            (True, True)],
                         ids=["full5", "thick4", "thin3"])
def test_replay_matches_jax_stretch_move(opthin, noalpha):
    """64 walkers, 3 records x thin 2 on shared uniforms: same chain, lnp
    (rtol 2e-5) and accept counts as the JAX stretch move; the
    kernel-sampler class dispatches CPU tensors to the same plain run."""
    jphot, jshape, jspec = _problem(opthin, noalpha)
    j_fn, fs = j_build_lnprob(jphot, jshape, jspec)
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc)
    shape = MBBShape(opthin=opthin, noalpha=noalpha)
    spec = spec_from_reference(jspec)
    rng = np.random.default_rng(11)
    c = TRUE[fs.free_idx]
    p0 = (c + 0.05 * c * rng.standard_normal((NW, c.size))).astype(
        np.float32)
    nrec, thin, half = 3, 2, NW // 2
    u = rng.uniform(0.001, 0.999, (nrec, 6 * thin, half)).astype(np.float32)

    ref_chain, ref_lnp, ref_nacc = _jax_replay(u, p0,
                                               jax.jit(jax.vmap(j_fn)))
    t_fn, _ = build_lnprob(phot, shape, spec)
    sampler = tsampler.EnsembleSampler(NW, fs.nfree, t_fn)
    state = sampler.init_state(torch.as_tensor(p0), seed=1)
    state, chain, lnp = sampler.run_mcmc(state, nrec * thin, thin,
                                         uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(chain.numpy(), ref_chain, rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lnp.numpy(), ref_lnp, rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(state.naccept.numpy(), ref_nacc)
    np.testing.assert_allclose(state.position.numpy(), ref_chain[-1],
                               rtol=2e-5, atol=1e-5)
    assert state.nsteps == nrec * thin

    fused = FusedSampler(NW, phot, shape, spec, rng="external",
                         device="cpu")
    fstate = fused.init_state(torch.as_tensor(p0), seed=1)
    fstate, fchain, flnp = fused.run_mcmc(fstate, nrec * thin, thin,
                                          uniforms=torch.as_tensor(u))
    assert torch.equal(fchain, chain) and torch.equal(flnp, lnp)


def test_state_from_jax_arrays_runs():
    """A JAX SamplerState's arrays carry over through convert."""
    jphot, jshape, jspec = _problem()
    j_fn, fs = j_build_lnprob(jphot, jshape, jspec)
    jsamp = jsampler.EnsembleSampler(NW, fs.nfree, j_fn)
    c = TRUE[fs.free_idx]
    p0 = jsampler.make_initial_ball(jax.random.key(0), c, 0.05 * c, NW,
                                    fs.lower, fs.upper)
    js = jsamp.init_state(jax.random.key(1), p0)
    st = state_from_arrays(js.pos_a, js.pos_b, js.lnp_a, js.lnp_b,
                           js.naccept, js.nsteps, seed=99)
    np.testing.assert_array_equal(st.position.numpy(), np.asarray(p0))
    t_fn, _ = build_lnprob(photometry_from_arrays(
        jphot.wave, jphot.flux, jphot.unc), MBBShape(),
        spec_from_reference(jspec))
    np.testing.assert_allclose(t_fn(st.position).numpy(),
                               np.asarray(js.lnprob), rtol=1e-5, atol=1e-4)
    st2, chain, _ = tsampler.EnsembleSampler(NW, fs.nfree, t_fn).run_mcmc(
        st, 4)
    assert chain.shape == (4, NW, fs.nfree) and st2.step == 4


def _reflect_reference(ball, lo, hi):
    """numpy statement of the JAX package's reflection rule."""
    ball = ball.astype(np.float32)
    if lo is None and hi is None:
        return ball
    if lo is not None and hi is not None:
        tiny = (1e-9 * (hi - lo)).astype(np.float32)
    else:
        ref = lo if hi is None else hi
        tiny = (1e-9 * np.maximum(np.abs(ref), 1.0)).astype(np.float32)
    if lo is not None:
        lo_m = lo + tiny
        ball = np.where(ball < lo_m, 2.0 * lo_m - ball, ball)
    if hi is not None:
        hi_m = hi - tiny
        ball = np.where(ball > hi_m, 2.0 * hi_m - ball, ball)
    if lo is not None:          # a double overshoot is clipped
        ball = np.maximum(ball, lo_m)
    if hi is not None:
        ball = np.minimum(ball, hi_m)
    return ball


@pytest.mark.parametrize("bounds", ["both", "lower", "upper", "none"])
def test_initial_ball_reflects_at_bounds(bounds):
    center = np.array([1.0, 5.0, 0.0], np.float32)
    scatter = np.array([2.0, 1.0, 3.0], np.float32)
    lo = np.array([0.5, 4.5, -1.0], np.float32)
    hi = np.array([2.0, 6.0, 1.0], np.float32)
    lo = lo if bounds in ("both", "lower") else None
    hi = hi if bounds in ("both", "upper") else None
    ball = tsampler.make_initial_ball(torch.Generator().manual_seed(3),
                                      center, scatter, 500, lo, hi).numpy()
    eps = torch.randn((500, 3), generator=torch.Generator().manual_seed(3),
                      dtype=torch.float32).numpy()
    want = _reflect_reference(center + eps * scatter, lo, hi)
    np.testing.assert_allclose(ball, want, rtol=1e-6)
    if lo is not None:
        assert np.all(ball >= lo)
    if hi is not None:
        assert np.all(ball <= hi)
    # reflection keeps the spread (no pile-up on the bound)
    assert np.all(np.std(ball, axis=0) > 0.2 * scatter.min())
    # in-box values are untouched
    inside = np.ones_like(ball, bool)
    raw = center + eps * scatter
    if lo is not None:
        inside &= raw > lo + 1e-6
    if hi is not None:
        inside &= raw < hi - 1e-6
    np.testing.assert_array_equal(ball[inside], raw[inside])


def _shared_chain(frozen=False):
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.standard_normal((400, 32, 3)), axis=0) * 0.05 \
        + rng.standard_normal((400, 32, 3))
    if frozen:
        x[:, :, 1] = 2.5
    return x


@pytest.mark.parametrize("name", ["split_rhat", "split_rhat_rank_normalized",
                                  "autocorrelation_time", "ess_bulk",
                                  "ess_tail"])
@pytest.mark.parametrize("frozen", [False, True])
def test_diagnostics_equal_jax(name, frozen):
    chain = _shared_chain(frozen)

    def call(mod):
        if name.startswith("ess_"):
            return mod.effective_sample_size(chain, kind=name[4:])
        return getattr(mod, name)(chain)

    got, want = call(tsampler), call(jsampler)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    if frozen and name in ("split_rhat", "autocorrelation_time",
                           "ess_bulk"):
        assert np.isnan(got[1])


def test_philox_known_answers():
    """Philox-4x32-10 known-answer vectors (Random123's kat_vectors)."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        out = philox4x32(*(torch.tensor([c], dtype=torch.int64)
                           for c in ctr), key[0] | (key[1] << 32))
        assert tuple(int(o) for o in out) == want


def test_stretch_uniforms_layout_and_range():
    u = stretch_uniforms(key=12345, step0=2 ** 32 - 2, nsteps=4, half=8,
                         device="cpu")
    assert u.shape == (24, 8) and u.dtype == torch.float32
    assert bool(torch.all((u > 0) & (u < 1)))
    # a block starting later is the tail of the longer block
    tail = stretch_uniforms(12345, 2 ** 32, 2, 8, "cpu")
    assert torch.equal(u[12:], tail)
    # rows differ across steps, halves and draws
    assert len({tuple(r.tolist()) for r in u}) == 24


def test_split_runs_continue_the_stream():
    """run(n1) then run(n2) gives the chain of run(n1 + n2): the Philox
    stream continues where the previous launch stopped."""
    jphot, _, jspec = _problem(noalpha=True)
    t_fn, fs = build_lnprob(photometry_from_arrays(
        jphot.wave, jphot.flux, jphot.unc), MBBShape(noalpha=True),
        spec_from_reference(jspec))
    samp = tsampler.EnsembleSampler(32, fs.nfree, t_fn)
    c = TRUE[fs.free_idx]
    p0 = tsampler.make_initial_ball(torch.Generator().manual_seed(0), c,
                                    0.05 * c, 32, fs.lower, fs.upper)
    s0 = samp.init_state(p0, seed=2024)
    _, whole, _ = samp.run_mcmc(s0, 6)
    s1, first, _ = samp.run_mcmc(s0, 2)
    s2, second, _ = samp.run_mcmc(s1, 4)
    assert torch.equal(torch.cat([first, second]), whole)
    assert s2.step == 6
    assert samp.advance(s0, 6).pos_a.equal(whole[-1, :16])
    reset = samp.reset_counters(s2)
    assert reset.nsteps == 0 and int(reset.naccept.sum()) == 0
    assert reset.step == 6
    af = samp.acceptance_fraction(s2)
    assert np.all((af >= 0) & (af <= 1))


@pytest.mark.parametrize("make", [
    lambda p, s, sp: FusedSampler(63, p, s, sp, device="cpu"),
    lambda p, s, sp: FusedSampler(6, p, s, sp, device="cpu"),
    lambda p, s, sp: FusedSampler(4096, p, s, sp, device="cpu"),
    lambda p, s, sp: FusedSampler(64, p, s, sp, rng="bad", device="cpu")])
def test_fused_sampler_rejects_bad_config(make):
    jphot, _, jspec = _problem()
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc)
    with pytest.raises(ValueError):
        make(phot, MBBShape(), spec_from_reference(jspec))


def test_fused_sampler_uniforms_follow_the_rng_mode():
    jphot, _, jspec = _problem()
    phot = photometry_from_arrays(jphot.wave, jphot.flux, jphot.unc)
    spec = spec_from_reference(jspec)
    p0 = torch.as_tensor(np.tile(TRUE, (NW, 1)).astype(np.float32)) \
        * (1 + 0.01 * torch.randn((NW, 5),
                                  generator=torch.Generator().manual_seed(1)))
    hw = FusedSampler(NW, phot, MBBShape(), spec, device="cpu")
    ext = FusedSampler(NW, phot, MBBShape(), spec, rng="external",
                       device="cpu")
    state = hw.init_state(p0, seed=5)
    u = torch.full((2, 6, NW // 2), 0.5)
    with pytest.raises(ValueError):
        hw.run_mcmc(state, 2, uniforms=u)
    with pytest.raises(ValueError):
        ext.run_mcmc(state, 2)
    st, chain, _ = ext.run_mcmc(state, 2, uniforms=u)
    assert chain.shape == (2, NW, 5)
    adv = ext.advance(state, 2, uniforms=u.reshape(1, 12, NW // 2))
    assert torch.equal(adv.position, st.position)
    assert dataclasses.replace(st, nsteps=0).nsteps == 0
