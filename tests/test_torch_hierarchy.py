"""The population tier in the port (mbb_emcee_tpu_torch/hierarchy.py) against
the JAX package on the CPU: LikelihoodSpec.for_box and
FreeSpace.scatter_matrix, the hierarchical lnprob on the same (S, N, K)
samples and hyper vectors at rtol 1e-5 (both families, an interim prior, a
Selection), the populations' ln_dist, box normalization _ln_z and
marginal_pdf, a few hyper-sampler steps replayed from shared uniforms, and
.pop.h5 files read by both packages; then the port's twins of
tests/test_hierarchy.py (the two tests the JAX package marks slow at a
smaller scale, with their tolerances).

Left out by design: test_mesh_sharded_lnprob_matches_unsharded,
test_program_token_splits_on_mesh_shape and
test_multi_axis_mesh_first_axis_divides (source sharding over a mesh is
ROADMAP A11: mesh= raises NotImplementedError naming it, held here); the
population plot's twins are in tests/test_torch_plotting.py."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu import hierarchy as jh  # noqa: E402
from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu.likelihood import LikelihoodSpec as JSpec  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
from mbb_emcee_tpu_torch.hierarchy import (  # noqa: E402
    CorrelatedGaussianPopulation, HierarchicalFitter, Selection,
    TruncatedGaussianPopulation, build_hier_lnprob, fit_population)
from mbb_emcee_tpu_torch.likelihood import LikelihoodSpec  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    EnsembleSampler, make_initial_ball)

CPU = "cpu"


def _t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _twins(fam, names, lo, hi, **kw):
    """(JAX population, port population) of family `fam` on one box."""
    j = (jh.TruncatedGaussianPopulation if fam == "ind"
         else jh.CorrelatedGaussianPopulation)
    t = (TruncatedGaussianPopulation if fam == "ind"
         else CorrelatedGaussianPopulation)
    return (j.for_box(names, lo, hi, **kw), t.for_box(names, lo, hi, **kw))


def _phis(rng, fam, lo, hi, n):
    out = []
    for _ in range(n):
        v = [rng.uniform(lo + 1, hi - 1), rng.uniform(0.5, 4.0, 2)]
        if fam == "corr":
            v.append([rng.uniform(-0.8, 0.8)])
        out.append(np.concatenate(v))
    return np.asarray(out, np.float32)


# -- against the JAX package -----------------------------------------------------

@pytest.mark.parametrize("fam", ["ind", "corr"])
@pytest.mark.parametrize("extras", ["plain", "interim+selection"])
def test_lnprob_matches_jax(fam, extras):
    """build_hier_lnprob over a (W, nfree) hyper batch equals the JAX
    package's vmapped lnprob at rtol 1e-5, with an interim Gaussian prior
    and a Selection (pdet-weighted injections), a hyper-parameter fixed and
    a Gaussian hyper-prior; out-of-box vectors hit the floor in both."""
    rng = np.random.default_rng(42)
    S, N = 12, 64
    lo, hi = np.array([0.0, -5.0]), np.array([20.0, 5.0])
    samples = rng.uniform(lo, hi, (S, N, 2))
    jp, tp = _twins(fam, ("x", "y"), lo, hi, sigma_log_uniform=True)
    kw_j, kw_t = {}, {}
    if extras != "plain":
        ln_interim = -0.5 * ((samples[..., 0] - 8.0) / 6.0) ** 2
        inj = rng.uniform(lo, hi, (500, 2))
        pdet = rng.uniform(0.0, 1.0, 500)
        kw_j = dict(ln_interim=ln_interim, selection=jh.Selection
                    .from_injections(inj, pdet=pdet, box=(lo, hi)))
        kw_t = dict(ln_interim=ln_interim, selection=Selection
                    .from_injections(inj, pdet=pdet, box=(lo, hi)))
    spec = LikelihoodSpec.for_box(tp.lower, tp.upper)
    fixed = spec.fixed.copy()
    fixed[3] = True
    fv = spec.fixed_values.copy()
    fv[3] = 2.0
    pm, ps = spec.prior_mean.copy(), spec.prior_isigma.copy()
    pm[0], ps[0] = 10.0, 1.0 / 8.0
    spec = spec.__class__(**{**spec.__dict__, "fixed": fixed,
                             "fixed_values": fv, "prior_mean": pm,
                             "prior_isigma": ps})
    jspec = JSpec(**spec.__dict__)
    jl, jfs = jh.build_hier_lnprob(samples, jp, jspec, **kw_j)
    tl, tfs = build_hier_lnprob(samples, tp, spec, device=CPU, **kw_t)
    np.testing.assert_array_equal(tfs.free_idx, jfs.free_idx)
    phis = _phis(rng, fam, lo, hi, 6)[:, tfs.free_idx]
    phis[-1, 0] = -1.0                     # out of the hyper box
    want = np.asarray(jax.vmap(jl)(jnp.asarray(phis)))
    got = tl(_t32(phis)).numpy()
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-5)
    assert got[-1] == want[-1] == np.float32(-1e30)
    assert float(tl(_t32(phis[0]))) == got[0]


def test_spec_helpers_match_jax():
    """LikelihoodSpec.for_box and FreeSpace.scatter_matrix against the JAX
    package's: the same spec fields, the same refusals, the same scatter
    matrix with a parameter fixed."""
    from mbb_emcee_tpu.likelihood import FreeSpace as JFree
    from mbb_emcee_tpu_torch.likelihood import FreeSpace
    lo, hi = [10.0, 0.5, 0.1, 0.01], [60.0, 3.5, 8.0, 2.0]
    got, want = LikelihoodSpec.for_box(lo, hi), JSpec.for_box(lo, hi)
    for f in ("lower", "upper", "fixed", "fixed_values", "prior_mean",
              "prior_isigma"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    fixed = got.fixed.copy()
    fixed[2] = True
    got = got.__class__(**{**got.__dict__, "fixed": fixed})
    want = JSpec(**{**want.__dict__, "fixed": fixed})
    for dt in (np.float64, np.float32):
        a = FreeSpace.from_spec(got).scatter_matrix(dt)
        b = JFree.from_spec(want).scatter_matrix(dt)
        assert a.dtype == b.dtype and a.shape == (4, 3)
        np.testing.assert_array_equal(a, b)
    for bad in (([1.0], [0.0]), ([0.0, 1.0], [1.0])):
        with pytest.raises(ValueError) as e1:
            LikelihoodSpec.for_box(*bad)
        with pytest.raises(ValueError) as e2:
            JSpec.for_box(*bad)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("fam", ["ind", "corr"])
def test_populations_match_jax(fam):
    """ln_dist at (W, P) hyper vectors on (S, N, K) points, the correlated
    family's box normalization _ln_z, and marginal_pdf, against the JAX
    package's."""
    rng = np.random.default_rng(7)
    lo, hi = np.array([10.0, 0.5]), np.array([60.0, 3.5])
    jp, tp = _twins(fam, ("T", "beta"), lo, hi)
    theta = rng.uniform(lo - 1.0, hi + 1.0, (5, 40, 2)).astype(np.float32)
    phis = np.asarray([np.concatenate(
        [rng.uniform(lo, hi), rng.uniform(0.05, 8.0, 2)]
        + ([[rng.uniform(-0.9, 0.9)]] if fam == "corr" else []))
        for _ in range(4)], np.float32)
    got = tp.ln_dist(_t32(phis), _t32(theta)).numpy()
    for w in range(4):
        want = np.asarray(jp.ln_dist(jnp.asarray(phis[w]),
                                     jnp.asarray(theta)))
        floor = want < -1e29
        np.testing.assert_array_equal(got[w] < -1e29, floor)
        np.testing.assert_allclose(got[w][~floor], want[~floor], rtol=1e-5,
                                   atol=1e-5)
        x = np.linspace(lo[0] - 2, hi[0] + 2, 101)
        np.testing.assert_allclose(tp.marginal_pdf(phis[w], 0, x),
                                   jp.marginal_pdf(phis[w], 0, x),
                                   rtol=1e-5, atol=1e-12)
        if fam == "corr":
            p = phis[w]
            zj = float(jp._ln_z(jnp.asarray(p[:2]), jnp.asarray(p[2:4]),
                                jnp.float32(p[4]), jnp.float32))
            zt = tp._ln_z(_t32(p[None, :2]), _t32(p[None, 2:4]),
                          _t32(p[None, 4]))
            np.testing.assert_allclose(float(zt[0]), zj, rtol=1e-5,
                                       atol=1e-6)


def test_hyper_steps_replay_jax():
    """Three stretch-move steps of the hyper-sampler from shared external
    uniforms: the port's EnsembleSampler on build_hier_lnprob against the
    JAX package's half-step on its lnprob, positions and lnprob at rtol
    1e-5."""
    rng = np.random.default_rng(3)
    samples = rng.normal(35.0, 4.0, (8, 64, 1))
    jp, tp = _twins("ind", ("T",), [10.0], [60.0])
    jl, _ = jh.build_hier_lnprob(samples, jp, JSpec.for_box(jp.lower,
                                                             jp.upper))
    tl, _ = build_hier_lnprob(samples, tp, LikelihoodSpec.for_box(
        tp.lower, tp.upper), device=CPU)
    W, nsteps = 16, 3
    p0 = np.column_stack([rng.uniform(30, 40, W),
                          rng.uniform(2, 6, W)]).astype(np.float32)
    u = rng.uniform(size=(nsteps, 6, W // 2)).astype(np.float32)
    samp = EnsembleSampler(W, 2, tl)
    _, chain, lnp = samp.run_mcmc(samp.init_state(_t32(p0), seed=1), nsteps,
                                  uniforms=_t32(u))
    jlb = jax.vmap(jl)
    pa, pb = jnp.asarray(p0[:W // 2]), jnp.asarray(p0[W // 2:])
    la, lb = jlb(pa), jlb(pb)
    for t in range(nsteps):
        pa, la, _ = jsampler.stretch_half_step_from_uniforms(
            jnp.asarray(u[t, :3]), pa, pb, la, jlb)
        pb, lb, _ = jsampler.stretch_half_step_from_uniforms(
            jnp.asarray(u[t, 3:]), pb, pa, lb, jlb)
        np.testing.assert_allclose(chain[t].numpy(),
                                   np.concatenate([pa, pb]), rtol=1e-5)
        np.testing.assert_allclose(lnp[t].numpy(),
                                   np.concatenate([la, lb]), rtol=1e-5)


def test_pop_files_cross_both_ways(tmp_path):
    """A port .pop.h5 (built-in family, a fixed hyper-parameter, a
    Selection) loads in the JAX package's HierarchicalFitter.from_h5, and
    the JAX package's writer's file of it loads in the port's."""
    samples, _, _ = _population_setup(seed=17)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples[:6], pop, nwalkers=16, seed=4,
                            device=CPU)
    hf.fix_param("sigma_T", 4.0)
    hf.set_selection(np.random.default_rng(1).uniform(10, 60, (64, 1)))
    hf.run(nburn=20, nsteps=40)
    p1, p2 = str(tmp_path / "port.pop.h5"), str(tmp_path / "jax.pop.h5")
    hf.writeToHDF5(p1)
    jf = jh.HierarchicalFitter.from_h5(p1)
    assert isinstance(jf.population, jh.TruncatedGaussianPopulation)
    assert jf.free_hyper_names() == ["mu_T"]
    np.testing.assert_array_equal(jf.chain_free, hf.chain_free)
    np.testing.assert_allclose(jf.reweight_ess(), hf.reweight_ess(),
                               rtol=1e-4)
    jf.writeToHDF5(p2)
    back = HierarchicalFitter.from_h5(p2, device=CPU)
    np.testing.assert_array_equal(back.chain_free, hf.chain_free)
    np.testing.assert_array_equal(back.samples, hf.samples)
    np.testing.assert_allclose(back.par_cen("mu_T"), hf.par_cen("mu_T"))
    np.testing.assert_allclose(back.selection.injections,
                               hf.selection.injections)
    assert back._spec.fixed.tolist() == [False, True]


def test_mesh_and_generic_batches_are_refused():
    """mesh= (ROADMAP A11, ported) takes a parallel.walker_mesh and
    refuses anything else (a JAX mesh, say) with a TypeError naming
    walker_mesh (tests/test_torch_parallel.py holds the sharded
    hyper-lnprob against JAX's and the unsharded one); the population plot
    of a fitter that has not run is refused (test_plot_population_draws
    holds it on a run one); a generic-model batch (SEDMultiFitter) that has
    not run is refused like a MultiFitter that has not (from_batch on a
    run one is test_from_batch_sedmulti)."""
    samples = np.random.default_rng(0).normal(35, 4, (4, 16, 1))
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    with pytest.raises(TypeError, match="walker_mesh"):
        HierarchicalFitter(samples, pop, device=CPU, mesh=object())
    with pytest.raises(TypeError, match="walker_mesh"):
        build_hier_lnprob(samples, pop, LikelihoodSpec.for_box(
            pop.lower, pop.upper), device=CPU, mesh=object())
    smf = T.SEDMultiFitter(_plaw_models()[0], nwalkers=8, device=CPU)
    with pytest.raises(RuntimeError, match="finished run"):
        HierarchicalFitter.from_batch(smf, params=("slope",))
    hf = HierarchicalFitter(samples, pop, nwalkers=8, device=CPU)
    with pytest.raises(RuntimeError, match="run"):
        hf.plot_population("T")


def test_plot_population_draws(tmp_path):
    """HierarchicalFitter.plot_population (refused until the plots were
    ported) draws the population band over the per-source medians and
    saves it; an unknown parameter is refused."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    rng = np.random.default_rng(5)
    x = rng.normal(35.0, 4.0, 12)
    samples = (x[:, None] + rng.normal(0, 1.5, (12, 64)))[..., None]
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples, pop, nwalkers=8, seed=2, device=CPU)
    hf.run(nburn=20, nsteps=40)
    out = tmp_path / "pop.png"
    fig = hf.plot_population("T", n_draw=32, savefig=str(out))
    assert out.stat().st_size > 0
    ax = fig.axes[0]
    assert ax.lines and ax.collections and ax.patches
    with pytest.raises(ValueError, match="unknown population parameter"):
        hf.plot_population("beta")
    matplotlib.pyplot.close("all")


def _plaw_models():
    """(port, JAX) twins of tests/test_hierarchy.py's power-law model."""
    from mbb_emcee_tpu.sed import SEDModel as JSEDModel
    kw = dict(param_names=("amp", "slope"), lower=[1.0, 0.1],
              upper=[100.0, 3.0], name="plaw")
    return (T.SEDModel(fnu=lambda th, w: th[0] * (w / 100.0) ** (-th[1]),
                       **kw),
            JSEDModel(fnu=lambda th, w: th[0] * (w / 100.0) ** (-th[1]),
                      **kw))


def test_from_batch_sedmulti(tmp_path):
    """from_batch on a generic-model SEDMultiFitter run (the free names
    resolved from the model), with a shared prior on amp and PER-SOURCE
    interim priors on slope: the strided samples and ln_interim (both
    priors divided out) against the JAX package's from_batch on the same
    chain, read from the port's sed-batch file (rtol 1e-6); then the
    hyper-fit's mu_slope is sane (twin of tests/test_hierarchy.py::
    test_from_batch_sedmulti and tests/test_sedmulti.py::
    test_ps_prior_hierarchy_interim_division)."""
    from mbb_emcee_tpu.sedmulti import SEDMultiFitter as JSEDMultiFitter
    model, jmodel = _plaw_models()
    wave = np.array([60.0, 100.0, 250.0, 500.0])
    rng = np.random.default_rng(6)
    S = 4
    slopes = rng.uniform(0.8, 1.6, S)
    flux = np.stack([20.0 * (wave / 100.0) ** (-s) for s in slopes])
    unc = 0.05 * flux
    smf = T.SEDMultiFitter(model, nwalkers=16, seed=3, device=CPU)
    smf.set_data(wave, flux + unc * rng.standard_normal(flux.shape), unc)
    for nm, v in (("amp", 20.0), ("slope", 1.2)):
        smf.set_param_init(nm, v, 0.2 * v)
    smf.set_gaussian_prior("amp", 20.0, 10.0)
    smf.set_gaussian_prior("slope", np.array([1.0, 1.2, 1.4, 0.0]),
                           np.array([0.5, 0.6, 0.7, np.inf]))
    smf.run(nburn=40, nsteps=120)
    path = str(tmp_path / "plaw.h5")
    smf.writeToHDF5(path)
    jmf = JSEDMultiFitter.from_h5(path, jmodel)
    for params in (("slope",), ("amp", "slope")):
        hf = HierarchicalFitter.from_batch(smf, params=params, nwalkers=16,
                                           max_samples=512)
        jf = jh.HierarchicalFitter.from_batch(jmf, params=params,
                                              nwalkers=16, max_samples=512)
        np.testing.assert_array_equal(hf.samples, np.asarray(jf.samples))
        np.testing.assert_allclose(hf.ln_interim, np.asarray(jf.ln_interim),
                                   rtol=1e-6)
    assert hf.device == smf.device
    hf = HierarchicalFitter.from_batch(smf, params=("slope",), nwalkers=16,
                                       max_samples=512)
    hf.run(nburn=50, nsteps=150)
    assert 0.5 < hf.par_cen("mu_slope")[0] < 2.0
    assert hf.reweight_ess().shape == (S,)
    with pytest.raises(ValueError, match="not free"):
        HierarchicalFitter.from_batch(smf, params=("T",))


# -- twins of tests/test_hierarchy.py -----------------------------------------------

def test_truncnorm_normalization():
    pop = TruncatedGaussianPopulation.for_box(("a", "b"),
                                              [0.0, -3.0], [10.0, 3.0])
    grid_a = np.linspace(0.0, 10.0, 2001)
    grid_b = np.linspace(-3.0, 3.0, 2001)
    theta = _t32(np.stack(np.meshgrid(grid_a, grid_b, indexing="ij"),
                          axis=-1))
    for mu, sig in [((5.0, 0.0), (1.0, 1.0)),
                    ((0.5, 2.8), (2.0, 0.7)),
                    ((9.9, -2.9), (5.0, 3.0))]:
        phi = _t32(np.concatenate([mu, sig]))
        p = torch.exp(pop.ln_dist(phi, theta)).double().numpy()
        integral = np.trapezoid(np.trapezoid(p, grid_b, axis=1), grid_a)
        assert abs(integral - 1.0) < 2e-3, (mu, sig, integral)


def test_population_validation():
    with pytest.raises(ValueError):
        TruncatedGaussianPopulation.for_box(("a",), [1.0], [0.0])
    with pytest.raises(ValueError):
        TruncatedGaussianPopulation.for_box(("a", "b"), [0.0], [1.0])
    with pytest.raises(ValueError):
        TruncatedGaussianPopulation.for_box(("a",), [0.0], [1.0],
                                            sigma_min=0.5, sigma_max=0.1)


def test_lnprob_matches_numpy_oracle():
    rng = np.random.default_rng(42)
    S, N, K = 12, 64, 2
    lo, hi = np.array([0.0, -5.0]), np.array([20.0, 5.0])
    samples = rng.uniform(lo, hi, (S, N, K))
    ln_interim = -0.5 * ((samples[..., 0] - 8.0) / 6.0) ** 2
    pop = TruncatedGaussianPopulation.for_box(("x", "y"), lo, hi)
    spec = LikelihoodSpec.for_box(pop.lower, pop.upper)
    lnprob, _ = build_hier_lnprob(samples, pop, spec, ln_interim=ln_interim,
                                  device=CPU)

    def oracle(phi):
        from scipy.stats import norm
        mu, sig = phi[:K], phi[K:]
        z = (samples - mu) / sig
        trunc = norm.cdf((hi - mu) / sig) - norm.cdf((lo - mu) / sig)
        ld = np.sum(-0.5 * z * z - np.log(sig)
                    - 0.5 * np.log(2 * np.pi) - np.log(trunc), axis=-1)
        lw = ld - ln_interim
        m = lw.max(axis=-1, keepdims=True)
        return (np.log(np.exp(lw - m).mean(axis=-1)) + m[:, 0]).sum()

    for _ in range(5):
        phi = np.concatenate([rng.uniform(lo + 1, hi - 1),
                              rng.uniform(0.5, 4.0, K)])
        got = float(lnprob(_t32(phi)))
        want = oracle(phi)
        assert np.isfinite(got)
        assert abs(got - want) < 2e-4 * max(1.0, abs(want)), (got, want)
    bad = np.concatenate([lo - 1.0, np.full(K, 1.0)])
    assert float(lnprob(_t32(bad))) < -1e29


def test_ess_uniform_weights_and_custom_population():
    """A flat bring-your-own population (the port's contract: phi (P,) or
    (W, P)) gives uniform weights, ESS == N."""

    class FlatPop:
        hyper_names = ("c",)
        lower = np.array([0.0])
        upper = np.array([1.0])
        default_init = np.array([0.5])
        default_scatter = np.array([0.1])

        def ln_dist(self, phi, theta):
            return torch.zeros(phi.shape[:-1] + theta.shape[:-1],
                               dtype=theta.dtype)

        def ln_hyper_prior(self, phi):
            return torch.zeros(phi.shape[:-1], dtype=phi.dtype)

    rng = np.random.default_rng(1)
    S, N = 6, 128
    hf = HierarchicalFitter(rng.normal(0, 1, (S, N, 1)), FlatPop(),
                            nwalkers=8, seed=5, device=CPU)
    ess = hf.reweight_ess(phi=np.array([0.5]))
    assert ess.shape == (S,)
    np.testing.assert_allclose(ess, N, rtol=1e-4)
    hf.run(nburn=5, nsteps=10)
    assert hf.chain_free.shape == (10, 8, 1)


def _population_setup(seed=7, N=256):
    rng = np.random.default_rng(seed)
    S = 64
    mu_true, sig_true, sig_obs = 35.0, 4.0, 1.5
    theta_s = rng.normal(mu_true, sig_true, S)
    x_s = theta_s + rng.normal(0, sig_obs, S)
    samples = (x_s[:, None] + rng.normal(0, sig_obs, (S, N)))[..., None]
    return samples, x_s, sig_obs


def _oracle_chain(lnprob, lo, hi, pop, seed, nburn, nsteps):
    """The plain stretch sampler over an analytic hyper lnprob on the same
    (mu, sigma) box: (nsamp, 2)."""
    samp = EnsembleSampler(64, 2, lnprob)
    p0 = make_initial_ball(torch.Generator().manual_seed(seed),
                           np.array([35.0, 5.0]), np.array([3.0, 1.0]), 64,
                           np.array([lo, pop.sigma_min[0]]),
                           np.array([hi, pop.sigma_max[0]]), device="cpu")
    st = samp.advance(samp.init_state(p0, seed=seed), nburn)
    st = EnsembleSampler.reset_counters(st)
    _, chain, _ = samp.run_mcmc(st, nsteps)
    return chain.double().numpy().reshape(-1, 2)


def _inbox(phi, lo, hi, pop):
    mu, sig = phi[..., 0], phi[..., 1]
    return ((mu >= lo) & (mu <= hi) & (sig >= float(pop.sigma_min[0]))
            & (sig <= float(pop.sigma_max[0])))


def test_recovery_matches_analytic_marginal():
    """The importance-reweighted hyper-posterior against a chain on the
    EXACT analytic marginal likelihood over the same box."""
    samples, x_s, sig_obs = _population_setup(N=128)
    lo, hi = 10.0, 60.0
    pop = TruncatedGaussianPopulation.for_box(("T",), [lo], [hi])
    hf = HierarchicalFitter(samples, pop, nwalkers=64, seed=11, device=CPU)
    hf.run(nburn=150, nsteps=450)
    xs = _t32(x_s)

    def analytic(phi):
        mu, sig = phi[..., :1], phi[..., 1:2]
        s2 = sig * sig + sig_obs * sig_obs
        lnl = torch.sum(-0.5 * (xs - mu) ** 2 / s2 - 0.5 * torch.log(s2),
                        dim=-1)
        return torch.where(_inbox(phi, lo, hi, pop), lnl,
                           torch.full_like(lnl, -1e30))

    oracle = _oracle_chain(analytic, lo, hi, pop, 99, 150, 450)
    for i, name in enumerate(("mu_T", "sigma_T")):
        got = hf.par_cen(name)
        med_o = np.median(oracle[:, i])
        width_o = np.subtract(*np.percentile(oracle[:, i], [84.15, 15.85]))
        assert abs(got[0] - med_o) < 0.35 * width_o, (name, got, med_o)
        assert abs(got[1] + got[2] - width_o) < 0.25 * width_o, (name, got)
    assert hf.reweight_ess().min() > 0.2 * samples.shape[1]


def test_fixed_hyper_and_setters():
    samples, _, _ = _population_setup(seed=3)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples, pop, nwalkers=16, seed=2, device=CPU)
    hf.fix_param("sigma_T", 4.0)
    hf.set_gaussian_prior("mu_T", 35.0, 20.0)
    hf.run(nburn=100, nsteps=300)
    assert hf.chain_free.shape == (300, 16, 1)
    assert hf.free_hyper_names() == ["mu_T"]
    assert 25.0 < hf.par_cen("mu_T")[0] < 45.0
    with pytest.raises(ValueError):
        hf.hyper_chain("sigma_T")
    names, rhat = hf.gelman_rubin()
    assert names == ["mu_T"] and rhat.shape == (1,)
    phi, lnp = hf.best_fit()
    assert phi.shape == (2,) and phi[1] == 4.0 and np.isfinite(lnp)
    hf.extend(100)
    assert hf.chain_free.shape == (400, 16, 1)
    with pytest.raises(ValueError, match="unknown hyper-parameter"):
        hf.set_uplim("T", 3.0)


def _mbb_catalog(S=8, seed=21):
    wave = np.linspace(100.0, 500.0, 5)
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(seed)
    t_true = np.clip(rng.normal(35.0, 5.0, S), 20.0, 55.0)
    flux, unc = [], []
    for t in t_true:
        f = mbb_fnu(_t32([t, 1.8, 250.0, 4.0, 40.0]), _t32(wave),
                    shape).double().numpy()
        u = 0.05 * f
        flux.append(f + u * rng.standard_normal(wave.size))
        unc.append(u)
    return wave, np.array(flux), np.array(unc)


def test_from_batch_population_fit():
    wave, flux, unc = _mbb_catalog()
    mf = T.MultiFitter(nwalkers=32, opthin=True, noalpha=True, seed=9,
                       device=CPU)
    mf.set_data(wave, flux, unc)
    mf.set_uplim("T", 90.0)
    mf.set_gaussian_prior("T", 35.0, 25.0)
    mf.run(nburn=60, nsteps=150)
    hf = HierarchicalFitter.from_batch(mf, params=("T",), max_samples=1000)
    assert hf.ln_interim is not None and hf.device == mf.device
    assert hf.samples.shape[0] == 8 and hf.samples.shape[2] == 1
    assert hf.samples.shape[1] <= 1000
    np.testing.assert_array_equal(
        hf.samples[..., 0], mf.chain_free[..., 0].reshape(8, -1)[:, ::5]
        .numpy())
    hf = fit_population(mf, params=("T",), nburn=100, nsteps=300,
                        max_samples=1000)
    mu = hf.par_cen("mu_T")
    t_med = mf.par_cen("T")[:, 0]
    assert abs(mu[0] - t_med.mean()) < max(3.0 * mu[1], 5.0)
    ess = hf.reweight_ess()
    assert ess.shape == (8,) and np.all(ess > 1.0)
    with pytest.raises(ValueError):
        HierarchicalFitter.from_batch(mf, params=("lambda0",))


def test_from_batch_requires_run():
    mf = T.MultiFitter(nwalkers=64, opthin=True, noalpha=True, device=CPU)
    with pytest.raises(RuntimeError):
        HierarchicalFitter.from_batch(mf, params=("T",))


def test_hdf5_roundtrip(tmp_path):
    import h5py
    samples, _, _ = _population_setup(seed=13)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples[:8], pop, nwalkers=16, seed=4,
                            device=CPU)
    hf.run(nburn=50, nsteps=100)
    path = str(tmp_path / "hier.h5")
    hf.writeToHDF5(path)
    with h5py.File(path, "r") as f:
        assert f.attrs["kind"] == "hierarchy"
        assert [n.decode() for n in f.attrs["hyper_names"]] == ["mu_T",
                                                                "sigma_T"]
        assert f["chain_free"].shape == (100, 16, 2)
        assert f["reweight_ess"].shape == (8,)
        np.testing.assert_array_equal(f["hyper_lower"][...], pop.lower)


def test_corr_population_normalization():
    pop = CorrelatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
    ga = np.linspace(10.0, 60.0, 1200)
    gb = np.linspace(0.5, 3.5, 1200)
    theta = _t32(np.stack(np.meshgrid(ga, gb, indexing="ij"), axis=-1))
    for phi in ([35.0, 2.0, 5.0, 0.4, 0.0],
                [35.0, 2.0, 5.0, 0.4, 0.9],
                [12.0, 0.7, 8.0, 0.8, 0.6],
                [35.0, 2.0, 0.6, 0.04, 0.9],
                [58.0, 3.4, 40.0, 2.9, -0.5]):
        p = torch.exp(pop.ln_dist(_t32(phi), theta)).double().numpy()
        integral = np.trapezoid(np.trapezoid(p, gb, axis=1), ga)
        assert abs(integral - 1.0) < 5e-3, (phi, integral)


def test_corr_population_validation():
    with pytest.raises(ValueError):
        CorrelatedGaussianPopulation.for_box(
            ("a", "b", "c"), [0.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    with pytest.raises(ValueError):
        CorrelatedGaussianPopulation.for_box(
            ("a", "b"), [0.0, 0.0], [1.0, 1.0], rho_max=1.5)


def _corr_catalog(rho_t, seed, S, N):
    rng = np.random.default_rng(seed)
    mu_t = np.array([35.0, 1.9])
    sig_t = np.array([5.0, 0.35])
    cov = np.array([[sig_t[0] ** 2, rho_t * sig_t[0] * sig_t[1]],
                    [rho_t * sig_t[0] * sig_t[1], sig_t[1] ** 2]])
    theta_s = rng.multivariate_normal(mu_t, cov, S)
    sig_obs = np.array([1.2, 0.08])
    x_s = theta_s + rng.normal(0, sig_obs, (S, 2))
    return x_s[:, None, :] + rng.normal(0, sig_obs, (S, N, 2))


def test_corr_population_recovers_correlation():
    samples = _corr_catalog(0.7, 23, 64, 64)
    pop = CorrelatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
    hf = HierarchicalFitter(samples, pop, nwalkers=64, seed=31, device=CPU)
    hf.run(nburn=150, nsteps=400)
    rho = hf.par_cen("rho_T_beta")
    assert abs(rho[0] - 0.7) < 1.5 * (rho[1] + rho[2]), rho
    assert rho[0] - 2.0 * rho[2] > 0.0, rho
    mu_a = hf.par_cen("mu_T")
    assert abs(mu_a[0] - 35.0) < 3.0 * (mu_a[1] + mu_a[2])
    assert hf.reweight_ess().min() > 10.0


def test_population_box_indicator():
    pop = TruncatedGaussianPopulation.for_box(("x",), [0.0], [1.0])
    ld = pop.ln_dist(_t32([0.5, 0.3]), _t32([[0.5], [1.5]])).numpy()
    assert np.isfinite(ld[0]) and ld[0] > -10.0
    assert ld[1] < -1e29


def test_compute_evidence_smoke():
    samples, _, _ = _population_setup(seed=9)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples[:16], pop, nwalkers=16, seed=2,
                            device=CPU)
    res = hf.compute_evidence(nlive=64, nbatch=8, nsteps=8, max_iter=400)
    assert np.isfinite(res.logz) and res.logz_err < 1.0
    assert hf.evidence is res and res.samples.shape[-1] == 2


def test_evidence_selects_population_family():
    """The Bayes factor between the independent and correlated families:
    a rho=0.7 catalog prefers the correlated model decisively, a rho=0 one
    does not (the JAX twin is in its slow lane at 48 sources x 128 samples,
    nlive 256 and 16 steps; here 32 x 64, nlive 128 and 8 steps, the same
    thresholds in units of the combined error; at nlive 64 the constrained
    moves miss the correlated family's ridge in both packages)."""
    ind = TruncatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
    corr = CorrelatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
    kw = dict(nlive=128, nbatch=16, nsteps=8, max_iter=1500)
    for rho_t, want_corr in ((0.7, True), (0.0, False)):
        samples = _corr_catalog(rho_t, int(100 * (1 + rho_t)), 32, 64)
        z_ind = HierarchicalFitter(samples, ind, seed=3,
                                   device=CPU).compute_evidence(**kw)
        z_corr = HierarchicalFitter(samples, corr, seed=3,
                                    device=CPU).compute_evidence(**kw)
        lnbf = z_corr.logz - z_ind.logz
        err = np.hypot(z_corr.logz_err, z_ind.logz_err)
        if want_corr:
            assert lnbf > 3.0 + 2 * err, (rho_t, lnbf, err)
        else:
            assert lnbf < 2.0 + 2 * err, (rho_t, lnbf, err)


def test_marginal_pdf_matches_joint():
    gb = np.linspace(0.5, 3.5, 4001)
    ga = np.linspace(10.0, 60.0, 301)
    theta = _t32(np.stack(np.meshgrid(ga, gb, indexing="ij"), axis=-1))
    for fam, phi in (("corr", np.array([33.0, 1.2, 7.0, 0.6, 0.65])),
                     ("ind", np.array([33.0, 1.2, 7.0, 0.6]))):
        _, pop = _twins(fam, ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
        joint = torch.exp(pop.ln_dist(_t32(phi), theta)).double().numpy()
        numeric = np.trapezoid(joint, gb, axis=1)
        np.testing.assert_allclose(pop.marginal_pdf(phi, 0, ga), numeric,
                                   rtol=5e-3, atol=1e-5)


def test_from_h5_roundtrip_full(tmp_path):
    samples, _, _ = _population_setup(seed=17)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples[:8], pop, nwalkers=16, seed=4,
                            device=CPU)
    hf.fix_param("sigma_T", 4.0)
    hf.run(nburn=40, nsteps=100)
    path = str(tmp_path / "h.h5")
    hf.writeToHDF5(path)
    back = HierarchicalFitter.from_h5(path, device=CPU)
    np.testing.assert_array_equal(back.chain_free, hf.chain_free)
    np.testing.assert_allclose(back.par_cen("mu_T"), hf.par_cen("mu_T"))
    np.testing.assert_allclose(back.reweight_ess(), hf.reweight_ess(),
                               rtol=1e-5)
    assert back.free_hyper_names() == ["mu_T"]
    assert isinstance(back.population, TruncatedGaussianPopulation)
    back.run(nburn=40, nsteps=100)
    np.testing.assert_array_equal(back.chain_free, hf.chain_free)

    rng = np.random.default_rng(2)
    s2 = rng.uniform([15.0, 1.0], [50.0, 3.0], (6, 64, 2))
    pop2 = CorrelatedGaussianPopulation.for_box(
        ("T", "beta"), [10.0, 0.5], [60.0, 3.5])
    hf2 = HierarchicalFitter(s2, pop2, nwalkers=16, seed=1, device=CPU)
    hf2.run(nburn=30, nsteps=60)
    path = str(tmp_path / "h2.h5")
    hf2.writeToHDF5(path)
    back2 = HierarchicalFitter.from_h5(path, device=CPU)
    assert isinstance(back2.population, CorrelatedGaussianPopulation)
    assert back2.population.rho_max == pop2.rho_max
    np.testing.assert_allclose(back2.par_cen("rho_T_beta"),
                               hf2.par_cen("rho_T_beta"))


def test_dead_source_raises():
    rng = np.random.default_rng(1)
    samples = rng.uniform(20.0, 40.0, (4, 32, 1))
    samples[2] = 80.0
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    spec = LikelihoodSpec.for_box(pop.lower, pop.upper)
    with pytest.raises(ValueError, match=r"source\(s\) \[2\]"):
        build_hier_lnprob(samples, pop, spec, device=CPU)


def test_dtype_not_prequantized():
    samples = np.random.default_rng(0).normal(35, 4, (4, 16, 1))
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf64 = HierarchicalFitter(samples, pop, dtype=torch.float64, nwalkers=8,
                              device=CPU)
    assert hf64.samples.dtype == np.float64
    hf32 = HierarchicalFitter(samples, pop, nwalkers=8, device=CPU)
    assert hf32.samples.dtype == np.float32


def test_tiny_verbose_run_survives(capsys):
    samples, _, _ = _population_setup(seed=5)
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    hf = HierarchicalFitter(samples[:4], pop, nwalkers=8, seed=1,
                            device=CPU)
    hf.run(nburn=5, nsteps=2, verbose=True)
    assert "nan" in capsys.readouterr().out
    assert hf.chain_free.shape[0] == 2


def test_selection_corrects_malmquist_bias():
    """A threshold-selected catalog: the uncorrected fit is biased high; with
    Selection the hyper-posterior matches a chain on the EXACT analytic
    selection-corrected marginal (the JAX twin is in its slow lane; here at
    64 samples per source, 4,096 injections and 100 + 400 steps against its
    128, 20,480 and 150 + 600)."""
    from scipy.special import ndtr as np_ndtr
    rng = np.random.default_rng(77)
    mu_t, sig_t, sig_obs, cut = 35.0, 4.0, 1.5, 35.0
    lo, hi = 10.0, 60.0
    theta_all = rng.normal(mu_t, sig_t, 400)
    x_all = theta_all + rng.normal(0, sig_obs, 400)
    x_s = x_all[x_all > cut][:64]
    S, N = x_s.size, 64
    assert S == 64
    samples = (x_s[:, None] + rng.normal(0, sig_obs, (S, N)))[..., None]
    pop = TruncatedGaussianPopulation.for_box(("T",), [lo], [hi])
    naive = HierarchicalFitter(samples, pop, nwalkers=64, seed=11,
                               device=CPU)
    naive.run(nburn=100, nsteps=300)
    mu_naive = naive.par_cen("mu_T")
    assert mu_naive[0] - mu_t > 2.0 * mu_naive[2], mu_naive

    inj = rng.uniform(lo, hi, (4096, 1))
    corr = HierarchicalFitter(samples, pop, nwalkers=64, seed=11,
                              device=CPU)
    corr.set_selection(inj, pdet=np_ndtr((inj[:, 0] - cut) / sig_obs))
    corr.run(nburn=100, nsteps=400)
    assert corr.selection_neff() > 4 * S
    xs = _t32(x_s)

    def oracle_lnprob(phi):
        mu, sig = phi[..., :1], phi[..., 1:2]
        s2 = sig * sig + sig_obs * sig_obs
        lnl = torch.sum(-0.5 * (xs - mu) ** 2 / s2 - 0.5 * torch.log(s2),
                        dim=-1)
        alpha = torch.special.ndtr((mu[..., 0] - cut)
                                   / torch.sqrt(s2[..., 0]))
        lnl = lnl - S * torch.log(torch.clamp(alpha, min=1e-30))
        return torch.where(_inbox(phi, lo, hi, pop), lnl,
                           torch.full_like(lnl, -1e30))

    oracle = _oracle_chain(oracle_lnprob, lo, hi, pop, 5, 100, 400)
    for i, name in enumerate(("mu_T", "sigma_T")):
        got = corr.par_cen(name)
        med_o = np.median(oracle[:, i])
        width_o = np.subtract(*np.percentile(oracle[:, i], [84.15, 15.85]))
        assert abs(got[0] - med_o) < 0.4 * width_o, (name, got, med_o)
        assert abs(got[1] + got[2] - width_o) < 0.3 * width_o, (name, got)
    mu_c = corr.par_cen("mu_T")
    assert abs(mu_c[0] - mu_t) < 3.0 * max(mu_c[1], mu_c[2]), mu_c


def test_selection_found_injection_form():
    from scipy.special import ndtr as np_ndtr
    rng = np.random.default_rng(3)
    lo, hi, sig_obs, cut = 10.0, 60.0, 1.5, 30.0
    M = 65536
    inj = rng.uniform(lo, hi, (M, 1))
    pdet = np_ndtr((inj[:, 0] - cut) / sig_obs)
    found = rng.uniform(0, 1, M) < pdet
    sel_w = Selection.from_injections(inj, pdet=pdet, box=([lo], [hi]))
    sel_f = Selection.from_injections(inj[found], n_total=M,
                                      box=([lo], [hi]))
    samples = rng.normal(40.0, 3.0, (8, 64, 1))
    pop = TruncatedGaussianPopulation.for_box(("T",), [lo], [hi])
    spec = LikelihoodSpec.for_box(pop.lower, pop.upper)
    lnp_w, _ = build_hier_lnprob(samples, pop, spec, selection=sel_w,
                                 device=CPU)
    lnp_f, _ = build_hier_lnprob(samples, pop, spec, selection=sel_f,
                                 device=CPU)
    phis = _t32([[40.0, 3.0], [35.0, 6.0], [45.0, 2.0]])
    diffs = (lnp_w(phis) - lnp_f(phis)).numpy()
    assert np.max(np.abs(diffs)) < 0.5, diffs


def test_selection_validation_and_persistence(tmp_path):
    rng = np.random.default_rng(1)
    inj = rng.uniform(10.0, 60.0, (128, 1))
    with pytest.raises(ValueError, match="box"):
        Selection.from_injections(inj)
    with pytest.raises(ValueError, match="n_total"):
        Selection.from_injections(inj, n_total=5, box=([10.0], [60.0]))
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        Selection.from_injections(inj, pdet=np.full(128, 1.5),
                                  box=([10.0], [60.0]))
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    spec = LikelihoodSpec.for_box(pop.lower, pop.upper)
    samples = rng.normal(35.0, 3.0, (4, 32, 1))
    bad = Selection.from_injections(np.full((16, 1), 99.0),
                                    box=([10.0], [60.0]))
    with pytest.raises(ValueError, match="injections"):
        build_hier_lnprob(samples, pop, spec, selection=bad, device=CPU)
    hf = HierarchicalFitter(samples, pop, nwalkers=8, seed=2, device=CPU)
    hf.set_selection(inj)
    hf.run(nburn=20, nsteps=40)
    path = os.path.join(tmp_path, "s.h5")
    hf.writeToHDF5(path)
    back = HierarchicalFitter.from_h5(path, device=CPU)
    assert back.selection is not None
    np.testing.assert_allclose(back.selection.injections, inj)
    assert back.selection.n_total == 128
    assert np.isfinite(back.selection_neff(phi=[35.0, 5.0]))
