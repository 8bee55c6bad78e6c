"""Simulation-based calibration of the port's inference pipeline: the twin
of tests/test_sbc.py on mbb_emcee_tpu_torch.

Draw many truths from the prior, simulate data from the likelihood's own
noise model, fit each, and evaluate each posterior's CDF at its truth:
under correct inference the ranks are Uniform(0, 1). The eleven pipeline
variants and the hierarchy's hyper level of tests/test_sbc.py run here
through the port's entry points of the same names, at that test's truths
(numpy seeds 20260818 and 20260819), noise model, S, depths, priors, boxes
and walker counts, held to its thresholds: KS < 2.3 / sqrt(S),
|mean - 0.5| < 0.10, 0.6 / 12 < var < 1.6 / 12, at most 15% of ranks
below 0.02 or above 0.98. The whole variants are the slow lane
(`--runslow`); tier-1 holds the data generator against the JAX test's,
the rank checker against its inline computation, and two batch modes'
wiring at a small S.

This module imports no jax at its top: chip_smoke.py runs `sbc_ranks` and
`sbc_hierarchy_ranks` on the card (phases 29 and 30) on a machine without
it. The forward model is the port's (`mbb_fnu`, `log_mbb_fnu`,
`ResponseSet`, `photoz_mbb`), so the truths' fluxes come from the port.
"""

import numpy as np
import pytest
import torch

from mbb_emcee_tpu_torch import MultiFitter, ResponseSet
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape, mbb_fnu

WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])

# The SBC prior: uniform over this box (set as the fitter's limits, so the
# sampled prior IS the drawing prior).
BOX = {"T": (15.0, 60.0), "beta": (0.8, 3.0), "fnorm": (10.0, 200.0)}

SHAPE = MBBShape(opthin=True, noalpha=True)

MODES = ("plain", "response", "correlated", "hmc", "pt", "map_is", "nested",
         "sedmulti", "single", "single_map_init", "photoz")

# Depths of tests/test_sbc.py; a caller may pass shorter ones (the tier-1
# wiring test) as `depth`.
DEPTH = {"nburn": 250, "nsteps": 600}
PHOTOZ_DEPTH = {"nburn": 400, "nsteps": 800}
# The hyper-level SBC: replications, sources, posterior draws per source,
# the interim box (a flat interim prior), the hyper-prior boxes (the
# population kept well inside the interim box), the measurement sigma, and
# the fit.
HIER = {"M": 32, "S": 32, "N": 256, "box": (10.0, 60.0),
        "mu_box": (25.0, 45.0), "sig_box": (2.0, 6.0), "sig_obs": 1.5,
        "nwalkers": 32, "seed0": 100, "nburn": 200, "nsteps": 500}


def sbc_size(mode):
    """The JAX test's S: 32 for the single-fit modes, else 48."""
    return 32 if mode.startswith("single") else 48


def point_flux(t):
    """The port's MBB fluxes at WAVE, fp32 on the CPU, as fp64 numpy."""
    return mbb_fnu(torch.as_tensor(np.asarray(t), dtype=torch.float32),
                   torch.as_tensor(WAVE, dtype=torch.float32),
                   SHAPE).double().numpy()


def make_responses():
    rs = ResponseSet()
    rs.add("B100", "gauss:100:35")
    rs.add("B160", "gauss:160:60")
    rs.add("B250", "box:250:70")
    rs.add("B350", "box:350:90")
    rs.add("B500", "gauss:500:150")
    return rs


def sbc_data(mode, S):
    """(rng, trues (S, 5), flux (S, 5), unc (S, 5), band names, band
    correlation, ResponseSet): tests/test_sbc.py's draws in its order;
    `rng` continues after them (the photo-z mode draws its own truths
    from it)."""
    rng = np.random.default_rng(20260818)
    trues = np.column_stack([
        rng.uniform(*BOX["T"], S),
        rng.uniform(*BOX["beta"], S),
        np.full(S, 250.0),                 # inert under opthin
        np.full(S, 4.0),                   # inert under noalpha
        rng.uniform(*BOX["fnorm"], S),
    ])
    rs = names = corr = None
    if mode == "response":
        rs = make_responses()
        names = list(rs.keys())

        def forward(t):
            tt = torch.as_tensor(np.asarray(t), dtype=torch.float32)
            return np.array([rs[n](lambda w: mbb_fnu(tt, w, SHAPE))
                             for n in names])
    else:
        forward = point_flux
    if mode == "correlated":
        corr = 0.4 * np.ones((WAVE.size, WAVE.size)) + 0.6 * np.eye(WAVE.size)
        L = np.linalg.cholesky(corr)
    flux, unc = [], []
    for t in trues:
        f = forward(t)
        u = 0.05 * f
        noise = (u * (L @ rng.standard_normal(WAVE.size))
                 if mode == "correlated"
                 else u * rng.standard_normal(WAVE.size))
        flux.append(f + noise)
        unc.append(u)
    return rng, trues, np.array(flux), np.array(unc), names, corr, rs


def photoz_truths(rng, S):
    """The photo-z mode's truths, drawn from `rng` after sbc_data's draws:
    T rejection-drawn from the box-truncated N(38, 6), z uniform on
    (0.5, 6)."""
    t_draw = []
    while len(t_draw) < S:
        cand = rng.normal(38.0, 6.0)
        if BOX["T"][0] < cand < BOX["T"][1]:
            t_draw.append(cand)
    return np.column_stack([
        np.asarray(t_draw),
        rng.uniform(*BOX["beta"], S),
        np.full(S, 250.0),                 # inert (opthin)
        np.full(S, 4.0),                   # inert (noalpha)
        rng.uniform(*BOX["fnorm"], S),
        rng.uniform(0.5, 6.0, S),
    ])


def _chain_ranks(chain, trues, names, idx):
    """F_post(truth) per free parameter x source from a (S, nw, nrec, P)
    full-space chain."""
    S = chain.shape[0]
    ranks = []
    for name in names:
        flat = chain[..., idx[name]].reshape(S, -1)
        ranks.append((flat < trues[:, idx[name]][:, None]).mean(axis=1))
    return np.concatenate(ranks)


def _boxed(fitter):
    for name, (lo, hi) in BOX.items():
        fitter.set_lowlim(name, lo)
        fitter.set_uplim(name, hi)
    return fitter


def sbc_ranks(mode, S=None, device="cpu", depth=None):
    """(ranks, S, info) of SBC mode `mode` through the port's entry point
    of that name on `device`: 3 x S ranks (4 x S for photo-z) in [0, 1];
    info["graph_mode"] names the mode of the plain stretch step where the
    variant runs one (sedmulti, photoz), and of the HMC transition (hmc).
    `depth` ({"nburn", "nsteps"}) replaces the JAX test's depth of the
    stretch-move and SEDMultiFitter modes."""
    S = sbc_size(mode) if S is None else S
    rng, trues, flux, unc, names, corr, rs = sbc_data(mode, S)
    idx = {"T": 0, "beta": 1, "fnorm": 4}
    depth = dict(DEPTH if depth is None else depth)
    info = {}
    kw = {} if rs is None else {"responses": rs}
    mf = _boxed(MultiFitter(nwalkers=64, opthin=True, noalpha=True, seed=99,
                            device=device, **kw))
    mf.set_data(WAVE, flux, unc, band_names=names)
    if corr is not None:
        mf.set_band_correlation(corr)

    if mode in ("single", "single_map_init"):
        # S independent MBBFitter runs through the whole burn -> re-center
        # -> re-burn -> production protocol; single_map_init through
        # fit_map -> run(init="map")
        from mbb_emcee_tpu_torch import MBBFitter
        ranks = [[] for _ in range(3)]
        for s in range(S):
            fit = _boxed(MBBFitter(nwalkers=64, opthin=True, noalpha=True,
                                   seed=1000 + s, device=device))
            fit.set_data(WAVE, flux[s], unc[s])
            if mode == "single_map_init":
                fit.fit_map(nstarts=4)
                fit.run(nburn=60, nsteps=600, thin=2, init="map")
            else:
                fit.run(thin=2, **depth)
            chain = fit.chain                      # (nwalkers, nrec, 5)
            for p, name in enumerate(fit.free_param_names):
                flat = chain[..., idx[name]].ravel()
                ranks[p].append((flat < trues[s, idx[name]]).mean())
        return np.concatenate([np.asarray(r) for r in ranks]), S, info

    if mode == "map_is":
        # MAP + Laplace importance sampling: the WEIGHTED CDF at truth
        mf.run_map(nstarts=4)
        ess = mf.map_importance(1024)
        info["median ess / N"] = float(np.median(ess) / 1024)
        assert info["median ess / N"] > 0.3        # healthy proposals
        w = np.exp(mf.map_logw - mf.map_logw.max(axis=1, keepdims=True))
        w /= w.sum(axis=1, keepdims=True)           # (S, N)
        ranks = []
        for p, name in enumerate(mf.free_param_names):
            below = mf.map_samples[:, :, p] < trues[:, idx[name]][:, None]
            ranks.append((w * below).sum(axis=1))
        return np.concatenate(ranks), S, info

    if mode == "sedmulti":
        # the generic batch pipeline on the wrapped MBB
        from mbb_emcee_tpu_torch import SEDModel, SEDMultiFitter
        from mbb_emcee_tpu_torch.models.modified_blackbody import (
            log_mbb_fnu)

        def fnu(theta, wave):
            return torch.exp(log_mbb_fnu(theta, wave, SHAPE))

        model = SEDModel(
            fnu=fnu, param_names=("T", "beta", "lambda0", "alpha", "fnorm"),
            lower=[BOX["T"][0], BOX["beta"][0], 1.0, 0.01, BOX["fnorm"][0]],
            upper=[BOX["T"][1], BOX["beta"][1], 2e4, 60.0, BOX["fnorm"][1]],
            name="mbb-wrapped")
        smf = SEDMultiFitter(model, nwalkers=64, seed=99, device=device)
        smf.fix_param("lambda0", 250.0).fix_param("alpha", 4.0)
        smf.set_data(WAVE, flux, unc)
        smf.set_param_init("T", 37.5, 10.0)
        smf.set_param_init("fnorm", 105.0, 40.0)
        smf.run(thin=2, **depth)
        info["graph_mode"] = smf._sampler.graph_mode
        return (_chain_ranks(smf.chain, trues, smf.free_param_names, idx),
                S, info)

    if mode == "photoz":
        # z sampled under a Gaussian T prior; the drawing prior is the
        # sampling prior
        from mbb_emcee_tpu_torch import SEDMultiFitter
        from mbb_emcee_tpu_torch.photoz import photoz_mbb
        model = photoz_mbb(opthin=True, noalpha=True, cmb=True,
                           z_upper=10.0)
        trues_pz = photoz_truths(rng, S)
        flux_pz, unc_pz = [], []
        for t in trues_pz:
            f = model.fnu(torch.as_tensor(t, dtype=torch.float32),
                          torch.as_tensor(WAVE, dtype=torch.float32)
                          ).double().numpy()
            u = 0.05 * f
            flux_pz.append(f + u * rng.standard_normal(WAVE.size))
            unc_pz.append(u)
        smf = _boxed(SEDMultiFitter(model, nwalkers=64, seed=99,
                                    device=device))
        smf.fix_param("lambda0", 250.0).fix_param("alpha", 4.0)
        smf.set_lowlim("z", 0.5)
        smf.set_uplim("z", 6.0)
        smf.set_gaussian_prior("T", 38.0, 6.0)
        smf.set_data(WAVE, np.array(flux_pz), np.array(unc_pz))
        smf.set_param_init("T", 38.0, 5.0)
        smf.set_param_init("fnorm", 105.0, 40.0)
        smf.set_param_init("z", 3.25, 1.3)
        smf.run(thin=2, **(PHOTOZ_DEPTH if depth == DEPTH else depth))
        info["graph_mode"] = smf._sampler.graph_mode
        idx_pz = {"T": 0, "beta": 1, "fnorm": 4, "z": 5}
        return (_chain_ranks(smf.chain, trues_pz, smf.free_param_names,
                             idx_pz), S, info)

    if mode == "nested":
        # the weighted dead points are posterior samples: the WEIGHTED CDF
        ev = mf.compute_evidence(nlive=512, nbatch=32, nsteps=16, seed=7)
        assert np.all(np.isfinite(ev.logz))
        w = ev.posterior_weights()                     # (S, n)
        ranks = []
        for name in BOX:        # the free parameters (no run() needed)
            below = ev.samples[:, :, idx[name]] < trues[:, idx[name]][:, None]
            ranks.append((w * below).sum(axis=1))
        info["n_iter max"] = int(np.max(ev.n_iter))
        return np.concatenate(ranks), S, info

    if mode == "hmc":
        mf.run_hmc(nwarmup=300, nsteps=600, thin=2)
        info["graph_mode"] = mf._hmc_mode
    elif mode == "pt":
        mf.run_pt(nrungs=8, nburn=250, nsteps=600, thin=2)
    else:
        mf.run(thin=2, **depth)
    info["backend"] = getattr(mf, "_backend_used", None)
    return (_chain_ranks(mf.chain, trues, mf.free_param_names, idx), S,
            info)


def hierarchy_replications(M=None):
    """tests/test_sbc.py's hyper-level draws, one replication at a time:
    (mu_t, sig_t, samples (S, N, 1)) from numpy seed 20260819. Each draws
    (mu, sigma) from the hyper-prior box, a catalog of S sources from that
    population and N exact posterior draws per source (a Gaussian
    measurement model)."""
    rng = np.random.default_rng(20260819)
    S, N = HIER["S"], HIER["N"]
    for _ in range(HIER["M"] if M is None else M):
        mu_t = rng.uniform(*HIER["mu_box"])
        sig_t = rng.uniform(*HIER["sig_box"])
        theta_s = rng.normal(mu_t, sig_t, S)   # truncation negligible
        x_s = theta_s + rng.normal(0.0, HIER["sig_obs"], S)
        samples = (x_s[:, None]
                   + rng.normal(0.0, HIER["sig_obs"], (S, N)))[..., None]
        yield mu_t, sig_t, samples


def hierarchy_population(population_cls):
    """The JAX test's population: `population_cls` (the port's or the JAX
    package's TruncatedGaussianPopulation) over the interim box, sigma
    held to the hyper-prior's box."""
    return population_cls.for_box(
        ("T",), [HIER["box"][0]], [HIER["box"][1]],
        sigma_min=HIER["sig_box"][0], sigma_max=HIER["sig_box"][1])


def sbc_hierarchy_ranks(device="cpu", M=None):
    """(ranks (2M,), M, graph modes): tests/test_sbc.py's hyper-level SBC.
    Each replication of hierarchy_replications is fitted with
    HierarchicalFitter.run(200, 500) at 32 walkers, seed 100 + m, and the
    hyper-truth ranked in the hyper chain (mu ranks first, then sigma)."""
    from mbb_emcee_tpu_torch.hierarchy import (
        HierarchicalFitter, TruncatedGaussianPopulation)
    M = HIER["M"] if M is None else M
    pop = hierarchy_population(TruncatedGaussianPopulation)
    mu_ranks, sig_ranks, modes = [], [], []
    for m, (mu_t, sig_t, samples) in enumerate(hierarchy_replications(M)):
        hf = HierarchicalFitter(samples, pop, nwalkers=HIER["nwalkers"],
                                seed=HIER["seed0"] + m, device=device)
        # sampled hyper-prior == drawing prior (the SBC requirement)
        hf.set_lowlim("mu_T", HIER["mu_box"][0])
        hf.set_uplim("mu_T", HIER["mu_box"][1])
        hf.run(nburn=HIER["nburn"], nsteps=HIER["nsteps"])
        modes.append(hf._sampler.graph_mode)
        flat = np.asarray(hf.flatchain)
        mu_ranks.append(float((flat[:, 0] < mu_t).mean()))
        sig_ranks.append(float((flat[:, 1] < sig_t).mean()))
    return np.asarray(mu_ranks + sig_ranks), M, modes


def rank_stats(ranks, S):
    """The JAX test's statistics of `ranks` against U(0, 1) and its
    thresholds for S independent replications: KS distance, mean,
    variance, the shares below 0.02 and above 0.98, and `ok` (every
    threshold met)."""
    ranks = np.asarray(ranks, np.float64)
    n = ranks.size
    grid = np.sort(ranks)
    st = {"ks": float(np.max(np.abs(grid - np.arange(1, n + 1) / n))),
          "ks_max": 2.3 / np.sqrt(S), "mean": float(ranks.mean()),
          "var": float(ranks.var()), "low": float((ranks < 0.02).mean()),
          "high": float((ranks > 0.98).mean())}
    st["ok"] = bool(st["ks"] < st["ks_max"]
                    and abs(st["mean"] - 0.5) < 0.10
                    and 0.6 / 12 < st["var"] < 1.6 / 12
                    and st["low"] < 0.15 and st["high"] < 0.15)
    return st


def assert_uniform(tag, ranks, S):
    """tests/test_sbc.py's assertions on `ranks`."""
    st = rank_stats(ranks, S)
    assert st["ks"] < st["ks_max"], f"[{tag}] ranks not uniform: KS=" \
        f"{st['ks']:.3f}"
    assert abs(st["mean"] - 0.5) < 0.10, (tag, st["mean"])
    assert 0.6 / 12 < st["var"] < 1.6 / 12, (tag, st["var"])
    assert st["low"] < 0.15, tag
    assert st["high"] < 0.15, tag
    return st


# -- tier-1: the data generator, the checker, the wiring ---------------------

@pytest.mark.parametrize("mode", ["plain", "correlated", "photoz"])
def test_point_data_match_the_jax_test(mode):
    """sbc_data's truths, fluxes and uncertainties (and the photo-z mode's
    truths and fluxes) against tests/test_sbc.py's draws from the same
    seed, the JAX package's mbb_fnu in point mode (rtol 1e-6)."""
    import jax.numpy as jnp
    from tests import test_sbc as jt
    S = 48
    rng, trues, flux, unc, _, corr, _ = sbc_data(mode, S)
    jrng = np.random.default_rng(20260818)
    jtrues = np.column_stack([
        jrng.uniform(*jt.BOX["T"], S), jrng.uniform(*jt.BOX["beta"], S),
        np.full(S, 250.0), np.full(S, 4.0),
        jrng.uniform(*jt.BOX["fnorm"], S)])
    np.testing.assert_array_equal(trues, jtrues)
    if mode == "correlated":
        L = np.linalg.cholesky(corr)
    for s, t in enumerate(jtrues):
        f = jt._point_flux(t)
        u = 0.05 * f
        noise = (u * (L @ jrng.standard_normal(WAVE.size))
                 if mode == "correlated"
                 else u * jrng.standard_normal(WAVE.size))
        np.testing.assert_allclose(flux[s], f + noise, rtol=1e-6)
        np.testing.assert_allclose(unc[s], u, rtol=1e-6)
    if mode != "photoz":
        return
    from mbb_emcee_tpu.photoz import photoz_mbb as j_photoz_mbb
    from mbb_emcee_tpu_torch.photoz import photoz_mbb
    tz = photoz_truths(rng, S)
    jmodel = j_photoz_mbb(opthin=True, noalpha=True, cmb=True, z_upper=10.0)
    t_draw = []
    while len(t_draw) < S:
        cand = jrng.normal(38.0, 6.0)
        if jt.BOX["T"][0] < cand < jt.BOX["T"][1]:
            t_draw.append(cand)
    jtz = np.column_stack([
        np.asarray(t_draw), jrng.uniform(*jt.BOX["beta"], S),
        np.full(S, 250.0), np.full(S, 4.0),
        jrng.uniform(*jt.BOX["fnorm"], S), jrng.uniform(0.5, 6.0, S)])
    np.testing.assert_array_equal(tz, jtz)
    model = photoz_mbb(opthin=True, noalpha=True, cmb=True, z_upper=10.0)
    for t in tz[:8]:
        got = model.fnu(torch.as_tensor(t, dtype=torch.float32),
                        torch.as_tensor(WAVE, dtype=torch.float32)).numpy()
        want = np.asarray(jmodel.fnu(jnp.asarray(t, jnp.float32),
                                     jnp.asarray(WAVE, jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_response_data_match_the_jax_test():
    """Response mode: the band-integrated truths' fluxes against
    tests/test_sbc.py's _make_responses on the JAX package's mbb_fnu, at
    tests/test_torch_response.py's tolerance (rtol 1e-5), and the same
    noise draws."""
    import jax.numpy as jnp
    from mbb_emcee_tpu.models.modified_blackbody import mbb_fnu as j_mbb_fnu
    from tests import test_sbc as jt
    S = 48
    _, trues, flux, unc, names, _, rs = sbc_data("response", S)
    jrs = jt._make_responses()
    assert names == list(jrs.keys())
    jrng = np.random.default_rng(20260818)
    for name in ("T", "beta", "fnorm"):     # the truths' draws
        jrng.uniform(*jt.BOX[name], S)
    for s, t in enumerate(trues):
        tj = jnp.asarray(t, jnp.float32)
        f = np.array([jrs[n](lambda w: j_mbb_fnu(tj, w, jt.SHAPE))
                      for n in names])
        u = 0.05 * f
        want = f + u * jrng.standard_normal(WAVE.size)
        np.testing.assert_allclose(unc[s], u, rtol=1e-5)
        np.testing.assert_allclose(flux[s], want, rtol=1e-5)


def test_hierarchy_data_match_the_jax_test(monkeypatch):
    """The hyper-level SBC's draws and fit settings against those of
    tests/test_sbc.py's own test: that test runs with the JAX package's
    HierarchicalFitter replaced by a recorder, which stops it after its
    last replication's run. Every replication's samples bitwise
    hierarchy_replications', and the same population box, walkers, seeds,
    mu_T limits and depths as sbc_hierarchy_ranks uses."""
    import mbb_emcee_tpu.hierarchy as jh
    from mbb_emcee_tpu_torch.hierarchy import TruncatedGaussianPopulation
    from tests import test_sbc as jt
    seen = []

    class Done(Exception):
        pass

    class Recorder:
        flatchain = np.zeros((1, 2))    # ranks the test reads, unchecked

        def __init__(self, samples, pop, nwalkers, seed):
            self.rec = {"samples": samples, "pop": pop,
                        "nwalkers": nwalkers, "seed": seed, "limits": {}}
            seen.append(self.rec)

        def set_lowlim(self, name, v):
            self.rec["limits"][("low", name)] = v
            return self

        def set_uplim(self, name, v):
            self.rec["limits"][("up", name)] = v
            return self

        def run(self, nburn, nsteps):
            self.rec["depth"] = (nburn, nsteps)
            if len(seen) == HIER["M"]:
                raise Done

    monkeypatch.setattr(jh, "HierarchicalFitter", Recorder)
    with pytest.raises(Done):
        jt.test_sbc_hierarchy_ranks_uniform()
    mine = list(hierarchy_replications())
    assert len(seen) == len(mine) == HIER["M"]
    pop = hierarchy_population(TruncatedGaussianPopulation)
    for m, (rec, (_, _, samples)) in enumerate(zip(seen, mine)):
        np.testing.assert_array_equal(rec["samples"], samples)
        assert samples.shape == (HIER["S"], HIER["N"], 1)
        assert rec["seed"] == HIER["seed0"] + m
        assert rec["nwalkers"] == HIER["nwalkers"]
        assert rec["depth"] == (HIER["nburn"], HIER["nsteps"])
        assert rec["limits"] == {("low", "mu_T"): HIER["mu_box"][0],
                                 ("up", "mu_T"): HIER["mu_box"][1]}
        assert tuple(rec["pop"].param_names) == tuple(pop.param_names)
        for field in ("box_lower", "box_upper", "sigma_min", "sigma_max",
                      "lower", "upper"):
            np.testing.assert_array_equal(
                np.asarray(getattr(rec["pop"], field)),
                np.asarray(getattr(pop, field)))


def _jax_inline(ranks, S):
    """tests/test_sbc.py's inline computation, verbatim in numpy."""
    n = ranks.size
    grid = np.sort(ranks)
    ks = np.max(np.abs(grid - (np.arange(1, n + 1) / n)))
    ok = (ks < 2.3 / np.sqrt(S) and abs(ranks.mean() - 0.5) < 0.10
          and 0.6 / 12 < ranks.var() < 1.6 / 12
          and (ranks < 0.02).mean() < 0.15 and (ranks > 0.98).mean() < 0.15)
    return ks, ranks.mean(), ranks.var(), bool(ok)


@pytest.mark.parametrize("case", ["uniform", "too_narrow", "biased",
                                  "edges", "too_wide"])
def test_rank_checker_matches_the_jax_inline_computation(case):
    """rank_stats and assert_uniform against the JAX test's inline KS,
    mean, variance and edge checks on fixed rank arrays: the same numbers
    and the same verdict."""
    rng = np.random.default_rng(5)
    S = 48
    ranks = {"uniform": (np.arange(3 * S) + 0.5) / (3 * S),
             "too_narrow": rng.beta(0.5, 0.5, 3 * S),
             "biased": np.clip(rng.uniform(0.1, 1.2, 3 * S), 0, 1),
             "edges": np.r_[np.zeros(30), rng.uniform(size=3 * S - 30)],
             "too_wide": rng.beta(4.0, 4.0, 3 * S)}[case]
    ks, mean, var, ok = _jax_inline(ranks, S)
    st = rank_stats(ranks, S)
    assert (st["ks"], st["mean"], st["var"]) == (ks, mean, var)
    assert st["ok"] == ok == (case == "uniform")
    if ok:
        assert_uniform(case, ranks, S)
    else:
        with pytest.raises(AssertionError):
            assert_uniform(case, ranks, S)


@pytest.mark.parametrize("mode", ["plain", "sedmulti"])
def test_batch_mode_wiring(mode):
    """One short run at S = 4 per batch mode: 3 x S ranks, finite, in
    [0, 1] (the wiring of sbc_ranks, not calibration)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks, S, info = sbc_ranks(mode, S=4, device="cpu",
                                   depth={"nburn": 10, "nsteps": 20})
    finally:
        torch.set_num_threads(threads)
    assert S == 4 and ranks.shape == (12,)
    assert np.all(np.isfinite(ranks))
    assert np.all((ranks >= 0.0) & (ranks <= 1.0))
    if mode == "sedmulti":
        assert info["graph_mode"] == ("eager",)   # the CPU's step


# -- the slow lane: the whole variants ---------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("mode", MODES)
def test_sbc_ranks_uniform(mode):
    ranks, S, _ = sbc_ranks(mode, device="cpu")
    assert_uniform(mode, ranks, S)


@pytest.mark.slow
def test_sbc_hierarchy_ranks_uniform():
    ranks, M, _ = sbc_hierarchy_ranks(device="cpu")
    # mu and sigma ranks of one replication are correlated; the threshold
    # is keyed to M independent replications
    assert_uniform("hierarchy", ranks, M)
