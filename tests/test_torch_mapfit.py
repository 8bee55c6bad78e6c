"""MAP + Laplace triage in the port against the JAX package on the CPU: the
unrolled small-SPD linear algebra, the gradients of the plain likelihood
(the merge solve's tree bisection included), map_core from shared starts,
the degenerate 5-parameter fit, MultiFitter.run_map against single fits,
the init="map" walker balls, Laplace importance sampling, the staleness
guards, and MAPFit files crossing between the packages; then the port's
twins of tests/test_mapfit.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu as J  # noqa: E402
import mbb_emcee_tpu.fitter as jfitter  # noqa: E402
from mbb_emcee_tpu import mapfit as jmapfit  # noqa: E402
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
from mbb_emcee_tpu.ops import smalllinalg as jsl  # noqa: E402
import mbb_emcee_tpu_torch as T  # noqa: E402
import mbb_emcee_tpu_torch.fitter as tfitter  # noqa: E402
from mbb_emcee_tpu_torch import mapfit  # noqa: E402
from mbb_emcee_tpu_torch.models import modified_blackbody as tmbb  # noqa: E402
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, mbb_fnu)
from mbb_emcee_tpu_torch.ops import smalllinalg as tsl  # noqa: E402
from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob  # noqa: E402
from mbb_emcee_tpu_torch.ops.rootfind import (  # noqa: E402
    bisect_newton_decreasing, bisect_tree_newton_decreasing)
from tools import validate_tpu_parity as vp  # noqa: E402

NB = 5
WAVE = np.linspace(100.0, 500.0, NB)
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])


def _mock(theta, shape, frac=0.03, seed=0):
    f = mbb_fnu(torch.tensor(theta, dtype=torch.float32),
                torch.tensor(WAVE, dtype=torch.float32),
                shape).double().numpy()
    unc = frac * f
    rng = np.random.default_rng(seed)
    return f + unc * rng.standard_normal(NB), unc


def _spec(pkg, cfg):
    """A parity config's spec in package `pkg` (T or J)."""
    import dataclasses
    spec = pkg.LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = vp.UPPER[0], vp.UPPER[1]
    for (pi, mean, sig) in cfg["priors"]:
        spec.prior_mean[pi] = mean
        spec.prior_isigma[pi] = 1.0 / sig
    if cfg["opthin"]:
        spec.fixed[2], spec.fixed_values[2] = True, vp.TRUE[2]
    if cfg["noalpha"]:
        spec.fixed[3], spec.fixed_values[3] = True, vp.TRUE[3]
    ub = cfg.get("uplim_band")
    if ub is not None:
        mask = np.zeros(NB, bool)
        mask[ub] = True
        spec = dataclasses.replace(spec, uplim_bands=mask)
    return spec


def _lnprobs(ci):
    """(JAX lnprob, port lnprob, free space) of parity config `ci` on the
    parity tool's data (config 3 on the JAX package's 65-node pack, the
    port's bit for bit)."""
    cfg = vp.CONFIGS[ci]
    flux, unc, cov = vp.mock_data(cfg)
    pack = names = None
    if cfg["response"]:
        _, pack = vp.response_pack()
        names = list(vp.BANDS)
    jl, _ = J.build_lnprob(
        J.Photometry(vp.WAVE, flux, unc, cov=cov, band_names=names),
        JShape(opthin=cfg["opthin"], noalpha=cfg["noalpha"]),
        _spec(J, cfg), response_pack=pack)
    tl, fs = T.build_lnprob(
        T.Photometry(vp.WAVE, flux, unc, cov=cov, band_names=names),
        MBBShape(opthin=cfg["opthin"], noalpha=cfg["noalpha"]),
        _spec(T, cfg), response_pack=pack, device="cpu")
    return jl, tl, fs


# -- ops/smalllinalg ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_smalllinalg_matches_jax_twin(n):
    """Cholesky, SPD solve and inverse on random SPD matrices, batched,
    against the JAX twin (rtol 1e-5), and the pivot floor on an
    indefinite matrix."""
    rng = np.random.default_rng(n)
    A0 = rng.standard_normal((7, n, n))
    A = (A0 @ np.swapaxes(A0, -1, -2) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((7, n)).astype(np.float32)
    At, bt = torch.tensor(A), torch.tensor(b)
    for got, want in (
            (tsl.cholesky_small(At), jsl.cholesky_small(jnp.asarray(A))),
            (tsl.spd_solve_small(At, bt),
             jsl.spd_solve_small(jnp.asarray(A), jnp.asarray(b))),
            (tsl.spd_inverse_small(At),
             jsl.spd_inverse_small(jnp.asarray(A)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    x = tsl.spd_solve_small(At.double(), bt.double()).numpy()
    np.testing.assert_allclose(
        x, np.stack([np.linalg.solve(A[i].astype(np.float64), b[i])
                     for i in range(7)]), rtol=1e-8)
    if n >= 2:
        bad = np.diag([1.0] + [-2.0] * (n - 1)).astype(np.float32)
        L = tsl.cholesky_small(torch.tensor(bad))
        assert torch.all(torch.isfinite(L))
        np.testing.assert_allclose(
            L.numpy(), np.asarray(jsl.cholesky_small(jnp.asarray(bad))),
            rtol=1e-5)


# -- gradients of the plain likelihood ----------------------------------------

@pytest.mark.parametrize("ci", [0, 1, 2, 3, 5, 6])
def test_lnprob_gradient_matches_jax(ci):
    """torch.autograd of the port's plain lnprob against jax.grad of the JAX
    one at 64 in-box points of each BASELINE config (rtol 1e-3), finite
    wherever JAX's is."""
    jl, tl, fs = _lnprobs(ci)
    free = fs.free_idx
    rng = np.random.default_rng(ci)
    th = (vp.TRUE[free][None] * rng.uniform(0.6, 1.4, (64, free.size))
          ).astype(np.float32)
    assert np.all((th > fs.lower) & (th < fs.upper))
    want = np.asarray(jax.vmap(jax.grad(jl))(jnp.asarray(th)), np.float64)
    x = torch.tensor(th, requires_grad=True)
    got, = torch.autograd.grad(tl(x).sum(), x)
    got = got.double().numpy()
    assert np.all(np.isfinite(got[np.isfinite(want)]))
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-6 * np.abs(want).max())


def test_merge_solve_derivative_follows_the_tree_bracket():
    """The merge solve's tree bisection (the plain twin of the lnprob
    kernel's) gives the sequential solve's bracket bit for bit, so its
    derivatives with respect to beta, lambda0 and alpha are the sequential
    solve's exactly, and both agree with jax.grad through the reference's
    jnp.where chain."""
    rng = np.random.default_rng(5)
    beta0 = rng.uniform(1.2, 2.6, 64)
    logx00 = rng.uniform(-1.0, 0.5, 64)
    alpha0 = rng.uniform(1.5, 6.0, 64)

    def solve(tree, beta, log_x0, alpha):
        def g(u):
            return tmbb._merge_g_and_gp(u, beta, log_x0, alpha, False)
        lo, hi = tmbb.merge_bracket(beta, alpha)
        if tree:
            return bisect_tree_newton_decreasing(g, lo, hi, rounds=2,
                                                 levels=3, newton_iters=2)
        return bisect_newton_decreasing(g, lo, hi, bisect_iters=6,
                                        newton_iters=2)

    grads = []
    for tree in (False, True):
        args = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
                for a in (beta0, logx00, alpha0)]
        u = solve(tree, *args)
        grads.append((u.detach(), torch.autograd.grad(u.sum(), args)))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)

    from mbb_emcee_tpu.models import modified_blackbody as jmbb

    def jsolve(beta, log_x0, alpha):
        return jmbb.merge_log_x(beta, log_x0, alpha, False)

    jg = jax.vmap(jax.grad(jsolve, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.float32) for a in (beta0, logx00, alpha0)))
    for a, b in zip(grads[0][1], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


# -- map_core from shared starts ----------------------------------------------

@pytest.mark.parametrize("ci", [1, 6])
def test_map_core_from_shared_starts_matches_jax(ci):
    """The same 8 unconstrained starts through both map_cores: the modes
    agree within 1e-3 Laplace sigma, lnp at the mode within 1e-3, the
    Laplace sigmas to rtol 1e-2."""
    jl, tl, fs = _lnprobs(ci)
    free = fs.free_idx
    x0 = (vp.TRUE[free][None] * np.random.default_rng(ci).uniform(
        0.8, 1.2, (8, free.size))).astype(np.float32)
    lower = np.asarray(fs.lower, np.float32)
    width = np.asarray(fs.upper - fs.lower, np.float32)
    u0 = np.asarray(jmapfit._to_unconstrained(jnp.asarray(x0), lower,
                                              width))
    ju, jlnp = jax.jit(lambda u: jmapfit.map_core(
        jl, lower, width, u, 150, 12, 0.1))(jnp.asarray(u0))
    jx = lower + width * jax.nn.sigmoid(ju)
    jcov, _ = jmapfit.laplace_cov_host(np.asarray(
        jmapfit.neg_hessian(jl, jx), np.float64))
    lo, wd = torch.tensor(lower), torch.tensor(width)
    tu, tlnp = mapfit.map_core(tl, lo, wd, torch.tensor(u0), 150, 12, 0.1)
    tx = lo + wd * torch.sigmoid(tu)
    tH, _ = mapfit.neg_hessian(tl, tx)
    tcov, _ = mapfit.laplace_cov_host(tH.double().numpy())
    sig = np.sqrt(np.diag(jcov))
    assert np.all(np.abs(tx.double().numpy() - np.asarray(jx)) < 1e-3 * sig)
    assert abs(float(tlnp) - float(jlnp)) < 1e-3
    np.testing.assert_allclose(np.sqrt(np.diag(tcov)), sig, rtol=1e-2)
    # the mode is interior in both
    assert mapfit.interior_mask(tx.double().numpy(), np.sqrt(np.diag(tcov)),
                                fs.lower, fs.upper)


def test_map_fit_batches_over_a_leading_axis():
    """map_fit over (S, nstarts, nfree) with a leading source axis gives
    each source its own single fit (rows do not interact)."""
    _, tl, fs = _lnprobs(1)
    free = fs.free_idx
    x0 = torch.tensor((vp.TRUE[free][None, None] * np.random.default_rng(
        2).uniform(0.8, 1.2, (2, 4, free.size))).astype(np.float32))

    def batched(x):
        return tl(x.reshape(-1, free.size)).reshape(x.shape[:-1])

    xb, lb, Hb, gb = mapfit.map_fit(batched, fs.lower, fs.upper, x0, 150,
                                    12, 0.1)
    assert xb.shape == (2, free.size) and Hb.shape == (2, 4, 4)
    for s in range(2):
        # the same optimizer per row; only the CPU's vectorized and scalar
        # transcendentals may round differently at another batch width
        xs, ls, Hs, gs = mapfit.map_fit(tl, fs.lower, fs.upper, x0[s], 150,
                                        12, 0.1)
        sig = np.sqrt(np.diag(mapfit.laplace_cov_host(Hs)[0]))
        assert np.all(np.abs(xb[s] - xs) < 1e-3 * sig)
        assert abs(lb[s] - ls) < 1e-3
        np.testing.assert_allclose(Hb[s], Hs, rtol=1e-2,
                                   atol=1e-4 * np.abs(Hs).max())


# -- the fitter surfaces against the JAX package --------------------------------

def test_fit_map_degenerate_flags_non_interior_in_both_packages():
    """The exactly-determined 5-parameter/5-band fit has a flat T-lambda0
    ridge: both packages return finite (floored) sigmas and flag the mode
    non-interior."""
    flux, unc = _mock(TRUE, MBBShape())
    for fit in (T.MBBFitter(nwalkers=64, seed=5, device="cpu"),
                J.MBBFitter(nwalkers=64, seed=5)):
        fit.set_data(WAVE, flux, unc)
        fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
        r = fit.fit_map()
        assert np.all(np.isfinite(r.sigma))
        assert not r.interior


def _map_result(nfree, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nfree, nfree))
    cov = A @ A.T + np.eye(nfree)
    x = np.array([30.0, 1.8, 40.0])[:nfree]
    sig = np.sqrt(np.diag(cov))
    sig[0] = 500.0                 # a floored direction: the 10x cap bites
    return jmapfit.MAPResult(x=x, lnprob=-3.0, cov=cov, sigma=sig,
                             interior=True, grad_norm=1e-3)


class _Stop(Exception):
    pass


def test_init_map_ball_equals_jax_from_the_same_map_result(monkeypatch):
    """MBBFitter.run(init="map"): the center and scatter handed to the walker
    ball equal the JAX package's from the same map_result (2 Laplace sigmas,
    capped at 10x the default scatter)."""
    flux, unc = _mock(TRUE, MBBShape(opthin=True, noalpha=True))
    seen = {}

    def spy(pkg):
        def ball(gen, center, scatter, *a, **k):
            seen[pkg] = (np.asarray(center, np.float64),
                         np.asarray(scatter, np.float64))
            raise _Stop
        return ball

    monkeypatch.setattr(jfitter, "make_initial_ball", spy("jax"))
    monkeypatch.setattr(tfitter, "make_initial_ball", spy("torch"))
    tfit = T.MBBFitter(nwalkers=16, opthin=True, noalpha=True, device="cpu")
    for name, fit in (("torch", tfit),
                      ("jax", J.MBBFitter(nwalkers=16, opthin=True,
                                          noalpha=True))):
        fit.set_data(WAVE, flux, unc)
        fit.map_result = _map_result(3)
        fit._require_map_fresh = lambda what: None
        with pytest.raises(_Stop):
            fit.run(nburn=2, nsteps=2, init="map")
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert seen["torch"][1][0] == 10.0 * tfit._scatter[0]


def test_multi_init_map_centers_equal_jax_from_the_same_results(monkeypatch):
    """MultiFitter._init_centers("map") from the same stored run_map results
    equals the JAX package's, centers and scatters."""
    rng = np.random.default_rng(4)
    S = 3
    flux = np.stack([_mock(TRUE, MBBShape(), seed=i)[0] for i in range(S)])
    unc = np.stack([_mock(TRUE, MBBShape(), seed=i)[1] for i in range(S)])
    params = np.tile(TRUE, (S, 1)) * rng.uniform(0.9, 1.1, (S, 1))
    sigma = np.abs(rng.standard_normal((S, 4))) * [1.0, 0.1, 2000.0, 5.0]
    out = []
    for mf in (T.MultiFitter(nwalkers=16, device="cpu", opthin=True),
               J.MultiFitter(nwalkers=16, opthin=True)):
        mf.set_data(WAVE, flux, unc)
        # both read only free_idx from the run_map free space
        mf.free_space = T.likelihood.FreeSpace.from_spec(
            mf._effective_spec())
        mf.map_params, mf.map_sigma = params.copy(), sigma.copy()
        mf._require_map_fresh = lambda what: None
        out.append(mf._init_centers("map"))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_map_importance_runs_the_fitters_lnprob():
    """MBBFitter.map_importance evaluates its draws with the batched lnprob
    (the kernel wrapper; its plain version for CPU tensors, so no launch
    here) and gives the weights of a direct host computation."""
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = _mock(TRUE, shape, frac=0.02)
    fit = T.MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=5,
                      device="cpu")
    fit.set_data(WAVE, flux, unc)
    with pytest.raises(RuntimeError, match="fit_map"):
        fit.map_importance()
    fit.fit_map(nstarts=4)
    launches = mbb_lnprob.launches
    x, logw, ess = fit.map_importance(nsamples=256, seed=8)
    assert mbb_lnprob.launches == launches
    lnprob, _ = T.build_lnprob(fit.phot, shape, fit._effective_spec(),
                               device="cpu")
    lnp = lnprob(torch.tensor(x.astype(np.float32))).double().numpy()
    r = fit.map_result
    d = np.linalg.solve(np.linalg.cholesky(r.cov), (x - r.x).T).T
    lnq = (-0.5 * np.sum(d * d, axis=1)
           - np.sum(np.log(np.diag(np.linalg.cholesky(r.cov))))
           - 1.5 * np.log(2.0 * np.pi))
    want = lnp - lnq
    np.testing.assert_allclose(logw, want - want.max(), rtol=1e-6,
                               atol=1e-6)
    assert 0.0 < ess <= 256.0


def test_run_map_batched_matches_single_fits():
    """MultiFitter.run_map over a ragged batch (a missing band, a
    per-source upper limit) equals the port's single-source fit_map on the
    clean sources within the Laplace scale, and the JAX package's batched
    run_map on the same data within 0.2 sigma."""
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(8)
    S = 4
    trues = np.column_stack([
        rng.uniform(25.0, 40.0, S), rng.uniform(1.6, 2.1, S),
        np.full(S, 250.0), np.full(S, 4.0), rng.uniform(25.0, 55.0, S)])
    flux = np.stack([_mock(t, shape, seed=i)[0] for i, t in enumerate(trues)])
    unc = np.stack([_mock(t, shape, seed=i)[1] for i, t in enumerate(trues)])
    flux[2, 0] = np.nan
    unc[2, 0] = np.nan
    m = np.zeros((S, NB), bool)
    m[3, NB - 1] = True
    fits = []
    for mf in (T.MultiFitter(nwalkers=32, opthin=True, noalpha=True, seed=3,
                             device="cpu"),
               J.MultiFitter(nwalkers=32, opthin=True, noalpha=True,
                             seed=3)):
        mf.set_data(WAVE, flux, unc)
        mf.set_phot_upperlimits(m)
        mf.run_map(nstarts=4)
        fits.append(mf)
    tmf, jmf = fits
    free = tmf.free_space.free_idx
    np.testing.assert_array_equal(tmf.map_interior, jmf.map_interior)
    assert np.all(np.abs(tmf.map_params[:, free] - jmf.map_params[:, free])
                  < 0.2 * jmf.map_sigma + 1e-3)
    np.testing.assert_allclose(tmf.map_sigma, jmf.map_sigma, rtol=2e-2)
    assert np.all(tmf.map_cen("lambda0")[:, 1] == 0.0)
    for s in (0, 1):
        fit = T.MBBFitter(nwalkers=32, opthin=True, noalpha=True, seed=3,
                          device="cpu")
        fit.set_data(WAVE, flux[s], unc[s])
        r = fit.fit_map(nstarts=4)
        assert np.all(np.abs(r.x - tmf.map_params[s, free])
                      < 0.2 * r.sigma + 1e-3)


@pytest.fixture(scope="module")
def map_batch():
    """A 2-source port MultiFitter after run_map, map_importance and a
    short init="map" run."""
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = _mock(TRUE, shape)
    mf = T.MultiFitter(nwalkers=32, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    mf.set_data(WAVE, np.stack([flux, flux * 1.1]), np.stack([unc, unc]))
    mf.run_map(nstarts=4)
    mf.map_importance(nsamples=64)
    mf.run(nburn=20, nsteps=40, init="map")
    return mf


def test_map_files_cross_between_the_packages(map_batch, tmp_path):
    """The MAPFit group rides the batch file both ways (the port writes,
    the JAX package reads it back and writes its own, which the port
    reads); the MAP-only triage artifacts of both packages hold the same
    datasets."""
    import h5py
    mf = map_batch
    p1 = str(tmp_path / "port.h5")
    mf.writeToHDF5(p1)
    jmf = J.MultiFitter.from_h5(p1)
    for k in ("map_params", "map_sigma", "map_cov", "map_lnprob",
              "map_interior", "map_grad_norm"):
        np.testing.assert_array_equal(getattr(jmf, k), getattr(mf, k))
    assert jmf.map_cen("T").shape == (2, 2)
    p2 = str(tmp_path / "jax.h5")
    jmf.writeToHDF5(p2)
    back = T.MultiFitter.from_h5(p2, device="cpu")
    for k in ("map_params", "map_sigma", "map_interior"):
        np.testing.assert_array_equal(getattr(back, k), getattr(mf, k))
    np.testing.assert_array_equal(back.map_cen("T"), mf.map_cen("T"))
    # a reload binds its MAP results to the reloaded posterior and data
    back._require_map_fresh("check")
    pa, pb = str(tmp_path / "tmap.h5"), str(tmp_path / "jmap.h5")
    mf.write_map_h5(pa)
    jmf.write_map_h5(pb)
    with h5py.File(pa) as fa, h5py.File(pb) as fb:
        assert set(fa.keys()) == set(fb.keys())
        assert set(fa["MAPFit"].keys()) == set(fb["MAPFit"].keys())
        assert set(fa.attrs.keys()) == set(fb.attrs.keys())
        for k in fa["MAPFit"]:
            np.testing.assert_array_equal(np.asarray(fa["MAPFit"][k]),
                                          np.asarray(fb["MAPFit"][k]))


def test_cli_map_artifact_loads_like_the_jax_one(tmp_path):
    """run_mbb_emcee_tpu_torch --map writes the JAX CLI's MAPFit-only
    layout; --init-map runs the MAP-seeded fit end to end."""
    import h5py
    from mbb_emcee_tpu_torch import cli
    flux, unc = _mock(TRUE, MBBShape(opthin=True, noalpha=True))
    phot = tmp_path / "p.txt"
    phot.write_text("".join(f"{w} {f} {u}\n"
                            for w, f, u in zip(WAVE, flux, unc)))
    out = tmp_path / "map.h5"
    assert cli.main([str(phot), str(out), "--opthin", "--noalpha", "--map",
                     "--map-starts", "4", "--device", "cpu"]) == 0
    with h5py.File(out) as f:
        assert set(f["MAPFit"].keys()) == {"Params", "LnProb", "Cov",
                                           "Sigma", "Interior", "GradNorm"}
        assert f["MAPFit"]["Params"].shape == (5,)
        assert abs(f["MAPFit"]["Params"][0] - TRUE[0]) < 5.0
    out2 = tmp_path / "fit.h5"
    assert cli.main([str(phot), str(out2), "--opthin", "--noalpha",
                     "--init-map", "--map-starts", "4", "-w", "16", "-b",
                     "10", "-n", "20", "--device", "cpu"]) == 0
    assert J.MBBResults(h5file=str(out2)).chain.shape == (16, 20, 5)
    with pytest.raises(SystemExit, match="triage"):
        cli.main([str(phot), str(out), "--map", "--init-map", "--device",
                  "cpu"])
    with pytest.raises(SystemExit, match="need chains"):
        cli.main([str(phot), str(out), "--map", "--ppc", "--device", "cpu"])


# -- twins of tests/test_mapfit.py ------------------------------------------------

def test_fit_map_matches_posterior():
    """Well-constrained problem: the MAP lands near the truth, the Laplace
    sigmas track the MCMC posterior widths, the mode is interior and beats
    every sampled point."""
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = _mock(TRUE, shape, frac=0.02)
    fit = T.MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=5,
                      device="cpu")
    fit.set_data(WAVE, flux, unc)
    fit.set_uplim("T", 100.0).set_uplim("beta", 5.0)
    r = fit.fit_map()
    assert r.interior and r.grad_norm < 1.0
    assert np.all(np.isfinite(r.sigma))
    assert np.all(np.abs(r.x - TRUE[fit.free_space.free_idx])
                  < 3.0 * r.sigma + 1e-3)
    fit.run(nburn=100, nsteps=400)
    assert r.lnprob >= float(fit.lnprobability.max()) - 1e-3
    res = T.MBBResults(fit=fit)
    for k, name in enumerate(["T", "beta", "fnorm"]):
        cen = res.par_cen(name)
        assert 0.5 < r.sigma[k] / (0.5 * (cen[1] + cen[2])) < 2.0


def test_run_map_with_correlation():
    """MAP triage under the correlated error model: pulls of the truths
    under the matched error model stay within 4 sigma."""
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(9)
    S = 4
    trues = np.column_stack([
        rng.uniform(25.0, 40.0, S), rng.uniform(1.6, 2.1, S),
        np.full(S, 250.0), np.full(S, 4.0), rng.uniform(25.0, 55.0, S)])
    R = 0.3 * np.ones((NB, NB)) + 0.7 * np.eye(NB)
    L = np.linalg.cholesky(R)
    flux, unc = [], []
    for t in trues:
        f, _ = _mock(t, shape, frac=0.0)
        u = 0.03 * f
        flux.append(f + u * (L @ rng.standard_normal(NB)))
        unc.append(u)
    mf = T.MultiFitter(nwalkers=64, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    mf.set_data(WAVE, np.array(flux), np.array(unc))
    mf.set_band_correlation(R)
    mf.run_map()
    assert np.all(np.isfinite(mf.map_lnprob))
    sig_T = mf.map_cen("T")[:, 1]
    pulls = (mf.map_params[:, 0] - trues[:, 0]) / np.maximum(sig_T, 1e-3)
    assert np.all(np.abs(pulls) < 4.0)


def test_map_seeded_mcmc():
    """MultiFitter.run(init="map"): a short burn from the MAP balls gives
    truth-covering posteriors and healthy acceptance; without run_map it is
    refused."""
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(11)
    S = 4
    trues = np.column_stack([
        rng.uniform(25.0, 40.0, S), rng.uniform(1.6, 2.1, S),
        np.full(S, 250.0), np.full(S, 4.0), rng.uniform(25.0, 55.0, S)])
    flux = np.stack([_mock(t, shape, seed=20 + i)[0]
                     for i, t in enumerate(trues)])
    unc = np.stack([_mock(t, shape, seed=20 + i)[1]
                    for i, t in enumerate(trues)])
    mf = T.MultiFitter(nwalkers=64, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    mf.set_data(WAVE, flux, unc)
    with pytest.raises(RuntimeError, match="run_map"):
        mf.run(nburn=4, nsteps=8, init="map")
    with pytest.raises(ValueError, match="init"):
        mf.run(nburn=4, nsteps=8, init="MAP")
    mf.run_map(nstarts=4)
    mf.run(nburn=20, nsteps=150, init="map")
    cen = mf.par_cen("T")
    err = np.maximum(cen[:, 1], cen[:, 2])
    assert np.all(np.abs(cen[:, 0] - trues[:, 0]) < 5.0 * err)
    af = mf.acceptance_fraction.mean(axis=1)
    assert np.all(af > 0.15) and np.all(af < 0.8)


def test_map_importance_matches_mcmc():
    """Importance-refined Laplace posteriors agree with the MCMC on
    well-conditioned sources, and the ESS says so."""
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(13)
    S = 4
    trues = np.column_stack([
        rng.uniform(27.0, 38.0, S), rng.uniform(1.7, 2.0, S),
        np.full(S, 250.0), np.full(S, 4.0), rng.uniform(30.0, 50.0, S)])
    flux = np.stack([_mock(t, shape, frac=0.02, seed=30 + i)[0]
                     for i, t in enumerate(trues)])
    unc = np.stack([_mock(t, shape, frac=0.02, seed=30 + i)[1]
                    for i, t in enumerate(trues)])
    mf = T.MultiFitter(nwalkers=96, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    mf.set_data(WAVE, flux, unc)
    with pytest.raises(RuntimeError, match="run_map"):
        mf.map_importance()
    mf.run_map()
    ess = mf.map_importance(nsamples=512)
    assert ess.shape == (S,) and np.all(ess > 100)
    cen_is = mf.map_par_cen("T")
    mf.run(nburn=120, nsteps=500, init="map")
    cen_mc = mf.par_cen("T")
    sig = 0.5 * (cen_mc[:, 1] + cen_mc[:, 2])
    assert np.all(np.abs(cen_is[:, 0] - cen_mc[:, 0]) < 0.5 * sig)
    w_is = 0.5 * (cen_is[:, 1] + cen_is[:, 2])
    assert np.all(np.abs(w_is / sig - 1.0) < 0.35)
    assert np.all(mf.map_par_cen("lambda0")[:, 1:] == 0.0)


def test_run_map_wave_change_not_stale():
    """New same-shape data at other wavelengths gives another MAP fit, and
    the stored data follow it."""
    shape = MBBShape(opthin=True, noalpha=True)
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    wave2 = WAVE * 1.6
    f1 = mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                 torch.tensor(WAVE, dtype=torch.float32), shape).numpy()
    f2 = mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                 torch.tensor(wave2, dtype=torch.float32), shape).numpy()
    mf.set_data(WAVE, f1[None, :], 0.03 * f1[None, :])
    mf.run_map(nstarts=4)
    t1 = float(mf.map_params[0, 0])
    mf.set_data(wave2, f2[None, :], 0.03 * f2[None, :])
    mf.run_map(nstarts=4)
    t2 = float(mf.map_params[0, 0])
    assert abs(t1 - TRUE[0]) < 5.0 and abs(t2 - TRUE[0]) < 5.0
    assert not np.allclose(mf._map_data[2], WAVE)


def test_map_importance_floored_source_gets_zero_ess():
    """An all-out-of-box Laplace proposal reports ess ~ 0 and NaN errors,
    never a perfect certificate from uniform floor weights."""
    flux, unc = _mock(TRUE, MBBShape(opthin=True, noalpha=True))
    mf = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=3,
                       device="cpu")
    mf.set_data(WAVE, flux[None, :], unc[None, :])
    mf.run_map(nstarts=4)
    mf.map_cov = mf.map_cov * 1e18
    ess = mf.map_importance(nsamples=64)
    assert ess[0] < 5.0
    if ess[0] == 0.0:
        cen = mf.map_par_cen("T")
        assert np.isnan(cen[0, 1]) and cen[0, 0] == mf.map_params[0, 0]


def test_map_staleness_guards():
    """init="map" and map_importance refuse stored MAP results after the
    posterior or the data changed, a same-nfree swap of the free parameters
    included."""
    flux, unc = _mock(TRUE, MBBShape(noalpha=True))
    mf = T.MultiFitter(nwalkers=16, noalpha=True, seed=3, device="cpu")
    mf.set_data(WAVE, flux[None, :], unc[None, :])
    mf.fix_param("T", 32.0)
    mf.run_map(nstarts=4)
    mf.unfix_param("T")
    mf.fix_param("beta", 1.9)
    with pytest.raises(RuntimeError, match="re-run"):
        mf.run(nburn=4, nsteps=8, init="map")
    with pytest.raises(RuntimeError, match="re-run"):
        mf.map_importance(nsamples=16)
    mf2 = T.MultiFitter(nwalkers=16, opthin=True, noalpha=True, seed=3,
                        device="cpu")
    mf2.set_data(WAVE, flux[None, :], unc[None, :])
    mf2.run_map(nstarts=4)
    mf2.set_data(WAVE, flux[None, :] * 1.1, unc[None, :])
    with pytest.raises(RuntimeError, match="re-run"):
        mf2.run(nburn=4, nsteps=8, init="map")


def test_single_fit_map_importance():
    """MBBFitter.map_importance: MCMC-quality single-fit summaries without
    MCMC, covariance likelihood included."""
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = _mock(TRUE, shape, frac=0.02)
    cov = 0.3 * np.outer(unc, unc) + 0.7 * np.diag(unc ** 2)
    fit = T.MBBFitter(nwalkers=96, opthin=True, noalpha=True, seed=5,
                      device="cpu")
    fit.set_data(WAVE, flux, unc, cov=cov)
    with pytest.raises(RuntimeError, match="fit_map"):
        fit.map_importance()
    fit.fit_map()
    x, logw, ess = fit.map_importance(nsamples=2048)
    assert ess > 400
    cen_is = fit.map_par_cen("T")
    np.testing.assert_allclose(fit.map_par_cen("lambda0")[1:], 0.0)
    fit.run(nburn=120, nsteps=500)
    cen_mc = T.MBBResults(fit=fit).par_cen("T")
    sig = 0.5 * (cen_mc[1] + cen_mc[2])
    assert abs(cen_is[0] - cen_mc[0]) < 0.5 * sig
    assert abs(0.5 * (cen_is[1] + cen_is[2]) / sig - 1.0) < 0.35


def test_single_fit_map_seeded_mcmc():
    """MBBFitter.run(init="map") and its guards: no fit_map yet, a bad init,
    p0 and n_ensembles conflicts, new data, a changed parameter space, and
    same-nfree posterior edits (a prior, a limit, an upper-limit mask)."""
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = _mock(TRUE, shape, seed=5)

    def fitter(**kw):
        f = T.MBBFitter(nwalkers=64, opthin=True, noalpha=True, seed=9,
                        device="cpu", **kw)
        f.set_data(WAVE, flux, unc)
        return f

    fit = fitter()
    with pytest.raises(RuntimeError, match="fit_map"):
        fit.run(nburn=4, nsteps=8, init="map")
    with pytest.raises(ValueError, match="init"):
        fit.run(nburn=4, nsteps=8, init="bogus")
    fit.fit_map(nstarts=4)
    with pytest.raises(ValueError, match="p0"):
        fit.run(nburn=4, nsteps=8, init="map",
                p0=np.tile(TRUE[[0, 1, 4]], (64, 1)))
    fit.run(nburn=20, nsteps=150, init="map")
    assert abs(np.median(fit.chain[..., 0]) - TRUE[0]) < 6.0
    assert 0.15 < float(np.mean(fit.acceptance_fraction)) < 0.8
    fit.set_data(WAVE, flux * 1.5, unc * 1.5)
    with pytest.raises(RuntimeError, match="fit_map"):
        fit.run(nburn=4, nsteps=8, init="map")
    with pytest.raises(ValueError, match="n_ensembles"):
        fitter(n_ensembles=2).run(nburn=4, nsteps=8, init="map")

    fit2 = fitter()
    fit2.fit_map(nstarts=4)
    fit2.fix_param("beta", 1.9)
    with pytest.raises(RuntimeError, match="parameter space"):
        fit2.run(nburn=4, nsteps=8, init="map")

    fit3 = fitter()
    fit3.fit_map(nstarts=4)
    fit3.set_gaussian_prior("T", 20.0, 1.0)
    with pytest.raises(RuntimeError, match="re-run"):
        fit3.run(nburn=4, nsteps=8, init="map")
    with pytest.raises(RuntimeError, match="re-run"):
        fit3.map_importance(nsamples=16)
    fit3.fit_map(nstarts=4)
    fit3.set_uplim("T", 38.0)
    with pytest.raises(RuntimeError, match="re-run"):
        fit3.run(nburn=4, nsteps=8, init="map")
    fit3.fit_map(nstarts=4)
    fit3.set_phot_upperlimits(np.array([0, 0, 0, 0, 1], bool))
    with pytest.raises(RuntimeError, match="re-run"):
        fit3.run(nburn=4, nsteps=8, init="map")
    fit3.fit_map(nstarts=4)
    fit3.run(nburn=4, nsteps=8, init="map")
