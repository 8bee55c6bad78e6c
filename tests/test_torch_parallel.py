"""The port's multi-device sharding (mbb_emcee_tpu_torch.parallel and the
mesh= leg of every tier) on the CPU: meshes whose shards all lie on the CPU
(walker_mesh(n, devices=["cpu"] * n)), the counterpart of the JAX tests' 8
virtual CPU devices. Twins of tests/test_parallel.py and of the mesh tests
of test_multifit.py, test_pallas_multifit.py, test_sedmulti.py,
test_tempering.py, test_hmc.py, test_hierarchy.py, test_checkpoint.py and
test_cli_batch.py.

The port's Philox streams are keyed by walker lane and by global source
index, so a sharded run draws what the unsharded run draws, and each
tier's sharded result is held to the unsharded one by torch.equal; the
hierarchy's source sum, whose order the shards change, at rtol 1e-5.
ATen's CPU elementwise kernels take blocks of 32 fp32 elements through
vector code and the remainder through scalar code, whose transcendental
functions can differ from the vector ones by an ulp, so the bitwise cases
keep every shard's batch a multiple of 32 elements (on a card every
element takes the same code). The sharded half-step is replayed against
the JAX package's half-step on the same uniforms, and the sharded
hyper-lnprob against the JAX package's sharded one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import mbb_emcee_tpu.parallel as jparallel  # noqa: E402
from mbb_emcee_tpu import hierarchy as jh  # noqa: E402
from mbb_emcee_tpu import sampler as jsampler  # noqa: E402
from mbb_emcee_tpu.likelihood import (  # noqa: E402
    LikelihoodSpec as JSpec, Photometry as JPhotometry,
    build_lnprob as j_build_lnprob)
from mbb_emcee_tpu.models.modified_blackbody import (  # noqa: E402
    MBBShape as JShape)
import mbb_emcee_tpu_torch.parallel as parallel  # noqa: E402
from mbb_emcee_tpu_torch import (  # noqa: E402
    MBBFitter, MBBResults, MultiFitter, SEDModel, SEDMultiFitter, cli_batch)
from mbb_emcee_tpu_torch.convert import (  # noqa: E402
    photometry_from_arrays, spec_from_reference)
from mbb_emcee_tpu_torch.hierarchy import (  # noqa: E402
    HierarchicalFitter, TruncatedGaussianPopulation, build_hier_lnprob)
from mbb_emcee_tpu_torch.likelihood import (  # noqa: E402
    LikelihoodSpec, build_lnprob)
from mbb_emcee_tpu_torch.models.modified_blackbody import (  # noqa: E402
    MBBShape, log_mbb_fnu, mbb_fnu)
from mbb_emcee_tpu_torch.nested import make_nested_batch_runner  # noqa: E402
from mbb_emcee_tpu_torch.parallel import (  # noqa: E402
    ShardedEnsembleSampler, walker_mesh)
from mbb_emcee_tpu_torch.parallel.mesh import mesh_token  # noqa: E402
from mbb_emcee_tpu_torch.sampler import (  # noqa: E402
    EnsembleSampler, MultiSamplerState, make_initial_ball,
    multi_stretch_run_plain)

NDIM = 3
MEAN = np.array([1.0, -2.0, 0.5])
SIG = np.array([0.8, 1.5, 0.3])
WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
TRUE = np.array([32.0, 1.9, 250.0, 3.5, 45.0])
TRUES4 = np.array([[25.0, 1.8, 250.0, 4.0, 30.0],
                   [32.0, 1.9, 250.0, 3.5, 45.0],
                   [40.0, 2.0, 250.0, 3.0, 20.0],
                   [20.0, 1.6, 250.0, 4.0, 60.0]])


def cpu_mesh(n):
    return walker_mesh(n, devices=["cpu"] * n)


def _gauss(x):
    d = (x - torch.as_tensor(MEAN, dtype=x.dtype)) / torch.as_tensor(
        SIG, dtype=x.dtype)
    return -0.5 * torch.sum(d * d, dim=-1)


def _ball(nwalkers, seed, scale=1.0):
    return make_initial_ball(torch.Generator().manual_seed(seed), MEAN,
                             scale * SIG, nwalkers)


def _mock_batch(trues, seed=0):
    """(flux, unc) (S, 5) of the thin MBB at each row of `trues`, 5% noise."""
    shape = MBBShape(opthin=True, noalpha=True)
    f = mbb_fnu(torch.as_tensor(trues, dtype=torch.float32),
                torch.as_tensor(WAVE, dtype=torch.float32),
                shape).double().numpy()
    unc = 0.05 * f
    rng = np.random.default_rng(seed)
    return f + unc * rng.standard_normal(f.shape), unc


def _multi(mesh, nsrc=8, backend="auto", uplims=True, corr=False, seed=5,
           nwalkers=32):
    flux, unc = _mock_batch(np.repeat(TRUES4, nsrc // 4, axis=0))
    mf = MultiFitter(nwalkers=nwalkers, opthin=True, noalpha=True,
                     seed=seed, mesh=mesh, sampler_backend=backend,
                     device=None if mesh is not None else "cpu")
    mf.set_data(WAVE, flux, unc)
    if uplims:
        m = np.zeros((nsrc, WAVE.size), bool)
        m[1, -1] = m[6, 0] = True
        mf.set_phot_upperlimits(m)
    if corr:
        mf.set_band_correlation(0.3 * np.ones((5, 5)) + 0.7 * np.eye(5))
    return mf


def _same_chains(a, b):
    assert torch.equal(a.chain_free, b.chain_free)
    assert torch.equal(a.lnprobability, b.lnprobability)
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)


# -- twins of tests/test_parallel.py -----------------------------------------

def test_mesh_has_8_devices(monkeypatch):
    """A CPU mesh of 8 shards; the package's surface is the JAX one's;
    more devices than listed, or the default (every card) without one, is
    refused."""
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.shape == {"walkers": 8}
    assert mesh.axis_names == ("walkers",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert parallel.__all__ == jparallel.__all__
    assert mesh_token(None) is None
    assert mesh_token(mesh) == mesh_token(cpu_mesh(8)) != mesh_token(
        cpu_mesh(4))
    with pytest.raises(ValueError, match="requested 9 devices, only 8 "
                                         "available"):
        walker_mesh(9, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (walker_mesh, lambda: walker_mesh(devices=["cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sharded_matches_single_device_statistically():
    nwalkers = 128
    sh = ShardedEnsembleSampler(nwalkers, NDIM, _gauss, cpu_mesh(8))
    st = sh.init_state(_ball(nwalkers, 1), seed=0)
    st = sh.advance(st, 200)
    st = sh.reset_counters(st)
    st, chain, lnp = sh.run_mcmc(st, 1200)
    flat = chain.double().numpy().reshape(-1, NDIM)
    assert chain.shape == (1200, nwalkers, NDIM)
    assert np.all(np.abs(flat.mean(axis=0) - MEAN) < 0.1 * SIG)
    np.testing.assert_allclose(flat.std(axis=0), SIG, rtol=0.1)
    af = ShardedEnsembleSampler.acceptance_fraction(st)
    assert 0.2 < af.mean() < 0.8


@pytest.mark.parametrize("thin", [1, 3])
def test_sharded_is_the_single_device_sampler(thin):
    """8 shards draw the single-ensemble stream's lanes: chains, lnprob,
    accepts and the stream position are EnsembleSampler's bit for bit,
    through advance and a thinned run."""
    nwalkers = 64
    sh = ShardedEnsembleSampler(nwalkers, NDIM, _gauss, cpu_mesh(8))
    ref = EnsembleSampler(nwalkers, NDIM, _gauss)
    p0 = _ball(nwalkers, 6)
    a = sh.advance(sh.init_state(p0, seed=77), 9)
    b = ref.advance(ref.init_state(p0, seed=77), 9)
    a, ca, la = sh.run_mcmc(a, 30, thin)
    b, cb, lb = ref.run_mcmc(b, 30, thin)
    assert torch.equal(ca, cb) and torch.equal(la, lb)
    assert torch.equal(a.naccept, b.naccept)
    assert (a.step, a.nsteps) == (b.step, b.nsteps) == (39, 39)
    np.testing.assert_array_equal(sh.acceptance_fraction(a),
                                  ref.acceptance_fraction(b))


def test_sharded_deterministic_fixed_devices():
    nwalkers = 64

    def run():
        s = ShardedEnsembleSampler(nwalkers, NDIM, _gauss, cpu_mesh(8))
        _, chain, _ = s.run_mcmc(s.init_state(_ball(nwalkers, 6), seed=5),
                                 50)
        return chain

    assert torch.equal(run(), run())


def test_sharded_thinning():
    nwalkers = 32
    s = ShardedEnsembleSampler(nwalkers, NDIM, _gauss, cpu_mesh(8))
    st = s.init_state(_ball(nwalkers, 2), seed=1)
    _, c1, _ = s.run_mcmc(st, 40, thin=1)
    _, c4, _ = s.run_mcmc(st, 40, thin=4)
    assert torch.equal(c1[3::4], c4)


def _j_problem():
    unc = 0.05 * np.array([8.62, 23.3, 41.2, 44.6, 45.0])
    rng = np.random.default_rng(7)
    jphot = JPhotometry(WAVE, np.array([8.62, 23.3, 41.2, 44.6, 45.0])
                        + unc * rng.standard_normal(5), unc)
    jspec = JSpec.default()
    jspec.upper[0] = 100.0
    jspec.upper[1] = 5.0
    return jphot, jspec


def test_sharded_half_step_replays_jax():
    """Each shard's half-step on fixed uniforms, under the full MBB
    likelihood: the JAX package's stretch_half_step_from_uniforms on that
    shard's block against the gathered WHOLE passive half (rtol 2e-5, the
    replay rule), accept decisions equal."""
    jphot, jspec = _j_problem()
    j_fn, fs = j_build_lnprob(jphot, JShape(), jspec)
    t_fn, _ = build_lnprob(photometry_from_arrays(jphot.wave, jphot.flux,
                                                  jphot.unc),
                           MBBShape(), spec_from_reference(jspec))
    nwalkers, ndev = 64, 4
    rng = np.random.default_rng(11)
    p0 = (TRUE * (1 + 0.05 * rng.standard_normal((nwalkers, 5)))).astype(
        np.float32)
    half, h = nwalkers // 2, nwalkers // 2 // ndev
    u = rng.uniform(0.001, 0.999, (ndev, 3, h)).astype(np.float32)
    sh = ShardedEnsembleSampler(nwalkers, 5, t_fn, cpu_mesh(ndev))
    act = sh._blocks(torch.as_tensor(p0[:half]))
    pas = sh._blocks(torch.as_tensor(p0[half:]))
    lnp = sh._eval(act)
    new, new_lnp, acc = sh._half_step([torch.as_tensor(x) for x in u], 0,
                                      act, pas, lnp)
    jb = jax.jit(jax.vmap(j_fn))
    for d in range(ndev):
        blk = jnp.asarray(p0[d * h:(d + 1) * h])
        want, want_lnp, want_acc = jsampler.stretch_half_step_from_uniforms(
            jnp.asarray(u[d]), blk, jnp.asarray(p0[half:]), jb(blk), jb)
        np.testing.assert_allclose(new[d].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(new_lnp[d].numpy(), np.asarray(want_lnp),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_array_equal(acc[d].numpy(), np.asarray(want_acc))


def test_sharded_mbb_fit_recovers():
    """The full MBB likelihood under the sharded sampler (what
    __graft_entry__.dryrun_multichip exercises in the JAX package)."""
    shape = MBBShape(opthin=True, noalpha=True)
    f = mbb_fnu(torch.as_tensor(TRUE, dtype=torch.float32),
                torch.as_tensor(WAVE, dtype=torch.float32),
                shape).double().numpy()
    unc = 0.05 * f
    rng = np.random.default_rng(0)
    phot = photometry_from_arrays(WAVE, f + unc * rng.standard_normal(5),
                                  unc)
    spec = LikelihoodSpec.default()
    spec.upper[0] = 100.0
    spec.upper[1] = 5.0
    spec.fixed[2], spec.fixed_values[2] = True, 250.0
    spec.fixed[3], spec.fixed_values[3] = True, 3.5
    lnprob, fs = build_lnprob(phot, shape, spec)
    nwalkers = 64
    s = ShardedEnsembleSampler(nwalkers, fs.nfree, lnprob, cpu_mesh(8))
    center = TRUE[fs.free_idx]
    p0 = make_initial_ball(torch.Generator().manual_seed(3), center,
                           0.1 * np.abs(center), nwalkers, fs.lower,
                           fs.upper)
    st = s.advance(s.init_state(p0, seed=4), 100)
    st, chain, _ = s.run_mcmc(st, 300)
    full = fs.expand(chain.double().numpy().reshape(-1, fs.nfree))
    for i in (0, 1, 4):
        med, std = np.median(full[:, i]), full[:, i].std()
        assert abs(med - TRUE[i]) < 4 * max(std, 1e-3)


def test_geometry_validation():
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError, match="must divide the half-ensemble"):
        ShardedEnsembleSampler(20, NDIM, _gauss, mesh)   # 10 % 8 != 0
    with pytest.raises(ValueError, match="even"):
        ShardedEnsembleSampler(17, NDIM, _gauss, mesh)
    with pytest.raises(ValueError, match="one lnprob per shard"):
        ShardedEnsembleSampler(32, NDIM, [_gauss] * 3, mesh)
    with pytest.raises(TypeError, match="walker_mesh"):
        ShardedEnsembleSampler(32, NDIM, _gauss, jparallel.walker_mesh(8))


def _mbb_data():
    f = mbb_fnu(torch.as_tensor([30.0, 2.0, 250.0, 3.2, 50.0],
                                dtype=torch.float32),
                torch.as_tensor(WAVE, dtype=torch.float32),
                MBBShape()).double().numpy()
    unc = 0.05 * f
    return f + unc * np.random.default_rng(0).standard_normal(5), unc


def _mbb_fit(mesh, nwalkers, **kw):
    flux, unc = _mbb_data()
    fit = MBBFitter(nwalkers=nwalkers, seed=11, mesh=mesh,
                    device=None if mesh is not None else "cpu", **kw)
    return fit.set_data(WAVE, flux, unc)


def test_mbbfitter_mesh_end_to_end():
    """MBBFitter(mesh=) runs the burn / re-center / production protocol
    with the walker axis sharded, MBBResults consumes it; fused + mesh is
    a configuration error; so is n_ensembles > 1 with a mesh."""
    fit = _mbb_fit(cpu_mesh(8), 64).run(nburn=40, nsteps=150)
    assert fit._backend_used == "sharded"
    res = MBBResults(fit=fit, redshift=2.0)
    assert abs(res.par_cen("T")[0] - 30.0) < 10.0
    assert np.isfinite(res.acceptance_fraction).all()
    with pytest.raises(ValueError, match="single-chip"):
        _mbb_fit(cpu_mesh(8), 64, sampler_backend="fused").run(
            nburn=2, nsteps=4)
    with pytest.raises(ValueError, match="n_ensembles"):
        _mbb_fit(cpu_mesh(8), 64, n_ensembles=2).run(nburn=2, nsteps=4)


def test_mbbfitter_mesh_is_the_unsharded_fit():
    """On 8 CPU shards MBBFitter.run is the plain backend's run bit for
    bit (512 walkers: 32 per shard and half), and extend continues it."""
    a = _mbb_fit(cpu_mesh(8), 512).run(nburn=10, nsteps=20)
    b = _mbb_fit(None, 512, sampler_backend="torch").run(nburn=10,
                                                          nsteps=20)
    _same_chains(a, b)
    a.extend(6)
    b.extend(6)
    _same_chains(a, b)


def test_sharded_single_trace_across_geometries():
    """One sampler serves every (nburn, nsteps, thin) geometry, each call
    continuing the stream: the chains of EnsembleSampler through the same
    sequence."""
    s = ShardedEnsembleSampler(16, NDIM, _gauss, cpu_mesh(8))
    r = EnsembleSampler(16, NDIM, _gauss)
    out = []
    for smp in (s, r):
        st = smp.advance(smp.init_state(_ball(16, 0, 0.3), seed=1), 7)
        st, c1, _ = smp.run_mcmc(st, 12, thin=3)
        st = smp.advance(st, 3)
        st, c2, _ = smp.run_mcmc(st, 10, thin=2)
        out.append((c1, c2, st.step))
    assert out[0][0].shape == (4, 16, NDIM) and out[0][1].shape == (5, 16,
                                                                     NDIM)
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] == 32


def test_mesh_checkpoint_resume_bitwise(tmp_path):
    """Checkpoint / resume through the sharded backend: the resumed chain
    is the uninterrupted checkpointed run's bit for bit (the loaded state
    is re-sharded by every run), and that is the unsharded fit's."""
    def fit():
        return _mbb_fit(cpu_mesh(8), 16)

    ck1 = str(tmp_path / "full.ckpt.h5")
    full = fit().run(nburn=10, nsteps=60, checkpoint=ck1,
                     checkpoint_interval=20)
    ck2 = str(tmp_path / "part.ckpt.h5")
    fit().run(nburn=10, nsteps=20, checkpoint=ck2, checkpoint_interval=20)
    resumed = fit().run(nburn=10, nsteps=60, checkpoint=ck2,
                        checkpoint_interval=20, resume=True)
    assert torch.equal(resumed.chain_free, full.chain_free)
    assert torch.equal(full.chain_free, _mbb_fit(None, 16).run(
        nburn=10, nsteps=60).chain_free)


def test_multifit_mesh_checkpoint_resume_bitwise(tmp_path):
    """A batch checkpoint written on a 4-shard mesh resumes on that mesh
    and on none, each bitwise the uninterrupted run (the streams do not
    depend on the partitioning; the file records the writer's mesh), and
    extend() keeps working after a resume."""
    import h5py
    path = str(tmp_path / "mesh_ck.h5")
    mesh = cpu_mesh(4)
    ref = _multi(mesh).run(nburn=10, nsteps=40)
    _multi(mesh).run(nburn=10, nsteps=20, checkpoint=path,
                     checkpoint_interval=10)
    with h5py.File(path, "r") as f:
        assert f.attrs["mesh_token"] == str(mesh_token(mesh))
    res = _multi(mesh).run(nburn=10, nsteps=40, checkpoint=path,
                           checkpoint_interval=10, resume=True)
    assert torch.equal(res.chain_free, ref.chain_free)
    _multi(mesh).run(nburn=10, nsteps=20, checkpoint=path,
                     checkpoint_interval=10)
    res2 = _multi(None).run(nburn=10, nsteps=40, checkpoint=path,
                            checkpoint_interval=10, resume=True)
    assert torch.equal(res2.chain_free, ref.chain_free)
    res.extend(10)
    assert res.chain_free.shape[1] == 50


# -- the batch tier's mesh legs -------------------------------------------------

@pytest.mark.parametrize("case", ["uplims", "correlated", "fused"])
def test_source_sharded_run_matches_unsharded(case):
    """MultiFitter on a 4-shard source mesh is the unsharded run bit for
    bit, and extend() continues identically: per-source upper limits on
    the plain batch step ('auto' on the CPU), correlated band errors, and
    sampler_backend='fused' (K3's wrapper per
    shard with the block's source0; its plain version on CPU tensors:
    the twin of test_pallas_multifit.py's sharded fused run)."""
    kw = dict(uplims=case != "correlated", corr=case == "correlated",
              backend="fused" if case == "fused" else "auto")
    a = _multi(cpu_mesh(4), **kw).run(nburn=20, nsteps=40)
    b = _multi(None, **kw).run(nburn=20, nsteps=40)
    assert a._backend_used == ("fused" if case == "fused" else "torch")
    _same_chains(a, b)
    a.extend(20)
    b.extend(20)
    _same_chains(a, b)


def test_auto_backend_is_the_kernel_on_cuda_with_or_without_a_mesh():
    """sampler_backend='auto' resolves to K3 ('fused') on a CUDA device
    whether or not a mesh is given, and to the plain batch step on the
    CPU (the resolution alone: no card here)."""
    for mesh in (None, cpu_mesh(4)):
        mf = _multi(mesh, uplims=False)
        assert mf._resolve_sampler_backend() == "torch"
        mf.device = torch.device("cuda")
        assert mf._resolve_sampler_backend() == "fused"


@pytest.mark.parametrize("tier", ["pt", "hmc", "map", "evidence",
                                  "ppc_loo"])
def test_tiers_match_unsharded(tier):
    """Every per-source tier on a 4-shard mesh is its unsharded run bit
    for bit: run_pt (chains, lnZ, ladders, swaps), run_hmc (chains, step
    sizes, metrics), run_map + map_importance, compute_evidence, and
    posterior_predictive / compute_loo on a run's chains."""
    a, b = _multi(cpu_mesh(4)), _multi(None)
    if tier == "pt":
        for m in (a, b):
            m.run_pt(nrungs=4, nburn=16, nsteps=20)
        _same_chains(a, b)
        for k in ("pt_betas", "swap_fraction"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        for x, y in zip(a.logz_pt + a.logz_ti, b.logz_pt + b.logz_ti):
            np.testing.assert_array_equal(x, y)
    elif tier == "hmc":
        for m in (a, b):
            m.run_hmc(nwarmup=12, nsteps=16, n_leapfrog=3)
        _same_chains(a, b)
        np.testing.assert_array_equal(a.hmc_step_size, b.hmc_step_size)
        np.testing.assert_array_equal(a.hmc_mass, b.hmc_mass)
    elif tier == "map":
        for m in (a, b):
            m.run_map(nstarts=16, n_adam=20, n_newton=3)
        for k in ("map_params", "map_lnprob", "map_cov", "map_interior"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_array_equal(a.map_importance(64),
                                      b.map_importance(64))
        np.testing.assert_array_equal(a.map_logw, b.map_logw)
    elif tier == "evidence":
        ra, rb = (m.compute_evidence(nlive=64, nbatch=16, nsteps=4,
                                     max_iter=300, seed=4) for m in (a, b))
        for k in ("logz", "logz_err", "h", "samples", "loglike", "logwt",
                  "n_iter", "converged"):
            np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))
    else:
        for m in (a, b):
            m.run(nburn=10, nsteps=20)
        pa, pb = a.posterior_predictive(seed=3), b.posterior_predictive(
            seed=3)
        for k in ("p_value", "band_p", "chi2_obs", "chi2_rep"):
            np.testing.assert_array_equal(getattr(pa, k), getattr(pb, k))
        la, lb = a.compute_loo(), b.compute_loo()
        for k, v in vars(la).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, getattr(lb, k))


def test_pt_tier_resume_mesh_gate(tmp_path):
    """A PT tier checkpoint written on a 4-shard mesh resumes with no mesh
    bitwise the uninterrupted unsharded run in the same segments, chain
    and evidence, and its chain is the unsegmented run's (the JAX package
    accepts this for its partition-independent generator only; the port's
    Philox streams always are)."""
    ck, ck_w = str(tmp_path / "pt.ck.h5"), str(tmp_path / "whole.ck.h5")
    _multi(cpu_mesh(4)).run_pt(nrungs=4, nburn=8, nsteps=10, checkpoint=ck,
                               checkpoint_interval=10)
    whole = _multi(None).run_pt(nrungs=4, nburn=8, nsteps=20,
                                checkpoint=ck_w, checkpoint_interval=10)
    resumed = _multi(None).run_pt(nrungs=4, nburn=8, nsteps=20,
                                  checkpoint=ck, checkpoint_interval=10,
                                  resume=True)
    assert torch.equal(resumed.chain_free, whole.chain_free)
    for x, y in zip(resumed.logz_pt + resumed.logz_ti,
                    whole.logz_pt + whole.logz_ti):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(whole.chain_free, _multi(None).run_pt(
        nrungs=4, nburn=8, nsteps=20).chain_free)


def test_mesh_size_must_divide_the_sources():
    """The JAX engine's message for a mesh that does not divide the batch,
    before any sampling."""
    mf = _multi(cpu_mesh(3), uplims=False)
    for call in (lambda: mf.run(nburn=2, nsteps=2),
                 lambda: mf.run_map(nstarts=2, n_adam=1, n_newton=0)):
        with pytest.raises(ValueError, match=r"the mesh size \(3 devices\) "
                           r"must divide nsources=8; pad the source batch"):
            call()


def test_multi_stretch_run_plain_source0():
    """The plain version of K3 at a global source offset: sources k: of a
    run drawn with source0=k are rows k: of the unsharded run."""
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(rng.normal(size=(6, 16, NDIM)).astype(np.float32))

    def lnp(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    def state(p):
        return MultiSamplerState(
            pos=p, lnp=torch.zeros(p.shape[:2]),
            naccept=torch.zeros(p.shape[:2], dtype=torch.int32), nsteps=0,
            seed=99, step=5)

    whole = multi_stretch_run_plain(state(pos), lnp, 4, 2)
    for k in (2, 4):
        part = multi_stretch_run_plain(state(pos[k:]), lnp, 4, 2, source0=k)
        assert torch.equal(part[1], whole[1][k:])
        assert torch.equal(part[0].naccept, whole[0].naccept[k:])


def test_nested_batch_runner_mesh_matches_unsharded():
    """make_nested_batch_runner(mesh=) with one function for every shard or
    one per shard: per-source results equal the unsharded runner's, the
    dead sets padded as the unsharded run pads a source that finished
    early."""
    rng = np.random.default_rng(2)
    mu = torch.as_tensor(rng.uniform(-1, 1, (8, 2)).astype(np.float32))
    sig = torch.as_tensor(rng.uniform(0.1, 0.4, (8, 2)).astype(np.float32))

    def ll(theta, mu, sig):
        d = (theta - mu[:, None, :]) / sig[:, None, :]
        return -0.5 * torch.sum(d * d, dim=-1)

    lo, hi = np.array([-3.0, -3.0]), np.array([3.0, 3.0])
    kw = dict(nlive=64, nbatch=16, nsteps=4, max_iter=400)
    want = make_nested_batch_runner(ll, lo, hi, device="cpu", **kw)(
        7, (mu, sig))
    for fn in (ll, [ll] * 4):
        got = make_nested_batch_runner(fn, lo, hi, mesh=cpu_mesh(4), **kw)(
            7, (mu, sig))
        assert len(set(got.n_iter.tolist())) > 1
        for k in ("logz", "logz_err", "h", "samples", "loglike", "logwt",
                  "n_iter", "n_like", "converged"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


# -- the generic batch tier ------------------------------------------------------

def _sed_fnu(theta, wave):
    shape = MBBShape(opthin=True, noalpha=True)
    t, beta, fnorm = theta
    p = torch.stack([t, beta, torch.full_like(t, 250.0),
                     torch.full_like(t, 4.0), fnorm])
    return torch.exp(log_mbb_fnu(p, wave, shape))


SED_MODEL = SEDModel(fnu=_sed_fnu, param_names=("T", "beta", "fnorm"),
                     lower=[5.0, 0.5, 1e-3], upper=[80.0, 4.0, 1e3],
                     name="thin-mbb-mesh")


def _sed(mesh, nsrc=8, corr=False):
    flux, unc = _mock_batch(np.repeat(TRUES4, nsrc // 4, axis=0), seed=1)
    mf = SEDMultiFitter(SED_MODEL, nwalkers=32, seed=29, mesh=mesh,
                        device=None if mesh is not None else "cpu")
    mf.set_data(WAVE, flux, unc)
    if corr:
        mf.set_band_correlation(0.3 * np.ones((5, 5)) + 0.7 * np.eye(5))
    for name, v in zip(("T", "beta", "fnorm"), (30.0, 1.8, 30.0)):
        mf.set_param_init(name, v, 0.1 * v)
    if nsrc == 8:
        # per-source priors: spec-z-like anchors on beta for half the batch
        sig = np.where(np.arange(8) % 2 == 0, 0.2, np.inf)
        mf.set_gaussian_prior("beta", np.full(8, 1.8), sig)
    return mf


@pytest.mark.parametrize("corr", [False, True], ids=["diag", "correlated"])
def test_sedmulti_mesh_matches_unsharded(tmp_path, corr):
    """SEDMultiFitter on a 4-shard mesh with per-source priors, with and
    without correlated band errors: run, extend and run_map are the
    unsharded fitter's bit for bit; the file records the mesh and reloads
    under none; a mesh that does not divide the catalog is refused."""
    a, b = _sed(cpu_mesh(4), corr=corr), _sed(None, corr=corr)
    for m in (a, b):
        m.run(nburn=10, nsteps=20)
        m.extend(10)
    _same_chains(a, b)
    a.writeToHDF5(str(tmp_path / "s.h5"))
    back = SEDMultiFitter.from_h5(str(tmp_path / "s.h5"), SED_MODEL,
                                  device="cpu")
    assert torch.equal(back.chain_free, b.chain_free)
    import h5py
    with h5py.File(str(tmp_path / "s.h5"), "r") as f:
        tok = f.attrs["mesh_token"]
        assert (tok.decode() if isinstance(tok, bytes) else tok) == str(
            mesh_token(a.mesh))
    for m in (a, b):
        m.run_map(nstarts=16, n_adam=15, n_newton=2)
    np.testing.assert_array_equal(a.map_params, b.map_params)
    bad = _sed(cpu_mesh(8), nsrc=4)
    with pytest.raises(ValueError, match="must divide nsources=4"):
        bad.run(nburn=2, nsteps=2)


# -- the population tier -------------------------------------------------------

def test_hier_lnprob_mesh_matches_jax_and_unsharded():
    """build_hier_lnprob(mesh=) on 16 sources x 64 samples: within the JAX
    test's 1e-3 relative of the JAX package's sharded hyper-lnprob, rtol
    1e-5 of the port's unsharded one (the shards' partial sums add in
    another order); the mismatched divisor is refused with JAX's
    message; HierarchicalFitter(mesh=) runs on the mesh's first device.
    The JAX package also takes a hand-built multi-axis mesh; the port's
    mesh is 1-D, like walker_mesh."""
    from jax.sharding import Mesh
    rng = np.random.default_rng(5)
    S, N = 16, 64
    samples = rng.uniform(15.0, 55.0, (S, N, 1))
    jpop = jh.TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    pop = TruncatedGaussianPopulation.for_box(("T",), [10.0], [60.0])
    jmesh = Mesh(np.array(jax.devices()[:8]), ("src",))
    j_fn, _ = jh.build_hier_lnprob(samples, jpop, JSpec.for_box(
        jpop.lower, jpop.upper), mesh=jmesh)
    spec = LikelihoodSpec.for_box(pop.lower, pop.upper)
    plain, _ = build_hier_lnprob(samples, pop, spec, device="cpu")
    sharded, _ = build_hier_lnprob(samples, pop, spec, mesh=cpu_mesh(8))
    phis = np.array([[35.0, 4.0], [20.0, 1.0], [50.0, 12.0]], np.float32)
    got = sharded(torch.as_tensor(phis)).double().numpy()
    want = np.array([float(j_fn(jnp.asarray(p))) for p in phis])
    assert np.all(np.abs(got - want) < 1e-3 * np.maximum(1.0, np.abs(want)))
    np.testing.assert_allclose(got, plain(torch.as_tensor(
        phis)).double().numpy(), rtol=1e-5)
    with pytest.raises(ValueError) as jerr:
        jh.build_hier_lnprob(samples[:6], jpop, JSpec.for_box(
            jpop.lower, jpop.upper), mesh=jparallel.walker_mesh(8))
    with pytest.raises(ValueError) as terr:
        build_hier_lnprob(samples[:6], pop, spec, mesh=cpu_mesh(8))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="walker_mesh"):
        build_hier_lnprob(samples, pop, spec, mesh=jmesh)
    hf = HierarchicalFitter(samples, pop, nwalkers=8, mesh=cpu_mesh(8))
    hf.run(nburn=20, nsteps=40)
    assert hf.device == torch.device("cpu")
    assert np.isfinite(hf.lnprobability).all()


# -- the command lines -----------------------------------------------------------

def _catalog(tmp_path, nsrc=8):
    flux, unc = _mock_batch(np.repeat(TRUES4, nsrc // 4, axis=0), seed=4)
    lines = ["wave = " + " ".join(f"{w:g}" for w in WAVE)]
    for i in range(nsrc):
        lines.append(f"S{i:02d} 2.0 " + " ".join(
            f"{f:.6g} {u:.6g}" for f, u in zip(flux[i], unc[i])))
    path = tmp_path / "cat.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_batch_cli_mesh(tmp_path, monkeypatch):
    """--mesh-devices shards the source axis over CPU shards under --device
    cpu, and writes the unsharded CLI's chains; the mesh size must divide
    the source count, or the chunk size with --chunk-size (JAX's
    messages); with --device cuda a mesh larger than the cards present
    raises walker_mesh's error."""
    cat = _catalog(tmp_path)
    base = ["--opthin", "--noalpha", "-w", "32", "-b", "16", "-n", "24",
            "--seed", "2", "--device", "cpu"]
    out_m, out_1 = str(tmp_path / "m.h5"), str(tmp_path / "one.h5")
    assert cli_batch.main([cat, out_m, *base, "--mesh-devices", "4"]) == 0
    assert cli_batch.main([cat, out_1, *base]) == 0
    a = MultiFitter.from_h5(out_m, device="cpu")
    b = MultiFitter.from_h5(out_1, device="cpu")
    assert a.nsources == 8 and a.chain_free.shape[1] == 24
    assert torch.equal(a.chain_free, b.chain_free)
    with pytest.raises(SystemExit, match="divide the source count"):
        cli_batch.main([cat, str(tmp_path / "x.h5"), *base,
                        "--mesh-devices", "3"])
    with pytest.raises(SystemExit, match="must divide --chunk-size"):
        cli_batch.main([cat, str(tmp_path / "y.h5"), *base,
                        "--chunk-size", "4", "--mesh-devices", "3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                                         "available"):
        cli_batch.main([cat, str(tmp_path / "z.h5"), "--device", "cuda",
                        "--mesh-devices", "2"])
