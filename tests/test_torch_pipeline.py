"""End-to-end serving pipeline of mbb_emcee_tpu_torch: the twin of
tests/test_pipeline.py. Every stage of the documented workflow in one test
-- triage, a MAP-seeded run, the extend loop, derived quantities, the HDF5
file and a fresh MAP-seeded run after from_h5 -- guarding the interactions
between features that the per-feature tests cannot see, with a ragged
source, on the CPU's plain batch step (sampler_backend="torch"), at the JAX
test's seed, sizes and thresholds."""

import numpy as np
import torch

torch.set_num_threads(1)

from mbb_emcee_tpu_torch import MultiFitter  # noqa: E402
from mbb_emcee_tpu_torch.models import MBBShape, mbb_fnu  # noqa: E402

NB = 5
WAVE = np.array([100.0, 160.0, 250.0, 350.0, 500.0])


def test_triage_refine_extend_persist(tmp_path):
    shape = MBBShape(opthin=True, noalpha=True)
    rng = np.random.default_rng(21)
    S = 6
    trues = np.column_stack([
        rng.uniform(25.0, 40.0, S), rng.uniform(1.6, 2.1, S),
        np.full(S, 250.0), np.full(S, 4.0), rng.uniform(25.0, 55.0, S)])
    z = rng.uniform(1.5, 3.0, S)
    flux, unc = [], []
    for t in trues:
        f = mbb_fnu(params=torch.as_tensor(t, dtype=torch.float32),
                    wave=torch.as_tensor(WAVE, dtype=torch.float32),
                    shape=shape).double().numpy()
        u = 0.04 * f
        flux.append(f + u * rng.standard_normal(NB))
        unc.append(u)
    flux, unc = np.array(flux), np.array(unc)
    # raggedness through the whole pipeline
    flux[4, 0] = np.nan
    unc[4, 0] = np.nan

    mf = MultiFitter(nwalkers=64, opthin=True, noalpha=True, seed=9,
                     sampler_backend="torch", device="cpu")
    mf.set_data(WAVE, flux, unc,
                source_names=[f"S{i}" for i in range(S)], redshifts=z)

    # 1. triage
    mf.run_map(nstarts=4)
    ess = mf.map_importance(nsamples=256)
    assert np.all(np.isfinite(mf.map_lnprob)) and ess.shape == (S,)

    # 2. map-seeded MCMC + run-until-converged extension loop
    mf.run(nburn=40, nsteps=120, init="map")
    for _ in range(4):
        ok = mf.converged(rhat_max=1.15, window=60)
        if ok.all():
            break
        mf.extend(120)
    nrec = mf.chain_free.shape[1]
    assert nrec >= 120

    # MCMC medians consistent with the importance-refined triage
    cen_mc = mf.par_cen("T")
    cen_is = mf.map_par_cen("T")
    sig = 0.5 * (cen_mc[:, 1] + cen_mc[:, 2])
    assert np.all(np.abs(cen_mc[:, 0] - cen_is[:, 0]) < 4.0 * sig)

    # 3. derived quantities on the extended chain
    mf.compute_lir(thin=4)
    mf.compute_peaklambda(thin=4)
    assert np.all(mf.lir_cen()[:, 0] > 0)

    # 4. persist everything, reload, and keep working
    out = str(tmp_path / "pipeline.h5")
    mf.writeToHDF5(out)
    back = MultiFitter.from_h5(out, device="cpu")
    assert back.chain_free.shape == (S, nrec, 64, 3)
    np.testing.assert_allclose(back.map_params, mf.map_params)
    np.testing.assert_allclose(back.par_cen("T"), cen_mc, rtol=1e-6)
    assert back.source_names == [f"S{i}" for i in range(S)]
    # reloaded object supports further analysis
    dm = back.compute_dustmass(thin=8)
    assert dm.shape[0] == S and np.all(dm > 0)
    # ... and the restored MAP state seeds a fresh run
    back.run(nburn=10, nsteps=20, init="map")
    assert back.chain_free.shape[1] == 20
