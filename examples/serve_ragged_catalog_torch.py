"""Ragged survey serving: missing bands, per-source upper limits, and
correlated calibration errors -- all in ONE batch (the torch twin of
examples/serve_ragged_catalog.py, on mbb_emcee_tpu_torch).

    python examples/serve_ragged_catalog_torch.py [--device cuda|cpu]

Real catalogs are ragged: not every source is observed in every band,
some measurements are upper limits, and the instrument's calibration
errors are correlated across bands. Each of those rides a RUNTIME
operand here (missing band = zero inverse uncertainty, upper limit =
its sign, correlation = a per-source whitening matrix precomputed from
the pattern submatrices), so any missingness/limit pattern runs through
the same multi-source kernel.

The same pipeline is one shell command:
    run_mbb_emcee_tpu_torch_batch catalog.txt out.h5 --corrfile cov.fits \
        --extend-until 1.05 --get-lir --summary
with '<flux' tokens and 'nan nan' pairs directly in the catalog file.
"""

import argparse
import os
import sys

import numpy as np
import torch

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MultiFitter
from mbb_emcee_tpu_torch.models.modified_blackbody import mbb_fnu, MBBShape

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(3)
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
nb = wave.size


def fake_ragged_batch(nsources):
    shape = MBBShape(opthin=True, noalpha=True)
    trues = np.column_stack([
        rng.uniform(20.0, 45.0, nsources),
        rng.uniform(1.4, 2.2, nsources),
        np.full(nsources, 250.0),
        np.full(nsources, 3.5),
        rng.uniform(10.0, 80.0, nsources),
    ])
    # a shared 30% calibration floor correlates the band errors
    corr = 0.3 * np.ones((nb, nb)) + 0.7 * np.eye(nb)
    L = np.linalg.cholesky(corr)
    flux, unc = [], []
    for t in trues:
        f = mbb_fnu(torch.tensor(t, dtype=torch.float32),
                    torch.tensor(wave, dtype=torch.float32),
                    shape).double().numpy()
        u = 0.05 * f
        flux.append(f + u * (L @ rng.standard_normal(nb)))
        unc.append(u)
    flux, unc = np.array(flux), np.array(unc)
    # raggedness: every 3rd source missing the 100um band; every 4th
    # source's 500um flux is only an upper limit
    flux[::3, 0] = np.nan
    unc[::3, 0] = np.nan
    uplims = np.zeros((nsources, nb), bool)
    uplims[::4, nb - 1] = True
    flux[::4, nb - 1] *= 1.5          # quote the limit above the model
    return flux, unc, corr, uplims


S = 8 if QUICK else 64
NWALKERS, NBURN, NSTEPS = (64, 30, 60) if QUICK else (250, 150, 500)
flux, unc, corr, uplims = fake_ragged_batch(S)

mf = MultiFitter(nwalkers=NWALKERS, opthin=True, noalpha=True, seed=1,
                 device=args.device)
mf.set_uplim("T", 100.0).set_uplim("beta", 5.0)
mf.set_data(wave, flux, unc)

# Upper limits and correlated errors do not compose (one-sided +
# correlation is ill-defined); pick per batch. Here: correlation.
mf.set_band_correlation(corr)

# triage first: MAP + Laplace for the whole batch at once, then seed the
# MCMC at each source's own mode (short burns suffice)
mf.run_map(verbose=True)
n_is = 128 if QUICK else 512
ess = mf.map_importance(n_is)       # weighted posteriors + ESS certificate
print(f"triage: median ess/N = {np.median(ess) / n_is:.2f}; "
      f"{int((~mf.map_interior).sum())}/{S} modes at a box edge")
mf.run(nburn=NBURN, nsteps=NSTEPS, init="map")

# run-until-converged serving loop (works on both devices)
max_records = 240 if QUICK else 4000
while True:
    ok = mf.converged(rhat_max=1.1, window=min(250, NSTEPS // 2))
    if ok.all() or mf.chain_free.shape[1] >= max_records:
        break
    print(f"{int((~ok).sum())}/{S} sources above R-hat 1.1; extending")
    mf.extend(NSTEPS)

cen = mf.par_cen("T")
print(f"fit {S} ragged sources; T medians "
      f"{cen[:, 0].min():.1f}-{cen[:, 0].max():.1f} K, "
      f"max split-R-hat {mf.gelman_rubin().max():.3f}")

# goodness-of-fit sweep: which sources does the MBB model NOT describe?
# (per-source chi-square discrepancy p-values; handles the missing
# bands and the correlated whitening exactly as the likelihood did)
ppc = mf.posterior_predictive(thin=4)
print(f"PPC: median p {np.median(ppc.p_value):.2f}; "
      f"{int((ppc.p_value < 0.01).sum())}/{S} sources flagged p<0.01")

# the one-sided path instead (diagonal errors):
mf2 = MultiFitter(nwalkers=NWALKERS, opthin=True, noalpha=True, seed=2,
                  device=args.device)
mf2.set_data(wave, flux, unc)
mf2.set_phot_upperlimits(uplims)     # per-source (S, nb) mask
mf2.run(nburn=NBURN, nsteps=NSTEPS)
print(f"one-sided batch: max split-R-hat {mf2.gelman_rubin().max():.3f}")
