"""Hierarchical population inference: what distribution was the catalog
drawn from? (the torch twin of examples/population_inference.py, on
mbb_emcee_tpu_torch)

    python examples/population_inference_torch.py [--device cuda|cpu]

Per-source fits answer "what is THIS galaxy's T?"; the survey question is
"what is the population's T distribution?".  Averaging the per-source
medians is wrong twice over (it ignores per-source uncertainty AND
selection against the box), so this example does it properly: fit the
whole catalog as one batch (one multi-source kernel launch per sampling
phase on a CUDA device), then run the hierarchical importance-reweighting
tier over the stored chains --
ln L(phi) = sum_s ln < p(theta_sn|phi) / pi0(theta_sn) > -- one batched
(hyper-walkers x sources x samples) evaluation per stretch half-step. The
command-line analog is

    run_mbb_emcee_tpu_torch_batch catalog.txt batch.h5 --population T

The punchline printed at the end: the naive scatter of per-source medians
OVERESTIMATES the population width (it adds the measurement widths in),
while the hierarchical sigma_T posterior deconvolves them.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MultiFitter, fit_population
from mbb_emcee_tpu_torch.models.modified_blackbody import mbb_fnu, MBBShape

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NSOURCES = 8 if QUICK else 64
NWALKERS, NBURN, NSTEPS = (64, 30, 80) if QUICK else (128, 100, 400)
HBURN, HSTEPS = (60, 200) if QUICK else (300, 1200)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(42)
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])

# --- the truth: a T-population the catalog is drawn from -------------------
MU_T, SIGMA_T = 34.0, 4.0
t_true = np.clip(rng.normal(MU_T, SIGMA_T, NSOURCES), 15.0, 55.0)


def mock_catalog():
    shape = MBBShape(opthin=True, noalpha=True)
    flux, unc = [], []
    for t in t_true:
        th = np.array([t, 1.8, 250.0, 4.0, rng.uniform(20.0, 60.0)])
        f = mbb_fnu(torch.tensor(th, dtype=torch.float32),
                    torch.tensor(wave, dtype=torch.float32),
                    shape).double().numpy()
        u = 0.06 * f
        flux.append(f + u * rng.standard_normal(wave.size))
        unc.append(u)
    return np.array(flux), np.array(unc)


flux, unc = mock_catalog()

# --- stage 1: batched per-source fits --------------------------------------
mf = MultiFitter(nwalkers=NWALKERS, opthin=True, noalpha=True, seed=7,
                 device=args.device)
mf.set_data(wave, flux, unc)
mf.set_uplim("T", 100.0)
t0 = time.time()
mf.run(nburn=NBURN, nsteps=NSTEPS)
print(f"{NSOURCES} sources fit in {time.time() - t0:.1f}s")

# --- stage 2: the population posterior -------------------------------------
t0 = time.time()
hf = fit_population(mf, params=("T",), nburn=HBURN, nsteps=HSTEPS,
                    nwalkers=64)
mu = hf.par_cen("mu_T")
sig = hf.par_cen("sigma_T")
ess = hf.reweight_ess()
print(f"population fit in {time.time() - t0:.1f}s  "
      f"(min reweight-ESS {ess.min():.0f}/{hf.samples.shape[1]})")

t_med = mf.par_cen("T")[:, 0]
print(f"truth:             mu_T = {MU_T:.2f}   sigma_T = {SIGMA_T:.2f}")
print(f"naive median stats: mean = {t_med.mean():.2f}   "
      f"scatter = {t_med.std(ddof=1):.2f}   <- measurement-broadened")
print(f"hierarchical:      mu_T = {mu[0]:.2f} +{mu[1]:.2f} -{mu[2]:.2f}   "
      f"sigma_T = {sig[0]:.2f} +{sig[1]:.2f} -{sig[2]:.2f}")
