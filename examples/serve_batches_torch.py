"""Batched serving: fit many sources per device computation (the torch
twin of examples/serve_batches.py, on mbb_emcee_tpu_torch).

    python examples/serve_batches_torch.py [--device cuda|cpu]

A survey pipeline fits thousands of objects with one model configuration.
MultiFitter treats the SOURCE axis as the batch axis; on a CUDA device
each sampling phase of a whole batch (burn, re-burn after re-centering,
production) is one launch of the multi-source stretch-move kernel, and
successive same-shape batches reuse the built kernel (photometry is a
runtime operand). The command-line analog is

    run_mbb_emcee_tpu_torch_batch catalog.txt batch.h5 --get-lir --summary
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MultiFitter
from mbb_emcee_tpu_torch.models.modified_blackbody import mbb_fnu, MBBShape

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NSOURCES, NBATCHES = (8, 1) if QUICK else (256, 3)
NWALKERS, NBURN, NSTEPS = (64, 30, 60) if QUICK else (250, 150, 1000)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])

mf = MultiFitter(nwalkers=NWALKERS, seed=1, device=args.device)
mf.set_uplim("T", 100.0).set_uplim("beta", 5.0)


def fake_batch(nsources):
    """Stand-in for 'read the next batch from the survey catalog':
    greybody SEDs with randomized parameters + 5% noise."""
    trues = np.column_stack([
        rng.uniform(20.0, 45.0, nsources),    # T/(1+z)
        rng.uniform(1.4, 2.2, nsources),      # beta
        rng.uniform(150.0, 350.0, nsources),  # lambda0 (1+z)
        rng.uniform(2.5, 4.5, nsources),      # alpha
        rng.uniform(10.0, 80.0, nsources),    # fnorm
    ])
    flux = np.stack([
        mbb_fnu(torch.tensor(t, dtype=torch.float32),
                torch.tensor(wave, dtype=torch.float32),
                MBBShape()).double().numpy()
        for t in trues])
    unc = 0.05 * flux
    return flux + unc * rng.standard_normal(flux.shape), unc


for batch_idx in range(NBATCHES):
    flux, unc = fake_batch(NSOURCES)
    mf.set_data(wave, flux, unc)
    t0 = time.perf_counter()
    mf.run(nburn=NBURN, nsteps=NSTEPS)
    dt = time.perf_counter() - t0
    t_cen = mf.par_cen("T")                # (S, 3) per-source summaries
    print(f"batch {batch_idx}: {NSOURCES} sources in {dt:.2f}s  "
          f"(median T = {np.median(t_cen[:, 0]):.1f} K)")

# Batched derived-quantity posteriors with per-source redshifts. Thin the
# chains for derived quantities: every ~50th sample is statistically
# equivalent for percentile summaries, at a fiftieth of the work.
redshifts = rng.uniform(1.0, 3.5, NSOURCES)
mf.compute_lir(redshifts, thin=10 if QUICK else 50)
print("L_IR percentiles per source:", mf.lir_cen().shape)   # (S, 3)

# Any single source still gets the full single-source analysis surface:
pick = min(17, NSOURCES - 1)
res = mf.results(pick, redshift=float(redshifts[pick]))
res.compute_dustmass(thin=10 if QUICK else 50)
res.writeToHDF5("source17.h5")
print(res)

# Multi-GPU: sharding the source axis over several cards (the JAX
# package's walker_mesh) waits for its port, ROADMAP.md queue A, item
# A11; until then one MultiFitter runs on one card.
