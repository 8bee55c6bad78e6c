"""Correlated calibration errors + resumable tempered serving (the torch
twin of examples/serve_correlated_tempered.py, on mbb_emcee_tpu_torch).

    python examples/serve_correlated_tempered_torch.py [--device cuda|cpu]

Two production concerns in one script:

1. A real survey shares one instrument CALIBRATION-floor correlation
   across every source (each with its own per-band sigmas). One
   `set_band_correlation(R)` call applies the exact error model
   C_s = D_s R D_s -- missing bands marginalized per pattern -- in
   every tier, the multi-source stretch-move kernel included.

2. Optically-thick fits support a T-lambda0 bimodality that a
   single-temperature ensemble can straddle for a long time. The
   batched parallel-tempering tier (`run_pt`) crosses modes via hot
   rungs and yields per-source stepping-stone evidences -- and with
   `checkpoint=`, a long tempered run flushes its COMPLETE per-source
   state every interval, so a kill resumes (`resume=True`) to the
   bitwise-identical chain and lnZ. The command-line analog is

    run_mbb_emcee_tpu_torch_batch catalog.txt out.h5 --corrfile cov.fits \
        --pt --checkpoint pt.ckpt.h5
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

QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NSOURCES = 8 if QUICK else 64
NWALKERS, NBURN, NSTEPS = (16, 10, 20) if QUICK else (64, 200, 600)
PT_RUNGS = 4 if QUICK else 8

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(7)
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])

# shared 30% calibration floor on top of independent per-band scatter
R = 0.3 * np.ones((wave.size, wave.size)) + 0.7 * np.eye(wave.size)


def fake_batch(nsources):
    trues = np.column_stack([
        rng.uniform(20.0, 45.0, nsources),
        rng.uniform(1.4, 2.2, nsources),
        rng.uniform(150.0, 350.0, nsources),
        rng.uniform(2.5, 4.5, nsources),
        rng.uniform(10.0, 80.0, nsources)])
    flux = np.stack([
        mbb_fnu(torch.tensor(t, dtype=torch.float32),
                torch.tensor(wave, dtype=torch.float32),
                MBBShape()).double().numpy()
        for t in trues])
    unc = 0.05 * flux
    # correlated noise: shared calibration draw + independent scatter
    L = np.linalg.cholesky(R)
    eps = rng.standard_normal(flux.shape) @ L.T
    return flux + unc * eps, unc


flux, unc = fake_batch(NSOURCES)

# -- 1. correlated stretch-move fit (the kernel on CUDA, plain on CPU) ------
mf = MultiFitter(nwalkers=NWALKERS, seed=11, device=args.device)
mf.set_data(wave, flux, unc)
mf.set_band_correlation(R)
t0 = time.perf_counter()
mf.run(nburn=NBURN, nsteps=NSTEPS)
print(f"correlated batch fit: {NSOURCES} sources x {NWALKERS} walkers "
      f"in {time.perf_counter() - t0:.2f}s "
      f"(backend: {mf._backend_used})")
cen = mf.par_cen("T")
print(f"  T medians span [{cen[:, 0].min():.1f}, {cen[:, 0].max():.1f}] K")

# -- 2. resumable tempered run with per-source evidence ----------------------
ck = os.path.join(os.getcwd(), "pt_serve.ckpt.h5")
mf2 = MultiFitter(nwalkers=NWALKERS, seed=11, device=args.device)
mf2.set_data(wave, flux, unc)
mf2.set_band_correlation(R)
t0 = time.perf_counter()
mf2.run_pt(nrungs=PT_RUNGS, nburn=NBURN, nsteps=NSTEPS,
           checkpoint=ck, checkpoint_interval=max(NSTEPS // 3, 1))
print(f"tempered run ({PT_RUNGS} rungs) in {time.perf_counter() - t0:.2f}s; "
      f"checkpoint flushed to {os.path.basename(ck)}")
logz, logz_err = mf2.logz_pt
print(f"  stepping-stone lnZ in [{logz.min():.1f}, {logz.max():.1f}] "
      f"(median err {np.median(logz_err):.3f})")

# a killed run would continue with:
#   mf3 = MultiFitter(nwalkers=NWALKERS, seed=11, device=args.device)
#   mf3.set_data(wave, flux, unc); mf3.set_band_correlation(R)
#   mf3.run_pt(nrungs=PT_RUNGS, nburn=NBURN, nsteps=NSTEPS,
#              checkpoint=ck, resume=True)     # bitwise continuation
os.remove(ck)
print("ok")
