"""Fit one source end-to-end (the torch twin of examples/fit_single_source.py,
on mbb_emcee_tpu_torch): the library-API analog of the CLI run

    run_mbb_emcee_tpu_torch phot.txt fit.h5 -z 2.2 --get-lir --get-dustmass \
        --get-peaklambda

    python examples/fit_single_source_torch.py [--device cuda|cpu]

Produces posterior summaries for the model parameters and the derived
physical quantities, persisted to HDF5. On a CUDA device each sampling
phase is one launch of the stretch-move kernel; --device cpu runs the
plain torch sampler (without a card the fit stops and says so).
"""

import argparse
import os
import sys

import numpy as np

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MBBFitter, MBBResults

# MBB_EXAMPLE_QUICK=1 shrinks the run so the test suite can smoke-run
# the example in seconds (tests/test_torch_examples.py).
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NWALKERS, NBURN, NSTEPS = (64, 30, 60) if QUICK else (250, 200, 1000)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

# Mock 5-band Herschel-like photometry (wave um, flux mJy, 1-sigma mJy).
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
flux = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
unc = 0.06 * flux

fit = MBBFitter(nwalkers=NWALKERS, seed=42, device=args.device)
fit.set_data(wave, flux, unc)

# Parameter-space configuration (all optional):
fit.set_uplim("T", 100.0)               # hard box limit
fit.set_gaussian_prior("beta", 2.0, 0.5)
# fit.fix_param("alpha", 3.5)           # remove a parameter from sampling
# fit.set_phot_upperlimits([True, False, False, False, False])

fit.run(nburn=NBURN, nsteps=NSTEPS, verbose=True)

res = MBBResults(fit=fit, redshift=2.2, cosmology="WMAP9")
res.compute_lir()          # 8-1000 um rest-frame IR luminosity posterior
res.compute_dustmass()     # kappa = 2.64 m^2/kg at rest 125 um
res.compute_peaklambda()   # observed-frame SED peak wavelength
print(res)

res.writeToHDF5("fit.h5")
# full analysis resumes from disk, on the device named here
back = MBBResults(h5file="fit.h5", device=args.device)
print("round-trip T:", back.par_cen("T"))
