"""Instrument-response mode: band-integrated model fluxes (the torch twin
of examples/fit_with_responses.py, on mbb_emcee_tpu_torch).

    python examples/fit_with_responses_torch.py [--device cuda|cpu]

Filters come from 2-column text files (wavelength_um response) or analytic
specs ('box:center:width', 'gauss:center:fwhm', 'delta:wave'); each is
compiled to fixed quadrature nodes/weights at setup, so the likelihood's
band integration is a weighted sum inside the sampler kernel (the
reference re-runs np.trapz over the filter grid in every likelihood
call).
"""

import argparse
import os
import sys

import numpy as np

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MBBFitter, MBBResults, ResponseSet

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NWALKERS, NBURN, NSTEPS = (64, 30, 60) if QUICK else (250, 200, 800)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

here = os.path.dirname(os.path.abspath(__file__))

rs = ResponseSet()
rs.add("PACS100", "gauss:100:35")               # analytic stand-ins
rs.add("PACS160", "gauss:160:60")
rs.add("SPIRE250", "example_250um.txt", dir=os.path.join(here, "filters"))
rs.add("SPIRE350", "box:350:90")
rs.add("SPIRE500", "box:500:130")
# Photon-counting detector convention: rs.add(..., photon_counter=True)

names = ["PACS100", "PACS160", "SPIRE250", "SPIRE350", "SPIRE500"]
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
flux = np.array([11.2, 32.1, 44.8, 38.2, 22.9])
unc = 0.06 * flux

fit = MBBFitter(nwalkers=NWALKERS, responses=rs, seed=7, device=args.device)
fit.set_data(wave, flux, unc, band_names=names)
fit.run(nburn=NBURN, nsteps=NSTEPS, verbose=True)

res = MBBResults(fit=fit, redshift=1.5)
res.compute_peaklambda()
print(res)
