"""Fit one source under a full calibration covariance AND a photometric
upper limit -- the complete error model (the torch twin of
examples/fit_covariance_uplims.py; the CLI analog is

    run_mbb_emcee_tpu_torch phot.txt fit.h5 --covfile cov.fits \
        --phot-uplim 4
).

    python examples/fit_covariance_uplims_torch.py [--device cuda|cpu]

Real survey photometry is rarely diagonal: bands on one instrument share
a calibration systematic (PACS 100/160 move together; SPIRE 250/350/500
move together), and the faintest band is often only a quoted limit.
This example builds C = diag(sigma^2) + rho (f_cal)(f_cal)^T with
within-instrument correlation, marks the 500 um flux column as an upper
limit, and fits. The one-sided limit penalty clamps the band residual
BEFORE the Cholesky whitening (the same ordering the fp64 oracle uses in
tools/validate_tpu_parity.py config6). On a CUDA device the whole run is
still one launch of the stretch-move kernel per sampling phase.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import MBBFitter, MBBResults

QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NWALKERS, NBURN, NSTEPS = (64, 30, 60) if QUICK else (250, 200, 1000)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0])
flux = np.array([11.2, 32.1, 44.8, 38.2, 29.0])   # 500 um value = LIMIT
unc = 0.06 * flux

# Calibration covariance: 5% correlated calibration term on top of the
# statistical diagonal, correlated within each instrument (PACS bands
# 0-1, SPIRE bands 2-4). PSD by the Schur product theorem.
instr = np.array([0, 0, 1, 1, 1])
rho = np.where(instr[:, None] == instr[None, :], 0.5, 0.0)
np.fill_diagonal(rho, 1.0)
cal = 0.05 * flux
cov = np.diag(unc ** 2) + rho * np.outer(cal, cal)

fit = MBBFitter(nwalkers=NWALKERS, seed=42, device=args.device)
fit.set_data(wave, flux, unc, cov=cov)
# The 500 um flux column is a quoted upper limit: only model flux ABOVE
# the limit is penalized (one-sided likelihood at that band).
fit.set_phot_upperlimits([False, False, False, False, True])
fit.set_uplim("T", 100.0)
fit.set_gaussian_prior("beta", 2.0, 0.5)

fit.run(nburn=NBURN, nsteps=NSTEPS, verbose=True)

res = MBBResults(fit=fit, redshift=2.2)
res.compute_lir()
print(res)
print("sampler backend:", type(fit.sampler).__name__)

# The same error model serves whole catalogs: MultiFitter's
# set_band_correlation(R) applies one shared band-correlation matrix
# with per-source sigmas (see examples/serve_correlated_tempered_torch.py),
# and per-source upper-limit masks ride the sign of the inverse-
# uncertainty operand (examples/serve_ragged_catalog_torch.py).
