"""Submillimeter photometric redshift: sample z jointly with the dust SED
(the torch twin of examples/photoz_fit.py, on mbb_emcee_tpu_torch).

    python examples/photoz_fit_torch.py [--device cuda|cpu]

The upstream workflow fixes z and fits (T, beta, ...); survey work often
has it backwards -- the dust SED is the only redshift indicator in hand.
`photoz_mbb()` makes z the sixth sampled parameter (rest-frame T and
lambda0, da Cunha+2013 CMB corrections on by default) and runs through
the whole generic tier.

The physics to respect: without CMB corrections, (T, lambda0, z) and
(T/s, lambda0*s, (1+z)s - 1) give IDENTICAL observed SEDs -- the data
constrain T/(1+z) only. A Gaussian prior on T (here: a population
temperature from a calibration sample, 38 +- 6 K) is what turns the
ridge into a posterior; the z error bar then honestly carries the prior
width, which the fixed-z workflow cannot do.

Derived quantities marginalize over z per sample:
compute_lir(z_param="z") and photoz.compute_dustmass use each sample's
own integration window, luminosity distance, and (with cmb=True) the
contrast-emission Planck factor. The fit runs on --device (default cuda;
without a card it stops and says so: pass --device cpu to run on the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np
import torch

from mbb_emcee_tpu_torch import photoz_mbb, SEDFitter, reweight_prior
from mbb_emcee_tpu_torch.photoz import compute_dustmass, dustmass_cen

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

model = photoz_mbb(cmb=True, z_upper=8.0)

# Synthetic SPIRE+ground submm photometry of a z=4 dusty galaxy.
wave = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
truth = np.array([38.0, 1.9, 80.0, 3.0, 10.0, 4.0])
f_true = model.fnu(torch.tensor(truth, dtype=torch.float32),
                   torch.tensor(wave, dtype=torch.float32)).double().numpy()
unc = 0.07 * f_true
rng = np.random.default_rng(42)
flux = f_true + unc * rng.standard_normal(wave.size)

fit = SEDFitter(model, nwalkers=64 if QUICK else 250, seed=11,
                device=args.device)
fit.set_data(wave, flux, unc)
fit.set_gaussian_prior("T", 38.0, 6.0)   # the identifiability prior
fit.fix_param("alpha", 3.0)              # no bands blueward of the peak
for nm, v in zip(model.param_names, truth):
    fit.set_param_init(nm, v, 0.1 * abs(v))

fit.run(nburn=100 if QUICK else 400, nsteps=250 if QUICK else 1500)
res = fit.results()

zc = res.par_cen("z")
tc = res.par_cen("T")
print(f"z    = {zc[0]:.2f} +{zc[1]:.2f} -{zc[2]:.2f}   (truth {truth[5]})")
print(f"T    = {tc[0]:.1f} +{tc[1]:.1f} -{tc[2]:.1f} K  (prior 38 +- 6)")

# z-marginalized derived posteriors.
res.compute_lir(z_param="z", thin=4)
lir = res.lir_cen()
print(f"L_IR = {lir[0]:.3g} +{lir[1]:.2g} -{lir[2]:.2g} Lsun "
      "(marginalized over z)")
compute_dustmass(res, thin=4)
dm = dustmass_cen(res)
print(f"Mdust= {dm[0]:.3g} +{dm[1]:.2g} -{dm[2]:.2g} Msun "
      "(CMB contrast-corrected)")

# Prior sensitivity WITHOUT refitting: what if the calibration sample
# had said 33 +- 5 K instead? PSIS-reweight the stored chain and check
# the trust diagnostics before believing the shift.
rw = reweight_prior(res, "T", 33.0, 5.0)
zc2 = rw.par_cen("z")
print(f"under T ~ N(33, 5):  z = {zc2[0]:.2f} +{zc2[1]:.2f} "
      f"-{zc2[2]:.2f}   ({rw!r})")
