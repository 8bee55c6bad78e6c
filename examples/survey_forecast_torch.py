"""Survey design with Fisher forecasts: what actually pins the photo-z?
(The torch twin of examples/survey_forecast.py, on mbb_emcee_tpu_torch.)

    python examples/survey_forecast_torch.py [--device cuda|cpu]

Before proposing for time, interrogate the error budget in microseconds
per configuration: the forecast is the Cramer-Rao floor of the SAME
likelihood the fitter will sample (the flux Jacobian is torch.func.jacfwd
of the model), so "add a 2 mm point", "double the 850 um depth", or "get a
better temperature calibration" become one-line questions.

The answer it gives for a z ~ 4 dusty galaxy is the submm photo-z
literature's own: on the T-(1+z) ridge the redshift error is PRIOR
dominated -- piling on bands or depth barely moves sigma(z) (they buy
fnorm/beta precision instead), while tightening the temperature prior
moves it almost one-for-one. The money is in the calibration sample,
not the integration time. (Fisher shows this in a table; finding it
with mock MCMCs costs a fit per cell.) The model and its Jacobian run on
--device (default cuda; without a card it stops and says so: pass
--device cpu to run on the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np
import torch

from mbb_emcee_tpu_torch import forecast, photoz_mbb
from mbb_emcee_tpu_torch.fitter import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
DEVICE = resolve_device(ap.parse_args().device)

model = photoz_mbb(cmb=True, z_upper=10.0)
fiducial = np.array([38.0, 1.9, 80.0, 3.0, 10.0, 4.0])
# design assumptions: a literature beta prior, a fixed opacity pivot,
# no Wien-side bands (alpha inert). Three bands of data cannot float
# five shape parameters -- the forecast SAYS so (a singular-Fisher
# error) if you try.
BETA_PRIOR = ("beta", (1.9, 0.3))
FIXED = ("alpha", "lambda0")


def depth(wave, frac=0.07):
    """Expected 1-sigma depths as a fraction of the fiducial flux."""
    f = model.fnu(torch.tensor(fiducial, dtype=torch.float32,
                               device=DEVICE),
                  torch.tensor(wave, dtype=torch.float32, device=DEVICE))
    return frac * f.double().cpu().numpy()


BAND_SETS = {
    "SPIRE only (250/350/500)": np.array([250.0, 350.0, 500.0]),
    "+ SCUBA-2 850": np.array([250.0, 350.0, 500.0, 850.0]),
    "+ 850 + 1.1mm + 2mm": np.array([250.0, 350.0, 500.0, 850.0,
                                     1100.0, 2000.0]),
}

print(f"photo-z forecast at z = {fiducial[5]:g} (7% depths)\n")
print(f"{'configuration':42s} {'sigma(z)':>9s} {'sigma(T)/K':>11s}")
for name, wave in BAND_SETS.items():
    fr = forecast(model, fiducial, wave, unc=depth(wave),
                  priors=dict([("T", (38.0, 6.0)), BETA_PRIOR]),
                  fixed=FIXED, device=DEVICE)
    print(f"{name + ', T prior 6 K':42s} {fr.sigma('z'):9.2f} "
          f"{fr.sigma('T'):11.2f}")

# the lever that actually moves sigma(z): the temperature calibration
wave = BAND_SETS["+ 850 + 1.1mm + 2mm"]
for t_sig in (6.0, 3.0, 1.5):
    fr = forecast(model, fiducial, wave, unc=depth(wave),
                  priors=dict([("T", (38.0, t_sig)), BETA_PRIOR]),
                  fixed=FIXED, device=DEVICE)
    print(f"{'all six bands, T prior %.1f K' % t_sig:42s} "
          f"{fr.sigma('z'):9.2f} {fr.sigma('T'):11.2f}")

# ... and the error is FRACTIONAL in (1+z), as the ridge geometry says
# it must be: sigma(z)/(1+z) stays put as the source moves out.
fid6 = fiducial.copy()
fid6[5] = 6.5
fr = forecast(model, fid6, wave, unc=depth(wave),
              priors=dict([("T", (38.0, 6.0)), BETA_PRIOR]), fixed=FIXED,
              device=DEVICE)
print(f"\nsame six bands at z = 6.5, T prior 6 K: sigma(z) = "
      f"{fr.sigma('z'):.2f} -- sigma(z)/(1+z) ~ constant: the T prior "
      "sets a FRACTIONAL redshift error")
