"""Bayesian model comparison: which greybody variant do the data want?
(the torch twin of examples/model_comparison.py, on mbb_emcee_tpu_torch)

    python examples/model_comparison_torch.py [--device cuda|cpu]

Upstream mbb_emcee users chose between the optically-thin and
optically-thick model (and with/without the Wien-side power law) by
eyeballing chi-square. Nested sampling makes that quantitative: the
evidence ln Z = ln integral L(theta) pi(theta) dtheta of each variant,
and exp(lnZ_A - lnZ_B) is the Bayes factor. Conventions: |dlnZ| > 1 is
"worth mentioning", > 3 "strong", > 5 "decisive" (Jeffreys scale).

The prior BOX is part of each model -- keep it honest and identical on
shared parameters, or the comparison is meaningless. On a CUDA device
each likelihood batch of the nested sampler is one launch of the lnprob
kernel. The command-line analog is run_mbb_emcee_tpu_torch ...
--get-evidence, once per variant.
"""

import argparse
import os
import sys

import numpy as np

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from mbb_emcee_tpu_torch import (
    MBBFitter, MBBResults, ModifiedBlackbody, compare_loo)

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NLIVE = 96 if QUICK else 512

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

# Synthetic photometry drawn from an optically-THIN greybody, so we know
# which model should win.
rng = np.random.default_rng(7)
wave = np.array([100.0, 160.0, 250.0, 350.0, 500.0, 850.0])
true = ModifiedBlackbody(T=34.0, beta=1.8, lambda0=250.0, alpha=2.0,
                         fnorm=45.0, opthin=True, noalpha=True)
flux = np.asarray(true(wave), np.float64)
unc = 0.05 * flux
flux = flux + rng.normal(0.0, unc)


def make_fitter(opthin):
    f = MBBFitter(nwalkers=64, opthin=opthin, noalpha=True, seed=3,
                  device=args.device)
    f.set_data(wave, flux, unc)
    # Shared prior box on the common parameters (identical in both
    # models -- the Bayes factor compares the models, not the priors).
    f.set_lowlim("T", 10.0); f.set_uplim("T", 80.0)
    f.set_lowlim("beta", 0.5); f.set_uplim("beta", 4.0)
    f.set_lowlim("fnorm", 5.0); f.set_uplim("fnorm", 300.0)
    if not opthin:
        # The thick model's extra parameter and its prior range: wider
        # range = larger Occam penalty if the data don't constrain it.
        f.set_lowlim("lambda0", 10.0); f.set_uplim("lambda0", 2000.0)
    return f


z_thin = make_fitter(opthin=True).compute_evidence(nlive=NLIVE, verbose=True)
z_thick = make_fitter(opthin=False).compute_evidence(nlive=NLIVE,
                                                     verbose=True)

dlnz = z_thin.logz - z_thick.logz
err = np.hypot(z_thin.logz_err, z_thick.logz_err)
print(f"ln Z(thin)  = {z_thin.logz:8.3f} +/- {z_thin.logz_err:.3f}")
print(f"ln Z(thick) = {z_thick.logz:8.3f} +/- {z_thick.logz_err:.3f}")
print(f"ln Bayes factor thin/thick = {dlnz:.3f} +/- {err:.3f}")
if dlnz > 0:
    print("the data prefer the optically-THIN model (as constructed)")
else:
    print("the thick model absorbs the data better than its Occam cost")

# The weighted dead points double as posterior samples -- no extra MCMC
# run needed for a quick look at the winning model's parameters:
mean = z_thin.posterior_mean()
print("thin-model posterior mean (T, beta, fnorm):",
      np.round(mean[[0, 1, 4]], 3))

# -- the predictive view: WAIC / PSIS-LOO cross-validation --------------------
# The evidence asks "which model explains the data best a priori"; elpd
# asks "which model PREDICTS held-out bands better". Both run from the
# same machinery; LOO needs chains, so run the stretch sampler briefly.
NB, NS = (30, 80) if QUICK else (150, 400)
loos = {}
for opthin in (True, False):
    f = make_fitter(opthin=opthin)
    f.run(nburn=NB, nsteps=NS)
    loos[opthin] = MBBResults(fit=f, redshift=1.5).compute_loo()
cmp = compare_loo(loos[True], loos[False])
print(f"elpd_loo(thin)  = {loos[True].elpd_loo:8.3f} "
      f"+/- {loos[True].se_elpd_loo:.3f}")
print(f"elpd_loo(thick) = {loos[False].elpd_loo:8.3f} "
      f"+/- {loos[False].se_elpd_loo:.3f}")
print(f"paired elpd difference thin-thick = {cmp.elpd_diff:.3f} "
      f"+/- {cmp.se_diff:.3f} -> favored: {cmp.favored}")
# k-hat > 0.7 flags bands whose PSIS estimate is untrustworthy; settle
# them exactly with fit.compute_loo_exact(bands=[...]) -- all the
# leave-one-band-out refits advance as ONE batch (one multi-source kernel
# launch per sampling phase on a CUDA device).
k = np.maximum(loos[True].pareto_k, loos[False].pareto_k)
print("max Pareto k-hat over both models:", float(k.max()).__round__(2))
