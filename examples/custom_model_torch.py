"""Fitting a model the reference never had: the sampler tiers are
model-agnostic (the torch twin of examples/custom_model.py, on
mbb_emcee_tpu_torch).

    python examples/custom_model_torch.py [--device cuda|cpu]

Every sampler in this package (stretch-move `EnsembleSampler`,
`hmc_sample`, `nested_sample`, `pt_sample`) takes a plain torch function
of a BATCH of parameter vectors, lnprob_batch((n, ndim)) -> (n,) -- the
MBB fitter classes are conveniences on top, not requirements. This
example builds a TWO-TEMPERATURE greybody (a cold + a warm dust
component, the standard extension when a single MBB cannot fit both the
peak and the Wien side; cf. Dunne & Eales 2001) out of the same physics
primitive `log_mbb_fnu`, then

  1. samples its posterior with the generic ensemble sampler,
  2. cross-checks with gradient-based HMC (the model is plain torch, so
     torch.autograd works -- no hand-written derivatives),
  3. asks the evidence whether the data actually justify the second
     component (nested sampling, 1- vs 2-component Bayes factor).

Parameters: theta = (T_cold, T_warm, beta, fnorm_cold, fnorm_warm),
optically thin, no Wien power-law (each component's own Wien side is
already physical). Everything runs on --device (default cuda; without a
card it stops and says so: pass --device cpu to run on the CPU).
"""

import argparse
import os
import sys

import numpy as np

# runnable as `python examples/<name>.py` from anywhere
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch

from mbb_emcee_tpu_torch import (EnsembleSampler, hmc_sample, nested_sample,
                                 log_mbb_fnu)
from mbb_emcee_tpu_torch.fitter import resolve_device
from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
from mbb_emcee_tpu_torch.sampler import make_initial_ball

# MBB_EXAMPLE_QUICK=1 shrinks the run for the suite's example smoke test.
QUICK = os.environ.get("MBB_EXAMPLE_QUICK", "") not in ("", "0")
NWALKERS, NBURN, NSTEPS = (64, 150, 400) if QUICK else (256, 400, 1200)
NLIVE = 96 if QUICK else 400

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
DEVICE = resolve_device(ap.parse_args().device)

SHAPE = MBBShape(opthin=True, noalpha=True)
# 9 bands spanning the peak and both tails -- two components need more
# spectral leverage than a single-MBB 5-band fit.
WAVE = np.array([60.0, 100.0, 160.0, 250.0, 350.0, 500.0, 850.0,
                 1100.0, 2000.0])


def two_mbb_fnu(theta, wave):
    """Cold + warm greybody, shared beta. theta: (Tc, Tw, beta, fc, fw)."""
    t_c, t_w, beta, f_c, f_w = theta
    # Reuse the validated single-MBB primitive: pack each component's
    # (T, beta, lambda0, alpha, fnorm); lambda0/alpha are inert under
    # opthin+noalpha.
    pin = [torch.full_like(t_c, 250.0), torch.full_like(t_c, 4.0)]
    p_c = torch.stack([t_c, beta, *pin, f_c])
    p_w = torch.stack([t_w, beta, *pin, f_w])
    return (torch.exp(log_mbb_fnu(p_c, wave, SHAPE))
            + torch.exp(log_mbb_fnu(p_w, wave, SHAPE)))


# Synthetic data from a known two-component truth (observer frame).
TRUE = np.array([18.0, 45.0, 1.8, 40.0, 6.0])
rng = np.random.default_rng(11)
flux_true = two_mbb_fnu(torch.tensor(TRUE, dtype=torch.float32),
                        torch.tensor(WAVE, dtype=torch.float32)).numpy()
unc = 0.05 * flux_true
flux = flux_true + unc * rng.standard_normal(WAVE.size)

# Prior box. T_w > T_c is enforced by disjoint temperature ranges (the
# cheap way to break the label-switching symmetry).
LOWER = np.array([5.0, 25.0, 0.5, 1.0, 0.1])
UPPER = np.array([25.0, 120.0, 3.5, 300.0, 100.0])


def _dev(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)


_wave_t, _flux_t, _iunc_t = _dev(WAVE), _dev(flux), _dev(1.0 / unc)
_lo, _hi = _dev(LOWER), _dev(UPPER)
# The port's samplers take lnprob over a BATCH of parameter vectors (the
# JAX example hands its samplers a scalar lnprob(theta) and jax.random
# keys; here the batch comes from torch.func.vmap of the single-theta
# model, and each sampler takes an integer seed of its Philox stream).
_fnu_batch = torch.func.vmap(two_mbb_fnu, in_dims=(0, None))


def lnlike(theta):
    r = (_fnu_batch(theta, _wave_t) - _flux_t) * _iunc_t
    return -0.5 * torch.sum(r * r, dim=-1)


def lnprob(theta):
    inside = torch.all((theta >= _lo) & (theta <= _hi), dim=-1)
    return torch.where(inside, lnlike(theta),
                       torch.full_like(theta[:, 0], -torch.inf))


# 1. Generic stretch-move ensemble over the custom model --------------
ndim = 5
sampler = EnsembleSampler(NWALKERS, ndim, lnprob)
center = 0.5 * (LOWER + UPPER)
p0 = make_initial_ball(torch.Generator().manual_seed(1), center,
                       0.15 * center, NWALKERS, LOWER, UPPER, device=DEVICE)
state = sampler.init_state(p0, seed=2)
state = sampler.advance(state, NBURN)
state, chain, lnp = sampler.run_mcmc(state, NSTEPS)
flat = chain.reshape(-1, ndim).double().cpu().numpy()
names = ["T_cold", "T_warm", "beta", "fnorm_cold", "fnorm_warm"]
print(f"stretch-move acceptance "
      f"{float(np.mean(sampler.acceptance_fraction(state))):.2f}")
for i, nm in enumerate(names):
    lo, med, hi = np.percentile(flat[:, i], [15.85, 50.0, 84.15])
    print(f"  {nm:11s} = {med:8.2f} +{hi - med:6.2f} -{med - lo:6.2f}"
          f"   (true {TRUE[i]:.1f})")

# 2. HMC cross-check: torch.autograd of the same lnprob ---------------
hmc = hmc_sample(lnprob, LOWER, UPPER, _dev(flat[-64:]), seed=3,
                 nwarmup=NBURN * 2, nsteps=NSTEPS)
hmc_med = np.percentile(hmc.chain.reshape(-1, ndim).double().cpu().numpy(),
                        50.0, axis=0)
# agreement at the posterior's own scale: |d median| within one 68% CI
# half-width (finite chains of DIFFERENT samplers never match tighter)
q = np.percentile(flat, [15.85, 50.0, 84.15], axis=0)
halfwidth = 0.5 * (q[2] - q[0])
print(f"HMC acceptance {float(np.mean(hmc.acceptance_fraction)):.2f}; "
      f"medians within one CI half-width of the stretch move: "
      f"{bool(np.all(np.abs(hmc_med - q[1]) < halfwidth))}")


# 3. Does the evidence support the second component? ------------------
def lnlike_1comp(theta):           # (T, beta, fnorm) single MBB
    pin = [torch.full_like(theta[:, 0], 250.0),
           torch.full_like(theta[:, 0], 4.0)]
    p = torch.stack([theta[:, 0], theta[:, 1], *pin, theta[:, 2]], dim=-1)
    r = (torch.exp(log_mbb_fnu(p, _wave_t, SHAPE)) - _flux_t) * _iunc_t
    return -0.5 * torch.sum(r * r, dim=-1)


z2 = nested_sample(lnlike, LOWER, UPPER, seed=4, nlive=NLIVE,
                   device=DEVICE)
z1 = nested_sample(lnlike_1comp, LOWER[[0, 2, 3]], UPPER[[1, 2, 3]],
                   seed=5, nlive=NLIVE, device=DEVICE)
dlnz = z2.logz - z1.logz
print(f"lnZ(2-comp) - lnZ(1-comp) = {dlnz:.1f} "
      f"+/- {np.hypot(z2.logz_err, z1.logz_err):.1f}")
print("the data", "DEMAND the warm component" if dlnz > 5 else
      "do not need two components")

# 4. Or skip the scaffolding: the SEDFitter surface -------------------
# Everything above (plus covariance handling, response curves, fixed
# params, priors, L_IR / peak-lambda posteriors, PPC, HDF5) comes
# packaged: describe the model once and reuse the whole MBB pipeline.
from mbb_emcee_tpu_torch import SEDModel, SEDFitter  # noqa: E402

model = SEDModel(fnu=two_mbb_fnu, param_names=names,
                 lower=LOWER, upper=UPPER, name="two-temp-greybody")
fit = SEDFitter(model, nwalkers=NWALKERS, redshift=2.0, seed=6,
                device=DEVICE)
fit.set_data(WAVE, flux, unc)
for nm, v in zip(names, 0.5 * (LOWER + UPPER)):
    fit.set_param_init(nm, v, 0.15 * v)
fit.set_gaussian_prior("beta", 1.8, 0.5)
fit.run(nburn=NBURN, nsteps=NSTEPS)
res = fit.results()
ppc = res.posterior_predictive(thin=4)
print(f"SEDFitter: T_cold = {res.par_cen('T_cold')[0]:.1f}, "
      f"T_warm = {res.par_cen('T_warm')[0]:.1f}, "
      f"L_IR = {res.lir_cen()[0]:.3g} Lsun, PPC p = {ppc.p_value:.2f}")

# 5. Serve a CATALOG of the custom model ------------------------------
# SEDMultiFitter fits S sources in lockstep (one batch stretch step for
# the whole catalog), with the same serving loop the MBB batch surface
# has: extend-until-converged, batched derived posteriors, per-source PPC.
from mbb_emcee_tpu_torch import SEDMultiFitter  # noqa: E402

S = 4 if QUICK else 32
rng2 = np.random.default_rng(21)
cat_truths = np.column_stack([
    rng2.uniform(14.0, 22.0, S), rng2.uniform(38.0, 55.0, S),
    np.full(S, 1.8), rng2.uniform(15.0, 80.0, S),
    rng2.uniform(1.0, 10.0, S)])
cat_flux = _fnu_batch(torch.tensor(cat_truths, dtype=torch.float32),
                      torch.tensor(WAVE, dtype=torch.float32)).numpy()
cat_unc = 0.05 * cat_flux
cat_flux = cat_flux + cat_unc * rng2.standard_normal(cat_flux.shape)

smf = SEDMultiFitter(model, nwalkers=NWALKERS, seed=8, device=DEVICE)
smf.set_data(WAVE, cat_flux, cat_unc, redshifts=np.full(S, 2.0))
for nm, v in zip(names, 0.5 * (LOWER + UPPER)):
    smf.set_param_init(nm, v, 0.15 * v)
smf.set_gaussian_prior("beta", 1.8, 0.5)
smf.run(nburn=NBURN, nsteps=NSTEPS)
# extend-until-converged, bounded (an example should always terminate;
# production loops bound by wall-clock or a max-steps budget the same way)
for _ in range(2):
    if smf.converged(rhat_max=1.2, window=min(NSTEPS, 256)).all():
        break
    smf.extend(NSTEPS // 2)
cen = smf.par_cen("T_cold")
ppc_b = smf.posterior_predictive(thin=4)
print(f"catalog of {S}: T_cold medians within 5 sigma of truth: "
      f"{bool(np.all(np.abs(cen[:, 0] - cat_truths[:, 0]) <= 5 * np.maximum(cen[:, 1], cen[:, 2])))}; "
      f"median PPC p {np.median(ppc_b.p_value):.2f}")
