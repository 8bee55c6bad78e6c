"""CMB heating and background corrections for high-redshift greybody fits.

Torch twin of mbb_emcee_tpu/models/cmb.py. At z of a few and beyond, the
CMB HEATS the grains (the dust temperature cannot fall below
T_CMB(z) = T_CMB,0 (1+z)) and it is the BACKGROUND the photometry is
measured against (only the contrast above the CMB is observable); ignoring
both biases T low and the inferred dust mass high for cold high-z sources.
The treatment is da Cunha et al. (2013, ApJ 766, 13):

  T_dust(z)   = [ T_intr^(4+beta) + T_CMB,0^(4+beta) ((1+z)^(4+beta) - 1)
                ]^(1/(4+beta))                                    (eq. 12)
  S_obs(nu)  /= 1 - B_nu(T_CMB(z)) / B_nu(T_dust(z))              (eq. 18)

`cmb_corrected_mbb` returns a generic-tier sed.SEDModel (not an MBBShape
flag: the kernels stay the 5-parameter MBB's), so the model runs through
every SEDFitter / SEDResults tier. Its parameters are REST-FRAME: T is the
intrinsic dust temperature and lambda0 the rest-frame opacity pivot; fnorm
stays the OBSERVED flux at the observed `wavenorm`.

Everything is fp32-safe in log space: B(T_CMB)/B(T_dust) =
expm1(x_dust)/expm1(x_cmb) is a difference of ln-expm1 terms (x_cmb reaches
~10^3 on the Wien side, where e^x overflows fp32 but the ratio underflows
harmlessly to 0).
"""

from __future__ import annotations

import math

import torch

from mbb_emcee_tpu_torch.constants import HCOK_UM_K
from mbb_emcee_tpu_torch.models.modified_blackbody import (
    log_mbb_fnu, MBBShape)
from mbb_emcee_tpu_torch.ops.special import log_expm1

# Fixsen (2009) CMB monopole temperature.
T_CMB0 = 2.72548


def cmb_temperature(z, t_cmb0=T_CMB0):
    """T_CMB at redshift z (adiabatic scaling)."""
    return t_cmb0 * (1.0 + z)


def dust_temperature_with_cmb(t_intrinsic, beta, z, t_cmb0=T_CMB0):
    """da Cunha et al. (2013) eq. 12: the equilibrium dust temperature when
    starlight heating (which alone would produce `t_intrinsic`) and CMB
    heating at redshift z both act on grains with a nu^beta emissivity;
    `t_intrinsic` and `beta` are tensors, z a number. Reduces to
    t_intrinsic at z = 0.

    Evaluated in log space: T^(4+beta) overflows fp32 directly (500 K at
    beta = 10 is ~6e37)."""
    p = 4.0 + beta
    opz = 1.0 + z
    log_heat = (p * math.log(t_cmb0)
                + torch.log(torch.clamp(opz ** p - 1.0, min=1e-30)))
    return torch.exp(torch.logaddexp(p * torch.log(t_intrinsic),
                                     log_heat) / p)


def log_cmb_visibility(wave_rest, t_dust, z, t_cmb0=T_CMB0):
    """ln[1 - B_nu(T_CMB(z)) / B_nu(T_dust)] at rest wavelength (um).

    The observable fraction of the dust emission (da Cunha+13 eq. 18): -> 0
    (fully visible) on the Wien side or for warm dust; -> -inf as T_dust ->
    T_CMB(z) (the source vanishes against the background)."""
    x_d = HCOK_UM_K / (wave_rest * t_dust)
    x_c = HCOK_UM_K / (wave_rest * cmb_temperature(z, t_cmb0))
    log_ratio = torch.clamp(log_expm1(x_d) - log_expm1(x_c), max=0.0)
    # Clip just below 1 so a T_dust == T_CMB corner stays finite (the
    # box-floored lnprob then rejects it rather than NaN-ing).
    return torch.log1p(-torch.clamp(torch.exp(log_ratio), max=1.0 - 1e-7))


def cmb_corrected_mbb(z, opthin=False, noalpha=False, wavenorm=500.0,
                      t_cmb0=T_CMB0, name=None, lower=None, upper=None):
    """sed.SEDModel: greybody with da Cunha+2013 CMB corrections at
    redshift z.

    Parameters (T, beta, lambda0, alpha, fnorm) with T the INTRINSIC
    rest-frame dust temperature (K) and lambda0 the REST-frame opacity pivot
    (um); fnorm is the observed flux (mJy) at the observed `wavenorm` (um).
    `opthin` drops the opacity term, `noalpha` the Wien-side power law (fix
    the unused parameter with fit.fix_param as usual).

    Identifiability: for T well below T_CMB(z) the equilibrium temperature
    saturates at the CMB floor and the likelihood goes exactly flat in T, so
    single-temperature ensembles that wander onto the plateau mix very
    slowly; exclude it with fit.set_lowlim("T", ...) at roughly 0.5-0.7
    T_CMB(z), or sample with run_pt.
    """
    from mbb_emcee_tpu_torch.sed import SEDModel
    from mbb_emcee_tpu_torch.likelihood import DEFAULT_LOWER, DEFAULT_UPPER

    zf = float(z)
    if zf < 0.0:
        raise ValueError(f"redshift must be >= 0, got {zf}")
    opz = 1.0 + zf
    wn_rest = float(wavenorm) / opz
    # Internal MBB normalization point = the rest-frame equivalent of
    # wavenorm; its choice cancels in the self-normalization below.
    shape = MBBShape(opthin=bool(opthin), noalpha=bool(noalpha),
                     wavenorm=wn_rest)

    def fnu(theta, wave_obs):
        t_int, beta, lam0, alpha, fnorm = (theta[0], theta[1], theta[2],
                                           theta[3], theta[4])
        wn = wave_obs.new_full((1,), wn_rest)
        t_d = dust_temperature_with_cmb(t_int, beta, zf, t_cmb0)
        th = torch.stack([t_d, beta, lam0, alpha, torch.ones_like(t_d)])
        w_rest = wave_obs / opz
        log_s = (log_mbb_fnu(th, w_rest, shape)
                 + log_cmb_visibility(w_rest, t_d, zf, t_cmb0))
        # Self-normalize: S_obs(wavenorm_obs) = fnorm, CMB factor included
        # (what a real measurement at wavenorm sees).
        log_norm = (log_mbb_fnu(th, wn, shape)[0]
                    + log_cmb_visibility(wn, t_d, zf, t_cmb0)[0])
        return torch.exp(log_s - log_norm + torch.log(fnorm))

    return SEDModel(
        fnu=fnu,
        param_names=("T", "beta", "lambda0", "alpha", "fnorm"),
        lower=DEFAULT_LOWER.copy() if lower is None else lower,
        upper=DEFAULT_UPPER.copy() if upper is None else upper,
        name=name or f"cmb-mbb-z{zf:g}")
