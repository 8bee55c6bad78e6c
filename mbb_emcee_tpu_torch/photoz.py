"""Photometric-redshift greybody fitting: z as a SAMPLED parameter.

Torch twin of mbb_emcee_tpu/photoz.py. Far-IR / submm surveys often have
no redshift but the dust SED itself (submm photo-z), so z is sampled
jointly with the dust parameters and every derived quantity is
marginalized over its posterior. `photoz_mbb()` returns a generic-tier
model (sed.SEDModel) with parameters (T, beta, lambda0, alpha, fnorm, z),
T and lambda0 in the REST frame, that runs through the whole generic
surface unchanged: SEDFitter and SEDMultiFitter, HMC, parallel tempering,
nested evidence, MAP triage, instrument responses, upper limits, PPC,
WAIC / LOO and HDF5.

Identifiability -- read before fitting:

- Without the CMB terms (cmb=False) the greybody is EXACTLY degenerate
  under (T, lambda0, 1 + z) -> (T / s, lambda0 * s, s (1 + z)): the
  observed SED fixes T / (1 + z), never T and z apart. A photo-z fit
  without CMB terms therefore needs outside information: a Gaussian prior
  on T (`fit.set_gaussian_prior("T", mu, sigma)`, for instance a
  population temperature from a calibration sample) or tight priors on
  lambda0 and beta. The posterior of z then carries the whole prior width,
  the honest error bar a fixed-z fit cannot give.
- With cmb=True (the default) the da Cunha et al. (2013) heating floor and
  background subtraction (models/cmb.py) tie the SED's shape to the
  absolute temperature and break the degeneracy, but only weakly and only
  at high z: they sharpen the high-z tail and do not replace a T prior at
  moderate z.
- T is the INTRINSIC (starlight-only) rest-frame temperature when
  cmb=True, the plain rest-frame temperature when cmb=False.

Derived quantities marginalize over z sample by sample:
`SEDResults.compute_lir(z_param="z")` (sed.py) and
`SEDMultiFitter.compute_lir(z_param="z")` integrate each sample over its
own rest [8, 1000] um window with its own D_L; `compute_dustmass` and
`compute_dustmass_batch` apply the (CMB-aware) kappa B_nu mass formula with
each sample's z. The observed peak wavelength needs no z.

The JAX package memoizes photoz_mbb by its arguments so fitters share
traced programs; torch traces nothing, so there is no memo here: two calls
with the same arguments return EQUAL models, not the same object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.constants import HCOK_UM_K
from mbb_emcee_tpu_torch.likelihood import DEFAULT_LOWER, DEFAULT_UPPER
from mbb_emcee_tpu_torch.models.cmb import (
    T_CMB0, dust_temperature_with_cmb, log_cmb_visibility)
from mbb_emcee_tpu_torch.models.cosmology import luminosity_distance_batch
from mbb_emcee_tpu_torch.models.modified_blackbody import (
    MBBShape, log_mbb_fnu)
from mbb_emcee_tpu_torch.sed import SEDModel

PARAM_NAMES = ("T", "beta", "lambda0", "alpha", "fnorm", "z")


@dataclasses.dataclass(frozen=True)
class PhotoZMBBModel(SEDModel):
    """sed.SEDModel carrying the photo-z greybody's configuration, so the
    dust-mass helpers read the physics flags instead of guessing them from
    parameter names."""
    opthin: bool = False
    noalpha: bool = False
    cmb: bool = True
    t_cmb0: float = T_CMB0
    wavenorm: float = 500.0


def photoz_mbb(opthin=False, noalpha=False, wavenorm=500.0, cmb=True,
               t_cmb0=T_CMB0, z_lower=0.0, z_upper=12.0,
               name=None, lower=None, upper=None):
    """PhotoZMBBModel: a greybody with the redshift as its sixth parameter.

    Parameters (T, beta, lambda0, alpha, fnorm, z): T the rest-frame dust
    temperature in K (the intrinsic, starlight-only one when cmb=True),
    lambda0 the REST-frame opacity pivot in um, fnorm the OBSERVED flux in
    mJy at the observed `wavenorm` (500 um by default, the reference's
    convention), z the redshift, bounded to [z_lower, z_upper]. `opthin`
    drops the opacity term and `noalpha` the Wien-side power law (fix the
    unused parameter with fit.fix_param as usual); cmb=True applies the da
    Cunha+2013 heating and background corrections (models/cmb.py).

    Without CMB terms T and z are exactly degenerate: set a Gaussian prior
    on T (fit.set_gaussian_prior("T", mu, sigma)) -- see the module
    docstring."""
    zl, zu = float(z_lower), float(z_upper)
    if not (zl >= 0.0 and zu > zl):
        raise ValueError(f"need 0 <= z_lower < z_upper, got ({zl}, {zu})")
    if lower is None:
        lower = np.concatenate([DEFAULT_LOWER, [zl]])
    if upper is None:
        upper = np.concatenate([DEFAULT_UPPER, [zu]])
    wn = float(wavenorm)
    use_cmb = bool(cmb)
    t0 = float(t_cmb0)
    # fnu normalizes itself at the (sampled) rest-frame image of wavenorm,
    # so the shape's own normalization point cancels exactly
    shape = MBBShape(opthin=bool(opthin), noalpha=bool(noalpha),
                     wavenorm=500.0)

    def fnu(theta, wave_obs):
        t, beta, lam0, alpha, fnorm, zz = (theta[0], theta[1], theta[2],
                                           theta[3], theta[4], theta[5])
        opz = 1.0 + zz
        t_e = dust_temperature_with_cmb(t, beta, zz, t0) if use_cmb else t
        th = torch.stack([t_e, beta, lam0, alpha, torch.ones_like(t_e)])
        w_rest = wave_obs / opz
        # the sampled normalization point goes in as a 1-element grid
        wn_rest = (wn / opz).reshape(1)
        log_s = log_mbb_fnu(th, w_rest, shape)
        log_n = log_mbb_fnu(th, wn_rest, shape)[0]
        if use_cmb:
            log_s = log_s + log_cmb_visibility(w_rest, t_e, zz, t0)
            log_n = log_n + log_cmb_visibility(wn_rest, t_e, zz, t0)[0]
        return torch.exp(log_s - log_n + torch.log(fnorm))

    return PhotoZMBBModel(
        fnu=fnu, param_names=PARAM_NAMES, lower=lower, upper=upper,
        name=name or ("photoz-cmb-mbb" if use_cmb else "photoz-mbb"),
        opthin=bool(opthin), noalpha=bool(noalpha), cmb=use_cmb, t_cmb0=t0,
        wavenorm=wn)


def _require_photoz_model(model, what):
    if not isinstance(model, PhotoZMBBModel):
        raise TypeError(
            f"{what} needs a PhotoZMBBModel fit "
            f"(got {type(model).__name__}); for fixed-z MBB fits use "
            "MBBResults.compute_dustmass")
    return model


def _dustmass_g(model, kappa_wave, device):
    """one(theta (npar,)) -> 0-dim tensor, for torch.func.vmap over the
    chain: S_obs / occupation factor, the occupation factor being the
    contrast B_nu(T_dust) - B_nu(T_CMB(z)) (cmb=True) or the plain
    B_nu(T) (cmb=False), both without the Planck amplitude, which
    derived.dustmass_prefactor applies on the host."""
    zi = model.param_index("z")
    kw = float(kappa_wave)
    use_cmb = model.cmb
    t0 = model.t_cmb0
    fnu = model.fnu
    unit = torch.ones(1, dtype=torch.float32, device=device)

    def one(theta):
        opz = 1.0 + theta[zi]
        s_mjy = fnu(theta, unit * (kw * opz))[0]
        t_e = (dust_temperature_with_cmb(theta[0], theta[1], theta[zi], t0)
               if use_cmb else theta[0])
        # the rest-frame Planck argument at the kappa wavelength
        x_d = HCOK_UM_K / (kw * t_e)
        if use_cmb:
            x_c = HCOK_UM_K / (kw * t0 * opz)
            occ = (1.0 / torch.expm1(torch.clamp(x_d,
                                                 max=derived.DUST_X_CLAMP))
                   - 1.0 / torch.expm1(torch.clamp(
                       x_c, max=derived.DUST_X_CLAMP)))
            return s_mjy / torch.clamp(occ, min=1e-20)
        return s_mjy * torch.expm1(torch.clamp(x_d, max=derived.DUST_X_CLAMP))

    return one


def _prefactor(z, kappa, kappa_wave, cosmology):
    """derived.dustmass_prefactor for a sampled redshift of any shape, with
    one vectorized fp64 D_L pass."""
    z = np.asarray(z, np.float64)
    dl = luminosity_distance_batch(z.ravel(), cosmology).reshape(z.shape)
    return derived.dustmass_prefactor(dl, 1.0 + z, float(kappa),
                                      float(kappa_wave))


def compute_dustmass(res, kappa=2.64, kappa_wave=125.0, thin=1):
    """Dust-mass posterior in M_sun of a photo-z fit, marginalized over
    the per-sample redshift.

    MBBResults.compute_dustmass's physics (kappa = 2.64 m^2/kg at rest
    125 um, Dunne et al. 2003) with two changes: each sample uses ITS OWN
    z for the observed wavelength kappa_wave (1 + z), the luminosity
    distance and the (1 + z) factor; and with cmb=True the Planck factor
    is the CONTRAST B_nu(T_dust) - B_nu(T_CMB(z)) (da Cunha+13 eq. 18
    applied to the mass inversion): the model's observed flux is contrast
    flux, so dividing by the whole B_nu(T_dust) would bias the mass low at
    high z.

    `res` is an SEDResults over a PhotoZMBBModel; the chain goes through
    one vmapped call on the results' device. Stores and returns
    res.dustmass_chain; summarize with dustmass_cen(res)."""
    model = _require_photoz_model(res._require_model(),
                                  "photoz.compute_dustmass")
    if getattr(res, "lumdist", None) is not None:
        raise ValueError(
            "explicit lumdist= cannot combine with a photo-z dust mass: "
            "each sample carries its own redshift (same rule as "
            "compute_lir(z_param=...))")
    zi = model.param_index("z")
    device = getattr(res, "device", "cpu")
    samples = np.asarray(res._thinned(thin), np.float64)
    g = torch.func.vmap(_dustmass_g(model, kappa_wave, device))(
        torch.as_tensor(samples.astype(np.float32), device=device))
    res.dustmass_chain = (_prefactor(samples[:, zi], kappa, kappa_wave,
                                     res._cosmo)
                          * g.double().cpu().numpy())
    res.dustmass_meta = {"kappa": float(kappa),
                         "kappa_wave": float(kappa_wave),
                         "thin": int(thin), "z_param": "z"}
    return res.dustmass_chain


def compute_dustmass_batch(mf, kappa=2.64, kappa_wave=125.0, thin=1,
                           cosmology="WMAP9"):
    """(S, nsamples) photo-z dust-mass posteriors of a whole catalog (an
    SEDMultiFitter over a PhotoZMBBModel): compute_dustmass's physics
    vmapped over sources x samples on the chain's device, in sample-axis
    chunks, with one vectorized fp64 D_L pass over every (source, sample)
    redshift. Stores and returns mf.dustmass_chain."""
    model = _require_photoz_model(mf.model, "photoz.compute_dustmass_batch")
    zi = model.param_index("z")
    samples = mf._thinned(thin)                    # (S, N, npar) device
    one = torch.func.vmap(torch.func.vmap(
        _dustmass_g(model, kappa_wave, samples.device)))
    g = derived._chunked_samples(one, samples, 4)
    z = samples[..., zi].double().cpu().numpy()
    mf.dustmass_chain = _prefactor(z, kappa, kappa_wave, cosmology) * g
    mf.dustmass_meta = {"kappa": float(kappa),
                        "kappa_wave": float(kappa_wave),
                        "thin": int(thin), "z_param": "z"}
    return mf.dustmass_chain


def dustmass_cen(res, percentile=68.3):
    """(median, +err, -err) of the photo-z dust-mass posterior; runs
    compute_dustmass with its defaults first if needed."""
    if getattr(res, "dustmass_chain", None) is None:
        compute_dustmass(res)
    return derived._percentile_summary(res.dustmass_chain, percentile)
