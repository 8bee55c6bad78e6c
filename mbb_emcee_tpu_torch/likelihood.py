"""Photometry container and the batched lnprob factory.

Torch twin of mbb_emcee_tpu/likelihood.py: Gaussian
lnL = -1/2 Delta^T C^-1 Delta with C = diag(sigma^2) or a full covariance,
hard box limits, optional Gaussian priors and fixed parameters, sampled in
the reduced free-parameter space. The covariance Cholesky factor is inverted
once host-side in fp64; out-of-box proposals are clamped before the model
evaluation and masked to the finite LNPROB_FLOOR.

`build_lnprob` returns a function of a (n, nfree) batch; it is the plain
version the CUDA lnprob kernel (ops/lnprob_kernel.py) is held against.
`build_lnprob_data` is the batch tier's: per-source photometry as
arguments, (S, n, nfree) -> (S, n), the plain version of the multi-source
kernel's likelihood.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import PARAM_NAMES, NPARAMS
from mbb_emcee_tpu_torch.models.modified_blackbody import (
    log_mbb_fnu, MBBShape)
from mbb_emcee_tpu_torch.utils.fits import read_fits_image

# Finite lnprob floor standing in for -inf.
LNPROB_FLOOR = -1e30

# Acceptance-guard threshold: a lnprob at or below it is the out-of-box
# floor. An fp32 acceptance uniform can be exactly 0 and log(0) = -inf
# compares below even LNPROB_FLOOR, so samplers add
# `& (lnp_prop > SUPPORT_FLOOR)` to their accept masks.
SUPPORT_FLOOR = -1e25

# Default hard box (observer frame).
DEFAULT_LOWER = np.array([0.1, 0.01, 1.0, 0.01, 1e-5], dtype=np.float64)
DEFAULT_UPPER = np.array([1e3, 20.0, 2e4, 60.0, 1e7], dtype=np.float64)


def param_index(name_or_idx):
    """Accept a parameter name (case-insensitive, 'T'/'beta'/...) or index."""
    if isinstance(name_or_idx, (int, np.integer)):
        idx = int(name_or_idx)
        if not 0 <= idx < NPARAMS:
            raise ValueError(f"parameter index {idx} out of range")
        return idx
    lowered = [p.lower() for p in PARAM_NAMES]
    key = str(name_or_idx).lower()
    if key in lowered:
        return lowered.index(key)
    aliases = {"t/(1+z)": 0, "temperature": 0, "lambda_0": 2,
               "lambda0*(1+z)": 2, "f500": 4}
    if key in aliases:
        return aliases[key]
    raise ValueError(f"unknown parameter {name_or_idx!r}; "
                     f"known: {PARAM_NAMES}")


@dataclasses.dataclass
class Photometry:
    """Observed photometry: wavelengths (um), fluxes and errors (mJy),
    optional full covariance (mJy^2) and band names."""
    wave: np.ndarray
    flux: np.ndarray
    unc: np.ndarray
    cov: np.ndarray | None = None
    band_names: list[str] | None = None

    def __post_init__(self):
        self.wave = np.atleast_1d(np.asarray(self.wave, dtype=np.float64))
        self.flux = np.atleast_1d(np.asarray(self.flux, dtype=np.float64))
        self.unc = np.atleast_1d(np.asarray(self.unc, dtype=np.float64))
        n = self.wave.size
        if self.flux.size != n or self.unc.size != n:
            raise ValueError("photometry wave/flux/unc length mismatch")
        if np.any(self.unc <= 0):
            raise ValueError("photometric uncertainties must be positive")
        if self.cov is not None:
            self.cov = np.asarray(self.cov, dtype=np.float64)
            if self.cov.shape != (n, n):
                raise ValueError(
                    f"covariance shape {self.cov.shape} != ({n},{n})")
        if self.band_names is not None and len(self.band_names) != n:
            raise ValueError("band_names length mismatch")

    @property
    def nbands(self):
        return self.wave.size

    @classmethod
    def from_file(cls, photfile):
        """Text photometry: '[name] wave flux unc' per line, # comments."""
        waves, fluxes, uncs, names = [], [], [], []
        have_names = None
        with open(photfile) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                try:
                    float(parts[0])
                    named = False
                except ValueError:
                    named = True
                if have_names is None:
                    have_names = named
                elif have_names != named:
                    raise ValueError(
                        f"{photfile}:{lineno}: inconsistent columns")
                if named:
                    if len(parts) < 4:
                        raise ValueError(
                            f"{photfile}:{lineno}: need 'name wave flux unc'")
                    names.append(parts[0])
                    parts = parts[1:]
                elif len(parts) < 3:
                    raise ValueError(
                        f"{photfile}:{lineno}: need 'wave flux unc'")
                waves.append(float(parts[0]))
                fluxes.append(float(parts[1]))
                uncs.append(float(parts[2]))
        if not waves:
            raise ValueError(f"{photfile}: no photometry found")
        return cls(np.array(waves), np.array(fluxes), np.array(uncs),
                   band_names=names if have_names else None)

    def read_cov(self, covfile, covextn=0, is_total=False):
        """Attach a covariance from a FITS extension. Unless is_total, it is
        ADDITIONAL calibration covariance on top of diag(unc^2)."""
        cov = np.asarray(read_fits_image(covfile, extn=covextn), np.float64)
        n = self.wave.size
        if cov.shape != (n, n):
            raise ValueError(
                f"{covfile}[{covextn}]: covariance shape {cov.shape} "
                f"does not match the {n}-band photometry -- wrong "
                "extension (covextn) or wrong file?")
        if not np.allclose(cov, cov.T, rtol=1e-8, atol=0.0):
            raise ValueError(
                f"{covfile}[{covextn}]: covariance matrix is not symmetric")
        if not is_total:
            cov = cov + np.diag(self.unc ** 2)
        if np.linalg.eigvalsh(cov).min() <= 0:
            raise ValueError(
                f"{covfile}[{covextn}]: covariance is not positive "
                "definite" + ("" if is_total else
                              " (even after adding diag(unc^2))"))
        self.cov = cov
        return self


@dataclasses.dataclass(frozen=True)
class LikelihoodSpec:
    """Frozen parameter-space configuration the lnprob is built from."""
    lower: np.ndarray          # (5,) hard box
    upper: np.ndarray          # (5,)
    fixed: np.ndarray          # (5,) bool
    fixed_values: np.ndarray   # (5,) values used where fixed
    prior_mean: np.ndarray     # (5,)
    prior_isigma: np.ndarray   # (5,) 1/sigma, 0 disables the prior
    # Photometric upper limits: one-sided Gaussian penalty above the limit
    # for bands flagged here (flux column = limit value).
    uplim_bands: np.ndarray | None = None  # (nbands,) bool

    @classmethod
    def default(cls):
        return cls(lower=DEFAULT_LOWER.copy(), upper=DEFAULT_UPPER.copy(),
                   fixed=np.zeros(NPARAMS, bool),
                   fixed_values=np.zeros(NPARAMS),
                   prior_mean=np.zeros(NPARAMS),
                   prior_isigma=np.zeros(NPARAMS))

    @classmethod
    def for_box(cls, lower, upper):
        """A spec of any size from an explicit hard box, nothing fixed and
        no priors: the parameter space of a non-MBB lnprob (the population
        tier's hyper-parameters, hierarchy.py)."""
        lower = np.asarray(lower, np.float64).copy()
        upper = np.asarray(upper, np.float64).copy()
        if lower.shape != upper.shape or lower.ndim != 1:
            raise ValueError("lower/upper must be matching 1-D arrays")
        if np.any(lower >= upper):
            raise ValueError("each lower limit must be < its upper limit")
        n = lower.size
        return cls(lower=lower, upper=upper, fixed=np.zeros(n, bool),
                   fixed_values=np.zeros(n), prior_mean=np.zeros(n),
                   prior_isigma=np.zeros(n))

    @property
    def free_indices(self):
        return np.nonzero(~self.fixed)[0]

    @property
    def nfree(self):
        return int((~self.fixed).sum())


@dataclasses.dataclass(frozen=True)
class FreeSpace:
    """Mapping between the reduced sampling space and full theta."""
    free_idx: np.ndarray       # (nfree,)
    template: np.ndarray       # (npar,) zeros at free slots, fixed values
    lower: np.ndarray          # (nfree,)
    upper: np.ndarray          # (nfree,)

    @property
    def nfree(self):
        return self.free_idx.size

    @classmethod
    def from_spec(cls, spec):
        """The reduced space a LikelihoodSpec defines (the one place this
        mapping is derived)."""
        free_idx = spec.free_indices
        if free_idx.size == 0:
            raise ValueError("all parameters are fixed; nothing to sample")
        return cls(free_idx=free_idx,
                   template=np.where(spec.fixed, spec.fixed_values, 0.0),
                   lower=spec.lower[free_idx].copy(),
                   upper=spec.upper[free_idx].copy())

    def scatter_matrix(self, dtype=np.float64):
        """(npar, nfree) scatter: theta = template + scatter @ free, sized
        from the template so a spec of any size shares this mapping."""
        s = np.zeros((self.template.size, self.nfree), dtype)
        s[self.free_idx, np.arange(self.nfree)] = 1.0
        return s

    def expand(self, free_vals):
        """(..., nfree) free-space -> (..., npar) full parameter vectors."""
        free_vals = np.asarray(free_vals)
        out = np.broadcast_to(self.template,
                              free_vals.shape[:-1]
                              + (self.template.size,)).copy()
        out[..., self.free_idx] = free_vals
        return out

    def reduce(self, full_vals):
        return np.asarray(full_vals)[..., self.free_idx]


class SpecArrays(NamedTuple):
    """Host fp64 arrays every lnprob factory derives from a LikelihoodSpec."""
    free_space: FreeSpace
    template: np.ndarray       # (5,)
    lo_free: np.ndarray        # (nfree,) sampling box
    hi_free: np.ndarray
    lo_full: np.ndarray        # (5,) NaN-safety clip window, widened
    hi_full: np.ndarray        # to contain out-of-box fixed values
    prior_mean: np.ndarray     # (5,)
    prior_isig: np.ndarray


def spec_arrays(spec: LikelihoodSpec) -> SpecArrays:
    """Derive the reduced-space mapping, clip window and prior arrays.

    The clip window CONTAINS fixed values that sit outside the sampling box
    (fix_param('alpha', 0.0) with the default lower of 0.01): clamping a
    fixed parameter to the box would evaluate a different model than the
    kernel, which widens its window around the fixed value."""
    free_space = FreeSpace.from_spec(spec)
    free_idx = free_space.free_idx
    return SpecArrays(
        free_space=free_space,
        template=np.asarray(free_space.template, np.float64),
        lo_free=spec.lower[free_idx].copy(),
        hi_free=spec.upper[free_idx].copy(),
        lo_full=np.where(spec.fixed, np.minimum(spec.lower,
                                                spec.fixed_values),
                         spec.lower),
        hi_full=np.where(spec.fixed, np.maximum(spec.upper,
                                                spec.fixed_values),
                         spec.upper),
        prior_mean=np.asarray(spec.prior_mean, np.float64),
        prior_isig=np.asarray(spec.prior_isigma, np.float64))


def build_lnprob(phot: Photometry, shape: MBBShape, spec: LikelihoodSpec,
                 response_pack=None, device=None):
    """Build the batched lnprob over the FREE parameter space.

    Returns (lnprob_fn, free_space); lnprob_fn maps a (n, nfree) fp32
    tensor on `device` to (n,) log-probabilities. With `response_pack` =
    (waves, weights), each of shape (nbands, nnodes), model fluxes are
    band-integrated; otherwise the SED is sampled at the data wavelengths.
    `device` None is the card (fitter.resolve_device: without one this
    raises, naming device="cpu").
    """
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    sa = spec_arrays(spec)
    free_space = sa.free_space

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    free_idx = torch.as_tensor(free_space.free_idx, device=device)
    template, lo_free, hi_free, lo_full, hi_full, prior_mean, prior_isig = (
        dev(a) for a in sa[1:])
    data_flux = dev(phot.flux)
    data_wave = dev(phot.wave)

    if phot.cov is not None:
        whiten = dev(np.linalg.inv(np.linalg.cholesky(phot.cov)))
        diag_iunc = None
    else:
        whiten = None
        diag_iunc = dev(1.0 / phot.unc)

    uplim = None
    if spec.uplim_bands is not None and np.any(spec.uplim_bands):
        uplim = torch.as_tensor(np.asarray(spec.uplim_bands, bool),
                                device=device)

    if response_pack is not None:
        resp_waves, resp_weights = (dev(a) for a in response_pack)

    def model_fluxes(theta):
        if response_pack is None:
            return torch.exp(log_mbb_fnu(theta, data_wave, shape))
        vals = torch.exp(log_mbb_fnu(theta, resp_waves, shape))
        return torch.sum(resp_weights * vals, dim=-1)

    def lnprob(theta_free):
        n = theta_free.shape[0]
        theta = template.expand(n, NPARAMS).clone()
        theta[:, free_idx] = theta_free
        inbox = torch.all((theta_free >= lo_free) & (theta_free <= hi_free),
                          dim=-1)
        theta_safe = torch.minimum(torch.maximum(theta, lo_full), hi_full)
        delta = model_fluxes(theta_safe) - data_flux
        if uplim is not None:
            # Upper-limit bands: penalize only flux above the limit.
            delta = torch.where(uplim, torch.clamp(delta, min=0.0), delta)
        if whiten is not None:
            # r = L^-1 delta, written out (no matmul, so no TF32 question)
            r = torch.sum(whiten * delta[:, None, :], dim=-1)
        else:
            r = delta * diag_iunc
        lnl = -0.5 * torch.sum(r * r, dim=-1)
        dp = (theta - prior_mean) * prior_isig
        lnpri = -0.5 * torch.sum(dp * dp, dim=-1)
        return torch.where(inbox, lnl + lnpri,
                           torch.full_like(lnl, LNPROB_FLOOR))

    return lnprob, free_space


def signed_iunc(unc, uplim_bands=None):
    """(..., nb) inverse uncertainties with NEGATIVE sign marking
    upper-limit slots (the encoding build_lnprob_data and the multi-source
    kernel read). `uplim_bands` may be a shared (nb,) mask, a per-source
    (S, nb) mask, or None; non-finite unc (missing bands) maps to exactly 0
    weight either way. Host fp64: 1/sigma is rounded to fp32 once, later."""
    unc = np.asarray(unc, np.float64)
    if np.any(np.isfinite(unc) & (unc <= 0.0)):
        raise ValueError(
            "uncertainties must be positive; mark missing bands with "
            "NaN/inf, not 0 (1/0 = inf would silently floor every "
            "proposal's lnprob and freeze that source's chain)")
    with np.errstate(divide="ignore"):
        iunc = np.where(np.isfinite(unc), 1.0 / unc, 0.0)
    if uplim_bands is not None:
        m = np.broadcast_to(np.asarray(uplim_bands, bool), iunc.shape)
        iunc = np.where(m, -iunc, iunc)
    return iunc


def build_lnprob_data(shape: MBBShape, spec: LikelihoodSpec,
                      response_pack=None, correlated=False, device=None):
    """The batch tier's lnprob: the photometry arrives as ARGUMENTS, with a
    leading source axis, so one function serves a whole catalog.

    Returns (lnprob_fn, free_space) with
        lnprob_fn(theta_free (S, n, nfree), wave (nb,), flux (S, nb),
                  iunc (S, nb)) -> (S, n)
    where iunc is the SIGNED 1/sigma of signed_iunc (negative: that band's
    flux is a one-sided upper limit for that source; 0: a missing band).
    With correlated=True the 4th argument is instead a per-source
    (S, nb, nb) whitening matrix W, r = W delta (correlated band errors;
    rows and columns of missing bands zero). Box, priors and fixed
    parameters are the shared `spec`, as in build_lnprob, and the operation
    order is build_lnprob's. One-sided upper limits do not compose with
    correlated errors: spec.uplim_bands must then be unset.

    This is the plain version the multi-source kernel
    (ops/multifit_kernel.py) is held against. `device` None is the card,
    as in build_lnprob."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    if correlated and spec.uplim_bands is not None and np.any(
            np.asarray(spec.uplim_bands)):
        raise ValueError(
            "photometric upper limits (one-sided likelihood) do not "
            "compose with correlated band errors; unset one of them")
    sa = spec_arrays(spec)
    free_space = sa.free_space

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    free_idx = torch.as_tensor(free_space.free_idx, device=device)
    template, lo_free, hi_free, lo_full, hi_full, prior_mean, prior_isig = (
        dev(a) for a in sa[1:])
    if response_pack is not None:
        resp_waves, resp_weights = (dev(a) for a in response_pack)

    def lnprob(theta_free, wave, flux, iunc):
        nsrc, n = theta_free.shape[:2]
        theta = template.expand(nsrc, n, NPARAMS).clone()
        theta[..., free_idx] = theta_free
        inbox = torch.all((theta_free >= lo_free) & (theta_free <= hi_free),
                          dim=-1)
        theta_safe = torch.minimum(torch.maximum(theta, lo_full), hi_full)
        if response_pack is None:
            model = torch.exp(log_mbb_fnu(theta_safe, wave, shape))
        else:
            vals = torch.exp(log_mbb_fnu(theta_safe, resp_waves, shape))
            model = torch.sum(resp_weights * vals, dim=-1)
        delta = model - flux[:, None, :]
        if correlated:
            r = torch.sum(iunc[:, None, :, :] * delta[:, :, None, :],
                          dim=-1)
        else:
            u = iunc[:, None, :]
            delta = torch.where(u < 0, torch.clamp(delta, min=0.0), delta)
            r = delta * torch.abs(u)
        lnl = -0.5 * torch.sum(r * r, dim=-1)
        dp = (theta - prior_mean) * prior_isig
        lnpri = -0.5 * torch.sum(dp * dp, dim=-1)
        return torch.where(inbox, lnl + lnpri,
                           torch.full_like(lnl, LNPROB_FLOOR))

    return lnprob, free_space
