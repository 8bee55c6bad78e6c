"""Plain-numpy converters from the JAX package's objects to this package's.

They read attributes duck-typed with np.asarray and import nothing of the
JAX package, so code holding both packages' objects (the cross-package
tests) can hand one package's state to the other. The HDF5 schema
(hdf5io.py) is the other carrier between them.
"""

from __future__ import annotations

import numpy as np
import torch

from mbb_emcee_tpu_torch.likelihood import LikelihoodSpec, Photometry
from mbb_emcee_tpu_torch.sampler import SamplerState


def photometry_from_arrays(wave, flux, unc, cov=None, band_names=None):
    """Photometry from array-likes (e.g. the fields of the JAX package's
    Photometry)."""
    return Photometry(np.asarray(wave, np.float64),
                      np.asarray(flux, np.float64),
                      np.asarray(unc, np.float64),
                      cov=None if cov is None else np.asarray(cov,
                                                              np.float64),
                      band_names=None if band_names is None
                      else list(band_names))


def spec_from_reference(spec):
    """LikelihoodSpec from any object with the JAX package's LikelihoodSpec
    attributes (.lower/.upper/.fixed/.fixed_values/.prior_mean/
    .prior_isigma/.uplim_bands)."""
    ub = getattr(spec, "uplim_bands", None)
    return LikelihoodSpec(
        lower=np.asarray(spec.lower, np.float64).copy(),
        upper=np.asarray(spec.upper, np.float64).copy(),
        fixed=np.asarray(spec.fixed, bool).copy(),
        fixed_values=np.asarray(spec.fixed_values, np.float64).copy(),
        prior_mean=np.asarray(spec.prior_mean, np.float64).copy(),
        prior_isigma=np.asarray(spec.prior_isigma, np.float64).copy(),
        uplim_bands=None if ub is None else np.asarray(ub, bool).copy())


def state_from_arrays(pos_a, pos_b, lnp_a, lnp_b, naccept, nsteps, seed,
                      device=None):
    """SamplerState from array-likes (e.g. the fields of the JAX package's
    SamplerState); `seed` becomes the 64-bit Philox key of the state.
    `device` None is the card (fitter.resolve_device: without one this
    raises, naming device="cpu")."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return SamplerState(
        pos_a=f32(pos_a), pos_b=f32(pos_b), lnp_a=f32(lnp_a),
        lnp_b=f32(lnp_b),
        naccept=torch.as_tensor(np.array(naccept, np.int32),
                                device=device),
        nsteps=int(np.asarray(nsteps)), seed=int(seed) & (2 ** 64 - 1))
