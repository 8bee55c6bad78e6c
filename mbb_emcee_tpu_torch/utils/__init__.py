"""Small host-side helpers (FITS image and covariance reader, logging,
profiling)."""

from mbb_emcee_tpu_torch.utils.fits import read_fits_image

__all__ = ["read_fits_image"]
