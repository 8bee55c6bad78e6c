"""Small host-side helpers (FITS covariance reader)."""
