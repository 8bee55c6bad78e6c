"""Fixed-node Gauss-Legendre quadrature.

Torch twin of mbb_emcee_tpu/ops/quadrature.py: nodes and weights are built
host-side in fp64 numpy, and an integral becomes one weighted contraction
over the last axis that batches over the whole chain.
"""

import numpy as np
import torch


def gauss_legendre(n, lo, hi):
    """GL nodes/weights on [lo, hi] as fp64 numpy arrays."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    half = 0.5 * (hi - lo)
    mid = 0.5 * (hi + lo)
    return mid + half * x, half * w


def loglam_nodes(n, lam_lo, lam_hi):
    """GL nodes/weights for int g(lam) dlam done in u = ln(lam). Returns
    (lam_nodes, dlam_weights) so that sum(w * g(lam)) approximates the
    integral over [lam_lo, lam_hi]."""
    u, wu = gauss_legendre(n, np.log(lam_lo), np.log(lam_hi))
    lam = np.exp(u)
    return lam, wu * lam


def contract(weights, values):
    """Sum over the last axis of weights*values (the quadrature
    contraction)."""
    return torch.sum(weights * values, dim=-1)
