"""Filter-response quadrature of the reference, built from a
configuration's numbers alone (its "responses" object), in float64.

A band's quoted flux density is the colour-corrected integral over its
filter curve (the published definition for bolometer and photon-counting
photometry):

    F = int R(nu) S(nu) k(nu) dnu / int R(nu) S_ref(nu) k(nu) dnu,

with S_ref = (nu / nu_ref)^s = (lambda_ref / lambda)^s, unit at the
quoting wavelength lambda_ref, and k = 1 for a bolometer or
k propto lambda for a photon counter. In wavelength, dnu = c / lambda^2
dlambda, and c cancels. On n Gauss-Legendre nodes lambda_i (weights w_i)
over the curve's support this is F = sum_i W_i S(lambda_i) with

    W_i = w_i T_i k_i / lambda_i^2 / sum_j w_j T_j k_j / lambda_j^2
          (lambda_ref / lambda_j)^s.

The quoting wavelength is a number of micron, or "effective":
lambda_eff = int (R k / lambda) dlambda / int (R k / lambda^2) dlambda.

Each curve is a flat-topped super-Gaussian of order m between its
half-power edges lo and hi:
T(lambda) = exp(-ln 2 ((lambda - c) / h)^(2m)), c = (lo + hi) / 2,
h = (hi - lo) / 2. Its support, where the nodes lie, ends where the
exponent ln 2 ((lambda - c) / h)^(2m) reaches the configuration's
"cutoff_exponent" (9.2: T ~ 1e-4).
"""

from __future__ import annotations

import math

import numpy as np
import torch

DETECTORS = ("bolometer", "photon_counter")


def _nodes(n):
    """Gauss-Legendre nodes and weights on [-1, 1], fp64."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    return (torch.as_tensor(x, dtype=torch.float64),
            torch.as_tensor(w, dtype=torch.float64))


def band_quadrature(band, nnodes, cutoff_exponent):
    """(lambda (n,), W (n,), lambda_eff) of one band of a "responses"
    object, fp64 torch tensors and a float."""
    lo, hi = (float(v) for v in band["edges"])
    m = int(band["order"])
    detector = band["detector"]
    if detector not in DETECTORS:
        raise ValueError(f"unknown detector {detector!r}; known: {DETECTORS}")
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
    reach = h * (float(cutoff_exponent) / math.log(2.0)) ** (1.0 / (2 * m))
    a, b = c - reach, c + reach
    if a <= 0.0:
        raise ValueError(f"band {band} reaches below 0 um")
    x, w = _nodes(nnodes)
    lam = 0.5 * (b + a) + 0.5 * (b - a) * x
    wq = 0.5 * (b - a) * w
    trans = torch.exp(-math.log(2.0) * ((lam - c) / h) ** (2 * m))
    k = lam if detector == "photon_counter" else torch.ones_like(lam)
    base = wq * trans * k / lam ** 2
    lam_eff = float(torch.sum(base * lam) / torch.sum(base))
    anchor = band["anchor"]
    lam_ref = lam_eff if anchor == "effective" else float(anchor)
    sref = (lam_ref / lam) ** float(band["refspec_index"])
    return lam, base / torch.sum(base * sref), lam_eff


def pack_of(cfg):
    """(waves, weights), fp64 numpy arrays (nbands, nnodes) in the order
    of the configuration's bands, or None for a configuration of point
    bands (no "responses")."""
    rs = cfg.get("responses")
    if rs is None:
        return None
    waves, weights = [], []
    for name in cfg["bands"]:
        lam, wt, _ = band_quadrature(rs["bands"][name], rs["nnodes"],
                                     rs["cutoff_exponent"])
        waves.append(lam.numpy())
        weights.append(wt.numpy())
    return np.stack(waves), np.stack(weights)
