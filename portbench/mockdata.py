"""Mock photometry of a configuration, drawn from the run's seed.

The recipe is a frozen copy of tools/validate_tpu_parity.py:55-84 (WAVE,
TRUE, UNC_FRAC, the box, config 2's priors) and :162-190 (mock_data: the
fp64 oracle's fluxes at the true parameters, through each band's filter
curve where the configuration has responses, 5% errors, one Gaussian draw
per band), without that module's imports; the numbers themselves live in
the configuration files (configs/*.json), and a catalog's missing band
follows chip_smoke.batch_data(missing_every=...). Every request gets new
photometry from (seed, request index); the sizes never depend on the seed.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.oracle import ModifiedBlackbodyOracle
from portbench.reference.response import pack_of

SEED_MOD = 2 ** 64


def rng(seed, *stream):
    """numpy's generator for (seed, *stream): any whole seed, negative or
    beyond 64 bits, maps to one stream."""
    return np.random.default_rng([int(seed) % SEED_MOD,
                                  *(int(s) % SEED_MOD for s in stream)])


def true_flux(cfg):
    """The oracle's fp64 band fluxes at the configuration's true
    parameters: f_nu at each band's wavelength, or where the configuration
    holds filter responses, the oracle's SED contracted with the
    reference's quadrature of each curve."""
    m = cfg["model"]
    oracle = ModifiedBlackbodyOracle(*cfg["true"], wavenorm=m["wavenorm"],
                                     noalpha=m["noalpha"],
                                     opthin=m["opthin"])
    pack = pack_of(cfg)
    if pack is None:
        return oracle(np.asarray(cfg["wave"], np.float64))
    waves, weights = pack
    return np.sum(weights * oracle(waves), axis=-1)


def request_data(cfg, traffic, seed, index, flux_true=None):
    """One request's inputs: (flux (S, nb), unc (S, nb), z (S,), fit seed).
    Missing bands carry NaN in both columns. `flux_true` is true_flux(cfg),
    passed to spare its recomputation."""
    S = int(cfg["nsources"])
    g = rng(seed, index)
    f = true_flux(cfg) if flux_true is None else flux_true
    unc = np.broadcast_to(cfg["unc_frac"] * f, (S, f.size)).copy()
    flux = f + unc * g.standard_normal((S, f.size))
    every = int(cfg.get("missing_every", 0))
    if every:
        flux[1::every, cfg["missing_band"]] = np.nan
        unc[1::every, cfg["missing_band"]] = np.nan
    zlo, zhi = traffic.get("redshift", (0.0, 0.0))
    z = g.uniform(zlo, zhi, S)
    fit_seed = int(g.integers(0, 2 ** 62))
    return flux, unc, z, fit_seed
