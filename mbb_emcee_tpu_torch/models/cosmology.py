"""Luminosity distance for derived-quantity posteriors.

The reference uses astropy.cosmology (WMAP9 default, selectable set, or an
explicit lumdist override -- ref: mbb_emcee/mbb_results.py, SURVEY.md C6).
Numpy twin of mbb_emcee_tpu/models/cosmology.py without astropy: flat/open
LambdaCDM comoving-distance quadrature, D_C = (c/H0) int_0^z dz'/E(z'),
E(z) = sqrt(Om (1+z)^3 + Ok (1+z)^2 + Ol), evaluated by fixed-node
Gauss-Legendre, host-side numpy fp64. Every distance takes one path,
`Cosmology._comoving`: each integral is rescaled to [0, 1], so one
128-node rule serves any number of redshifts in one vectorised pass. A
catalog's derived posteriors need one distance per source, twice (L_IR and
dust mass); a chain with a sampled redshift needs one per sample; a single
fit's scalar methods are that pass on one redshift. Radiation density is
neglected (fractional effect < 1e-4 at the redshifts of far-IR SED
fitting).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mbb_emcee_tpu_torch.constants import C_KM_S
from mbb_emcee_tpu_torch.ops.quadrature import gauss_legendre

# Named parameter sets (H0 [km/s/Mpc], Om0), all flat.
# Values mirror the astropy realizations the reference exposes.
PARAMETER_SETS = {
    "WMAP5": (70.2, 0.277),
    "WMAP7": (70.4, 0.272),
    "WMAP9": (69.32, 0.2865),
    "Planck13": (67.77, 0.30712),
    "Planck15": (67.74, 0.3089),
    "Planck18": (67.66, 0.30966),
}

DEFAULT_COSMOLOGY = "WMAP9"
_GL_NODES = 128


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat (or open) LambdaCDM. Ok0 = 1 - Om0 - Ol0."""
    H0: float = PARAMETER_SETS[DEFAULT_COSMOLOGY][0]
    Om0: float = PARAMETER_SETS[DEFAULT_COSMOLOGY][1]
    Ol0: float | None = None  # default: flat

    @classmethod
    def named(cls, name: str) -> "Cosmology":
        try:
            H0, Om0 = PARAMETER_SETS[name]
        except KeyError:
            raise ValueError(
                f"unknown cosmology {name!r}; known: "
                f"{sorted(PARAMETER_SETS)}") from None
        return cls(H0=H0, Om0=Om0)

    @property
    def _Ol(self):
        return (1.0 - self.Om0) if self.Ol0 is None else self.Ol0

    @property
    def _Ok(self):
        return 1.0 - self.Om0 - self._Ol

    def efunc(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return np.sqrt(self.Om0 * zp1 ** 3 + self._Ok * zp1 ** 2 + self._Ol)

    def _comoving(self, z):
        """D_C in Mpc of every redshift of the fp64 vector z, z <= 0 giving
        0.0. Per element the integral is rescaled to [0, 1]:
        D_C(z) = (c/H0) * z * int_0^1 du / E(z u), so one rule and one
        (N, nodes) efunc evaluation cover every redshift, in chunks of
        65,536 redshifts."""
        u, wu = gauss_legendre(_GL_NODES, 0.0, 1.0)
        zpos = np.maximum(z, 0.0)
        dh = C_KM_S / self.H0
        dc = np.empty_like(zpos)
        step = 65536
        for i in range(0, zpos.size, step):
            zc = zpos[i:i + step]
            nodes = np.multiply.outer(zc, u)          # (chunk, nodes)
            dc[i:i + step] = dh * zc * np.sum(wu / self.efunc(nodes),
                                              axis=-1)
        return dc

    def _luminosity(self, z):
        """D_L in Mpc of every redshift of the fp64 vector z (z <= 0: 0.0),
        handling open/closed curvature."""
        zpos = np.maximum(z, 0.0)
        dc = self._comoving(zpos)
        ok = self._Ok
        if abs(ok) > 1e-8:
            dh = C_KM_S / self.H0
            sqrt_ok = np.sqrt(abs(ok))
            x = sqrt_ok * dc / dh
            dm = dh / sqrt_ok * (np.sinh(x) if ok > 0 else np.sin(x))
        else:
            dm = dc
        return (1.0 + zpos) * dm

    def comoving_distance(self, z):
        """D_C in Mpc (fp64 host computation)."""
        return float(self._comoving(np.array([float(z)]))[0])

    def luminosity_distance(self, z):
        """D_L in Mpc, handling open/closed curvature."""
        return float(self._luminosity(np.array([float(z)]))[0])


def _resolve(cosmo):
    """A Cosmology from a Cosmology, a named set, or None (the default)."""
    if cosmo is None:
        return Cosmology()
    if isinstance(cosmo, str):
        return Cosmology.named(cosmo)
    return cosmo


def luminosity_distance_batch(z, cosmo: "Cosmology | str | None" = None):
    """D_L in Mpc for a VECTOR of redshifts, fp64 host, one vectorized
    numpy pass under one Gauss-Legendre rule (no per-element Python loop):
    a catalog's sources, or every chain sample of a fit with a sampled
    redshift (SEDResults.compute_lir with z_param). z <= 0 rows return
    0.0."""
    return _resolve(cosmo)._luminosity(
        np.atleast_1d(np.asarray(z, np.float64)))


def luminosity_distance(z, cosmo: "Cosmology | str | float | None" = None):
    """D_L in Mpc. `cosmo` may be a Cosmology, a named set, an explicit
    D_L in Mpc (float -- mirrors the reference's lumdist override), or None
    for the default (WMAP9, as in the reference)."""
    if isinstance(cosmo, (int, float)):
        return float(cosmo)
    return _resolve(cosmo).luminosity_distance(z)
