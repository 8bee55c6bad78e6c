"""Built-in instrument response library: named far-IR/submm bands.

Copy of mbb_emcee_tpu/instruments.py (numpy only): BandSpec,
BUILTIN_BANDS, the name aliases, resolve_band_name and builtin_band_curve.
Each band is a parameterized approximation of the instrument's relative
spectral response, a flat-topped super-Gaussian

    T(lambda) = exp(-ln2 * ((lambda - center) / (width/2))^(2 m))

whose half-power points sit at center +- width/2, sampled on Gauss-Legendre
nodes over the support where T > ~1e-4 and compiled to quadrature weights by
response.Response like a file-loaded curve. The band table, the detector
conventions (bolometers, or photon counting for IRAS/MIPS) and the quoting
anchors are the reference's; see that module for the handbook values behind
each entry. Swap in a measured table with Response.from_spec(name, path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mbb_emcee_tpu_torch.ops.quadrature import gauss_legendre


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """Parameterized band: flat-top super-Gaussian transmission."""
    center: float          # um, band center (midpoint of half-power edges)
    width: float           # um, full width at half maximum
    sharpness: int = 4     # super-Gaussian order m (edge steepness)
    photon_counter: bool = False   # detector convention (False = bolometer)
    refspec_index: float = -1.0    # quoting convention nu^s (s=-1: nuS=const)
    nominal: float | None = None   # um, explicit quoting anchor, or None
    # (None -> Response anchors the reference spectrum at lambda_eff --
    #  the zero-first-moment choice the Herschel bands use; IRAS/MIPS set
    #  their instrument-specific quoting wavelengths here.)
    note: str = ""

    def transmission(self, wave):
        """T(lambda) on an array of wavelengths (um)."""
        wave = np.asarray(wave, dtype=np.float64)
        u = (wave - self.center) / (0.5 * self.width)
        return np.exp(-np.log(2.0) * u ** (2 * self.sharpness))

    @property
    def support(self):
        """(lo, hi) where T drops to ~1e-4 (exponent ~ -9.2)."""
        half = 0.5 * self.width * (9.2 / np.log(2.0)) ** (
            1.0 / (2 * self.sharpness))
        return max(self.center - half, 1e-3), self.center + half


def _herschel(nominal, lo, hi, note):
    """Herschel band: curve centered between the documented half-power
    edges.

    The reference spectrum is anchored at the band's measure-weighted
    EFFECTIVE wavelength (nominal=None -> Response uses lambda_eff),
    not the nominal label: that makes the first log-moment of the
    color-correction measure vanish identically (K(-1) = K(0) = 1 for
    the nu*S=const convention), so corrections for power laws are
    second-order in bandwidth -- the handbook behavior (SPIRE Handbook
    sec 5.2.7: point-source corrections stay at the few-percent level
    over alpha in [-4, +4]). Anchoring at the nominal label instead
    leaves a first-order term of several percent per unit alpha --
    measured 12-22% at alpha=3 for these bands -- which no published
    table shows. The zero-first-moment anchor also makes band fluxes
    insensitive to the unknown true RSRF edge shape at the <= few
    percent level (tests/test_instruments_colorcorr.py sweeps tophat
    through m=2..8 super-Gaussian edges over power laws alpha in
    [-4, 3] and greybodies T in [15, 60] K: worst shift 1.6% for SPIRE
    250/350, 2-4% for SPIRE 500 / PACS 100/160, 5.5% for PACS 70 --
    at or below the ~5% photometric calibration floor)."""
    # `nominal` is the instrument's LABEL wavelength only -- deliberately
    # NOT stored as the quoting anchor (BandSpec.nominal stays None so
    # Response anchors at lambda_eff); kept in the note for readers.
    return BandSpec(center=0.5 * (lo + hi), width=hi - lo, sharpness=4,
                    nominal=None, note=f"{note} (label {nominal:g}um)")


def _photoconductor(nominal, lo, hi, refspec_index, note):
    """Photon-counting band (IRAS/MIPS photoconductors) with the
    instrument's own reference-spectrum quoting convention."""
    return BandSpec(center=0.5 * (lo + hi), width=hi - lo, sharpness=3,
                    photon_counter=True, refspec_index=refspec_index,
                    nominal=nominal, note=note)


BUILTIN_BANDS: dict[str, BandSpec] = {
    # Herschel PACS photometer (bolometers; 60-85 / 85-130 / 130-210 um).
    "PACS_70": _herschel(70.0, 60.0, 85.0, "Herschel PACS blue (approx)"),
    "PACS_100": _herschel(100.0, 85.0, 130.0, "Herschel PACS green (approx)"),
    "PACS_160": _herschel(160.0, 130.0, 210.0, "Herschel PACS red (approx)"),
    # Herschel SPIRE photometer (lambda/dlambda ~ 3.3, 3.3, 2.5).
    "SPIRE_250": _herschel(250.0, 212.0, 288.0, "Herschel SPIRE PSW (approx)"),
    "SPIRE_350": _herschel(350.0, 297.0, 403.0, "Herschel SPIRE PMW (approx)"),
    "SPIRE_500": _herschel(500.0, 400.0, 600.0, "Herschel SPIRE PLW (approx)"),
    # Ground-based submm/mm continuum cameras (all bolometers).
    "SCUBA2_450": BandSpec(450.0, 32.0, 4, note="JCMT SCUBA-2 450um (approx)"),
    "SCUBA2_850": BandSpec(850.0, 85.0, 4, note="JCMT SCUBA-2 850um (approx)"),
    "LABOCA_870": BandSpec(870.0, 150.0, 3, note="APEX LABOCA 870um (approx)"),
    "AZTEC_1100": BandSpec(1100.0, 200.0, 3, note="AzTEC 1.1mm (approx)"),
    "MAMBO_1200": BandSpec(1200.0, 290.0, 3, note="IRAM MAMBO 1.2mm (approx)"),
    # IRAS survey bands: broad, boxy photoconductor bands; the Explanatory
    # Supplement quotes fluxes against nu*S_nu = const at 12/25/60/100 um
    # (color-correct for other spectra -- that is what refspec does here).
    "IRAS_12": _photoconductor(12.0, 8.5, 15.0, -1.0, "IRAS 12um (approx)"),
    "IRAS_25": _photoconductor(25.0, 19.0, 30.0, -1.0, "IRAS 25um (approx)"),
    "IRAS_60": _photoconductor(60.0, 40.0, 80.0, -1.0, "IRAS 60um (approx)"),
    "IRAS_100": _photoconductor(100.0, 83.0, 120.0, -1.0,
                                "IRAS 100um (approx)"),
    # Spitzer MIPS: Si:As BIB (24um) / Ge:Ga (70, 160um) photoconductors.
    # The MIPS handbook quotes fluxes against a 10^4 K blackbody at the
    # band weighted-mean wavelengths; over 21-174 um that blackbody is
    # deep in its Rayleigh-Jeans tail, so S_ref propto nu^2 (s = +2) is
    # the faithful power-law stand-in.
    "MIPS_24": _photoconductor(23.68, 20.8, 26.1, 2.0,
                               "Spitzer MIPS 24um (approx)"),
    "MIPS_70": _photoconductor(71.42, 61.0, 80.0, 2.0,
                               "Spitzer MIPS 70um (approx)"),
    "MIPS_160": _photoconductor(155.9, 140.0, 174.0, 2.0,
                                "Spitzer MIPS 160um (approx)"),
    # IRAM 30m NIKA2 (kinetic inductance detectors, energy-integrating):
    # 260 +- 25 GHz and 150 +- 20 GHz continuum bands.
    "NIKA2_1150": BandSpec(1165.0, 250.0, 3, note="NIKA2 1.15mm (approx)"),
    "NIKA2_2000": BandSpec(2030.0, 540.0, 3, note="NIKA2 2mm (approx)"),
    # ALMA receiver bands as FULL-BAND tophats (sharp frequency edges ->
    # high sharpness). Real continuum observations tune ~7.5 GHz inside
    # the band; these names are for quick looks -- use box:/delta: specs
    # for a specific tuning.
    "ALMA_B3": BandSpec(3077.0, 985.0, 6, note="ALMA band 3 84-116 GHz "
                        "full-band tophat (use box:/delta: for a tuning)"),
    "ALMA_B6": BandSpec(1256.0, 331.0, 6, note="ALMA band 6 211-275 GHz "
                        "full-band tophat (use box:/delta: for a tuning)"),
    "ALMA_B7": BandSpec(947.0, 286.0, 6, note="ALMA band 7 275-373 GHz "
                        "full-band tophat (use box:/delta: for a tuning)"),
}

# Name normalization: case-insensitive, '-'/'.' -> '_', and common
# suffix/alias forms ("SPIRE_250um", "PSW", "PACS_BLUE", ...).
_ALIASES = {
    "PSW": "SPIRE_250", "PMW": "SPIRE_350", "PLW": "SPIRE_500",
    "PACS_BLUE": "PACS_70", "PACS_GREEN": "PACS_100", "PACS_RED": "PACS_160",
    "ALMA_BAND3": "ALMA_B3", "ALMA_BAND6": "ALMA_B6",
    "ALMA_BAND7": "ALMA_B7",
    "IRAS12": "IRAS_12", "IRAS25": "IRAS_25", "IRAS60": "IRAS_60",
    "IRAS100": "IRAS_100",
    "MIPS24": "MIPS_24", "MIPS70": "MIPS_70", "MIPS160": "MIPS_160",
    # MIPS names carry the conventional 24/70/160 labels; quoting happens
    # at the handbook weighted-mean wavelengths (nominal in the BandSpec).
}


def resolve_band_name(name):
    """Canonical registry key for a band name, or None if unknown.

    Aliases and the um/micron suffix strip COMPOSE ('mips24um' ->
    MIPS24 -> MIPS_24), so every registered short form also accepts the
    suffixed spellings the canonical names do."""
    key = str(name).strip().upper().replace("-", "_").replace(".", "_")
    candidates = [key]
    for suffix in ("UM", "_UM", "MICRON", "_MICRON"):
        if key.endswith(suffix):
            candidates.append(key[: -len(suffix)])
    for cand in candidates:
        cand = _ALIASES.get(cand, cand)
        if cand in BUILTIN_BANDS:
            return cand
    return None


def builtin_band_curve(name, nnodes=65):
    """(wave, trans, quad_weights, band) for a named built-in band.

    Gauss-Legendre nodes over the band support; feed straight into
    ``Response(name, wave, trans, quad_weights=...)``.
    """
    key = resolve_band_name(name)
    if key is None:
        known = ", ".join(sorted(BUILTIN_BANDS))
        raise KeyError(f"unknown built-in band {name!r}; known: {known}")
    band = BUILTIN_BANDS[key]
    lo, hi = band.support
    nodes, wts = gauss_legendre(int(nnodes), lo, hi)
    return nodes, band.transmission(nodes), wts, band
