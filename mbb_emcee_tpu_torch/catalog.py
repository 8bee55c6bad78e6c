"""Survey-catalog ingest for batched fits (a copy of the numpy-only
mbb_emcee_tpu/catalog.py, so the port imports nothing of the JAX package).

The reference fits one photometry file per process (SURVEY.md §3.1); a
survey pipeline fits a CATALOG -- many sources sharing one band setup --
which is the batch axis MultiFitter fits in one run
(multifit.py). This module reads that catalog from a plain text file:

    # comments and blank lines are ignored
    wave  = 100 160 250 350 500          # shared band wavelengths, um
    bands = PACS_100 PACS_160 SPIRE_250 SPIRE_350 SPIRE_500   # optional
    uplims = 0 0 0 0 1                   # optional: 1 = upper-limit band
    SMM_J0001   2.20   11.2 0.8  32.1 1.9  44.8 2.4  38.2 2.1  22.9 1.5
    SMM_J0002   1.85    9.4 0.7  28.8 1.7  40.1 2.2  35.5 2.0  21.3 1.4
    ...

One source per row: identifier, redshift (``nan`` if unknown), then
(flux, unc) mJy pairs in the ``wave`` order. A ``nan nan`` pair marks a
MISSING band for that source (ragged surveys: not every source is
observed in every band) -- it carries zero likelihood weight. A flux
written ``<value`` (e.g. ``<4.5 1.5``) marks that single (source, band)
measurement as a photometric UPPER LIMIT: the limit is ``value``, the
second number stays the 1-sigma scale of the one-sided penalty
(likelihood.py), and only that source's band goes one-sided. The
optional ``bands`` row names each column for instrument-response mode
(the names resolve against a filter list file or the built-in
instrument library, response.py). The optional ``uplims`` row flags
bands whose flux column is an upper limit for EVERY source; per-source
``<`` flags and the shared row combine by OR (Catalog.uplim_mask). The
'=' after the header keywords is optional.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Catalog:
    """Parsed catalog: S sources x nb shared bands."""
    names: list                 # (S,) source identifiers
    redshifts: np.ndarray       # (S,) float; NaN where unknown
    wave: np.ndarray            # (nb,) um
    flux: np.ndarray            # (S, nb) mJy
    unc: np.ndarray             # (S, nb) mJy
    band_names: list | None = None
    uplim_bands: np.ndarray | None = None  # (nb,) bool, 'uplims' header row
    uplim_src: np.ndarray | None = None    # (S, nb) bool, '<flux' tokens

    @property
    def nsources(self):
        return self.flux.shape[0]

    @property
    def has_redshifts(self):
        return bool(np.all(np.isfinite(self.redshifts)))

    def uplim_mask(self):
        """Effective photometric-upper-limit mask for
        MultiFitter.set_phot_upperlimits: None (no limits anywhere),
        shared (nb,) (only the 'uplims' header row), or per-source
        (S, nb) (any '<flux' token; OR-combined with the shared row)."""
        if self.uplim_src is None:
            return self.uplim_bands
        if self.uplim_bands is None:
            return self.uplim_src
        return self.uplim_src | self.uplim_bands


def _header_values(parts):
    """Tokens after a header keyword, tolerating 'wave = 1 2' / 'wave: 1 2'."""
    vals = parts[1:]
    if vals and vals[0] in ("=", ":"):
        vals = vals[1:]
    return vals


def read_catalog(path):
    """Parse a catalog file (module docstring format) into a Catalog."""
    wave = None
    band_names = None
    uplim_bands = None
    names, redshifts, rows, limrows = [], [], [], []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.replace("=", " = ").split()
            key = parts[0].lower()
            # 'wave: 1 2' (no space before the colon) tokenizes the key
            # as 'wave:', which used to fall into the source-row branch
            # with a misleading missing-header error. Detach a TRAILING
            # colon from a header keyword only -- a global ':' pad would
            # corrupt source names like 'SDSS:J1234'.
            if key.endswith(":") and key[:-1] in ("wave", "bands",
                                                  "uplims"):
                parts = [parts[0][:-1], ":"] + parts[1:]
                key = key[:-1]
            # Header keywords are only recognized BEFORE the first source
            # row (so a source that happens to be named 'wave'/'bands'/
            # 'uplims' after data starts is parsed as data, not silently
            # swallowed), and each may appear once (a stray second 'wave'
            # row must not silently rebind the band grid mid-file).
            if not rows and key in ("wave", "bands", "uplims"):
                if (wave, band_names, uplim_bands)[
                        ("wave", "bands", "uplims").index(key)] is not None:
                    raise ValueError(
                        f"{path}:{lineno}: duplicate '{key}' header row")
                if key == "wave":
                    wave = np.array(
                        [float(v) for v in _header_values(parts)])
                elif key == "bands":
                    band_names = list(_header_values(parts))
                else:
                    uplim_bands = np.array(
                        [bool(int(v)) for v in _header_values(parts)])
                continue
            if wave is None:
                raise ValueError(
                    f"{path}:{lineno}: the 'wave = ...' header row must "
                    "precede the first source row")
            expect = 2 + 2 * wave.size
            if len(parts) != expect:
                raise ValueError(
                    f"{path}:{lineno}: expected {expect} columns "
                    f"(name z + {wave.size} flux/unc pairs), got "
                    f"{len(parts)}")
            names.append(parts[0])
            redshifts.append(float(parts[1]))
            vals, flags = [], []
            for j, tok in enumerate(parts[2:]):
                is_flux = (j % 2 == 0)
                lim = is_flux and tok.startswith("<")
                if lim:
                    tok = tok[1:]
                try:
                    v = float(tok)
                except ValueError:
                    raise ValueError(
                        f"{path}:{lineno}: bad number {tok!r}") from None
                if lim and not np.isfinite(v):
                    raise ValueError(
                        f"{path}:{lineno}: '<' upper-limit flux must be "
                        f"a finite value, got {tok!r}")
                vals.append(v)
                if is_flux:
                    flags.append(lim)
            rows.append(vals)
            limrows.append(flags)
    if wave is None or not rows:
        raise ValueError(f"{path}: no 'wave' header or no source rows")
    if band_names is not None and len(band_names) != wave.size:
        raise ValueError(
            f"{path}: {len(band_names)} band names for {wave.size} bands")
    if uplim_bands is not None and uplim_bands.size != wave.size:
        raise ValueError(
            f"{path}: {uplim_bands.size} uplim flags for {wave.size} bands")
    data = np.asarray(rows, np.float64).reshape(len(rows), wave.size, 2)
    flux, unc = data[:, :, 0], data[:, :, 1]
    # 'nan nan' (or 'nan <anything>') pairs mark MISSING bands -- ragged
    # catalogs where not every source is detected in every band;
    # MultiFitter.set_data carries them as zero-weight slots.
    present = np.isfinite(flux) & np.isfinite(unc)
    if np.any((unc <= 0) & present):
        bad = names[int(np.argwhere(
            np.any((unc <= 0) & present, axis=1))[0, 0])]
        raise ValueError(f"{path}: non-positive uncertainty (source {bad})")
    uplim_src = np.asarray(limrows, bool)
    if not uplim_src.any():
        uplim_src = None
    elif np.any(uplim_src & ~present):
        bad = names[int(np.argwhere(
            np.any(uplim_src & ~present, axis=1))[0, 0])]
        raise ValueError(
            f"{path}: '<' upper-limit flag on a MISSING band (source "
            f"{bad}): an upper limit needs a finite 1-sigma scale in "
            f"the uncertainty column")
    return Catalog(names=names,
                   redshifts=np.asarray(redshifts, np.float64),
                   wave=wave, flux=flux, unc=unc, band_names=band_names,
                   uplim_bands=uplim_bands, uplim_src=uplim_src)
