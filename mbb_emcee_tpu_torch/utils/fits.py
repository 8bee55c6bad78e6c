"""Minimal FITS image HDU reader/writer.

The reference reads photometric covariance matrices from a FITS extension via
astropy.io.fits (ref: mbb_emcee mbb_fit covfile/covextn handling -- SURVEY.md
C3). A copy of mbb_emcee_tpu/utils/fits.py: astropy is not a dependency, and
a covariance matrix is just a 2-D image HDU, so this implements the small
slice of the FITS standard needed: 2880-byte header blocks of 80-char cards,
big-endian IEEE data, primary HDU + IMAGE extensions.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880
_CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _read_header(fh):
    """Read one header; returns (dict, ok) or (None, False) at EOF."""
    cards = {}
    raw = fh.read(_BLOCK)
    if len(raw) < _BLOCK:
        return None
    while True:
        for i in range(0, _BLOCK, _CARD):
            card = raw[i:i + _CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return cards
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/", 1)[0].strip()
            cards[key] = val
        raw = fh.read(_BLOCK)
        if len(raw) < _BLOCK:
            raise ValueError("FITS header missing END card")


def _parse_int(v):
    return int(v.strip().strip("'").strip())


def _hdu_data_size(cards):
    bitpix = _parse_int(cards["BITPIX"])
    naxis = _parse_int(cards["NAXIS"])
    if naxis == 0:
        return 0, (), bitpix
    dims = [_parse_int(cards[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
    nelem = int(np.prod(dims))
    # PCOUNT/GCOUNT for extensions.
    pcount = _parse_int(cards.get("PCOUNT", "0"))
    gcount = _parse_int(cards.get("GCOUNT", "1"))
    nbytes = (abs(bitpix) // 8) * gcount * (pcount + nelem)
    return nbytes, tuple(reversed(dims)), bitpix


def read_fits_image(path, extn=0):
    """Return the data array of image HDU number `extn` (0 = primary)."""
    with open(path, "rb") as fh:
        hdu = 0
        while True:
            cards = _read_header(fh)
            if cards is None:
                raise ValueError(f"{path}: FITS extension {extn} not found")
            nbytes, shape, bitpix = _hdu_data_size(cards)
            padded = ((nbytes + _BLOCK - 1) // _BLOCK) * _BLOCK
            if hdu == extn:
                if not shape:
                    raise ValueError(
                        f"{path}: HDU {extn} has no data (NAXIS=0)")
                raw = fh.read(nbytes)
                if len(raw) < nbytes:
                    raise ValueError(f"{path}: truncated FITS data")
                arr = np.frombuffer(raw, dtype=_BITPIX_DTYPE[bitpix])
                arr = arr.reshape(shape).astype(np.float64)
                bscale = float(cards.get("BSCALE", "1.0"))
                bzero = float(cards.get("BZERO", "0.0"))
                if bscale != 1.0 or bzero != 0.0:
                    arr = arr * bscale + bzero
                return arr
            fh.seek(padded, 1)
            hdu += 1


def write_fits_image(path, data, extra_cards=()):
    """Write a single-HDU FITS image (fp64). For tests and interchange."""
    data = np.asarray(data, dtype=np.float64)
    cards = [
        "SIMPLE  =                    T",
        "BITPIX  =                  -64",
        f"NAXIS   = {data.ndim:>20d}",
    ]
    for i, n in enumerate(reversed(data.shape), start=1):
        cards.append(f"NAXIS{i}  = {n:>20d}")
    cards.extend(extra_cards)
    cards.append("END")
    header = "".join(c.ljust(_CARD) for c in cards)
    header += " " * (-len(header) % _BLOCK)
    body = data.astype(">f8").tobytes()
    body += b"\x00" * (-len(body) % _BLOCK)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(body)


def read_band_correlation(path, extn=0):
    """Read a band CORRELATION matrix from a FITS image extension for the
    batch CLI's --corrfile flag. Accepts a covariance matrix too -- only its
    correlation structure is kept (the per-source error scales come from
    the catalog's unc columns). Raises ValueError on a non-square matrix or
    a non-positive diagonal; positive-definiteness is checked downstream by
    set_band_correlation."""
    R = np.asarray(read_fits_image(path, extn=extn), np.float64)
    if R.ndim != 2 or R.shape[0] != R.shape[1]:
        raise ValueError(
            f"correlation file must hold a square matrix; got {R.shape}")
    d = np.diag(R)
    if np.any(d <= 0):
        raise ValueError("correlation matrix has non-positive diagonal")
    if not np.allclose(d, 1.0, atol=1e-8):
        R = R / np.sqrt(np.outer(d, d))
    return R
