"""Filter response curves and band-integrated fluxes.

Torch twin of mbb_emcee_tpu/response.py. Each band is compiled ONCE at setup
into a fixed (nodes, weights) pair such that

    band_flux(S) = sum_i W_i * S(lambda_i)

approximates the color-corrected quoted monochromatic flux density; the
likelihood evaluates the SED on the padded (nbands, nnodes) wavelength
matrix of ResponseSet.pack and contracts it with the weight matrix (in the
kernels: the band sum of csrc/lnprob.cuh). All of it is host fp64 numpy, as
in the reference, so a pack is bit for bit the reference's.

Conventions (the reference's):
  * quoted flux = int R(nu) S(nu) k(nu) dnu / int R(nu) S_ref(nu) k(nu) dnu
    with reference spectrum S_ref propto nu^s (default s = -1, i.e.
    nu * S_nu = const) normalized to 1 at the quoting wavelength.
  * k(nu) = 1 for energy-integrating detectors, 1/nu (propto lambda) for
    photon counters.
  * lambda_eff = int R k lam dnu / int R k dnu
               = int (R k / lam) dlam / int (R k / lam^2) dlam.

Filters by spec string:
    "box:center_um:width_um[:nnodes]"   flat transmission top-hat
    "gauss:center_um:fwhm_um[:nnodes]"  Gaussian transmission (+-4 sigma)
    "delta:wave_um"                      monochromatic sampling
    "builtin:BAND[:nnodes]"              named band of instruments.py
Anything else: a known built-in band name resolves from the library;
otherwise it is a path to a 2-column text file (lambda_um, R), one node per
row.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mbb_emcee_tpu_torch.ops.quadrature import gauss_legendre
from mbb_emcee_tpu_torch.utils.profiling import span


def _trapz_weights(x):
    """Trapezoid-rule weights for samples at ascending x."""
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


class Response:
    """One filter band, compiled to fixed quadrature nodes and weights."""

    def __init__(self, name, wave, trans, *, quad_weights=None,
                 photon_counter=False, refspec_index=-1.0,
                 ref_wavelength=None):
        wave = np.asarray(wave, dtype=np.float64)
        trans = np.asarray(trans, dtype=np.float64)
        if wave.ndim != 1 or wave.shape != trans.shape:
            raise ValueError(f"response {name!r}: wave/trans shape mismatch")
        if wave.size > 1:
            order = np.argsort(wave)
            wave, trans = wave[order], trans[order]
            if quad_weights is not None:
                quad_weights = np.asarray(quad_weights, np.float64)[order]
        if np.any(wave <= 0.0):
            raise ValueError(f"response {name!r}: non-positive wavelength")
        if np.any(trans < 0.0):
            raise ValueError(f"response {name!r}: negative transmission")

        self.name = str(name)
        self.wave = wave
        self.trans = trans
        self.photon_counter = bool(photon_counter)
        self.refspec_index = float(refspec_index)

        if wave.size == 1:
            # Delta filter: quoted flux is S at the single wavelength.
            self.effective_wavelength = float(wave[0])
            self.ref_wavelength = float(wave[0])
            self.weights = np.array([1.0])
            return

        t = quad_weights if quad_weights is not None else _trapz_weights(wave)
        # Detector factor k: 1 (energy) or lambda (photon counting, 1/nu).
        k = wave if self.photon_counter else np.ones_like(wave)
        # d nu = c / lambda^2 d lambda; the constant c cancels in the ratio.
        base = t * trans * k / wave ** 2
        norm0 = base.sum()
        if norm0 <= 0.0:
            raise ValueError(f"response {name!r}: zero integrated response")
        self.effective_wavelength = float((base * wave).sum() / norm0)
        # Reference spectrum (nu/nu_ref)^s = (lambda_ref/lambda)^s, unit
        # at the wavelength the instrument QUOTES fluxes at: the nominal
        # band wavelength when the library declares one (Herschel quotes
        # at 70/100/.../500 um, not at lambda_eff), else lambda_eff.
        self.ref_wavelength = (float(ref_wavelength)
                               if ref_wavelength is not None
                               else self.effective_wavelength)
        sref = (self.ref_wavelength / wave) ** self.refspec_index
        denom = (base * sref).sum()
        self.weights = base / denom

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_builtin(cls, name, band=None, nnodes=65, **kw):
        """Named band from the built-in instrument library (instruments.py).

        Detector convention and reference-spectrum index default to the
        instrument's own unless overridden in **kw.
        """
        from mbb_emcee_tpu_torch.instruments import builtin_band_curve
        wave, trans, wts, spec = builtin_band_curve(
            band if band is not None else name, nnodes=nnodes)
        kw.setdefault("photon_counter", spec.photon_counter)
        kw.setdefault("refspec_index", spec.refspec_index)
        kw.setdefault("ref_wavelength", spec.nominal)
        return cls(name, wave, trans, quad_weights=wts, **kw)

    @classmethod
    def from_spec(cls, name, spec, dir=None, **kw):
        """Build from a spec string (box:/gauss:/delta:/builtin:), a known
        built-in band name, or a file path."""
        parts = str(spec).split(":")
        kind = parts[0].lower()
        if kind == "builtin":
            nnodes = int(parts[2]) if len(parts) > 2 else 65
            return cls.from_builtin(name, band=parts[1], nnodes=nnodes, **kw)
        if kind == "delta":
            (w0,) = map(float, parts[1:2])
            return cls(name, [w0], [1.0], **kw)
        if kind == "box":
            c, w = float(parts[1]), float(parts[2])
            n = int(parts[3]) if len(parts) > 3 else 33
            lo, hi = c - 0.5 * w, c + 0.5 * w
            if lo <= 0:
                raise ValueError(f"box filter {name!r} extends below 0 um")
            nodes, wts = gauss_legendre(n, lo, hi)
            return cls(name, nodes, np.ones(n), quad_weights=wts, **kw)
        if kind == "gauss":
            c, fwhm = float(parts[1]), float(parts[2])
            n = int(parts[3]) if len(parts) > 3 else 65
            sig = fwhm / 2.3548200450309493
            lo, hi = max(c - 4 * sig, 1e-3), c + 4 * sig
            nodes, wts = gauss_legendre(n, lo, hi)
            trans = np.exp(-0.5 * ((nodes - c) / sig) ** 2)
            return cls(name, nodes, trans, quad_weights=wts, **kw)
        # Bare built-in band name (e.g. "SPIRE_250", "pacs-100um").
        from mbb_emcee_tpu_torch.instruments import resolve_band_name
        if resolve_band_name(spec) is not None:
            return cls.from_builtin(name, band=spec, **kw)
        # File path.
        path = spec if dir is None else os.path.join(dir, spec)
        data = np.loadtxt(path)
        if data.ndim != 2 or data.shape[1] < 2:
            raise ValueError(f"filter file {path!r}: need 2 columns")
        return cls(name, data[:, 0], data[:, 1], **kw)

    # -- evaluation -----------------------------------------------------------
    def __call__(self, sed):
        """Band flux of a callable SED, which takes the nodes as an fp32
        CPU tensor (host-side convenience; the hot path uses
        ResponseSet.pack + the likelihood contraction instead)."""
        vals = sed(torch.as_tensor(self.wave, dtype=torch.float32))
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().double().numpy()
        vals = np.asarray(vals, dtype=np.float64)
        return float((self.weights * vals).sum())

    def __repr__(self):
        return (f"Response({self.name!r}, {self.wave.size} nodes, "
                f"lambda_eff={self.effective_wavelength:.2f}um)")


class ResponseSet:
    """Ordered name -> Response mapping (ref: mbb_emcee response_set)."""

    def __init__(self):
        self._responses: dict[str, Response] = {}

    def add(self, name, spec_or_response, dir=None, **kw):
        if isinstance(spec_or_response, Response):
            self._responses[name] = spec_or_response
        else:
            self._responses[name] = Response.from_spec(
                name, spec_or_response, dir=dir, **kw)
        return self._responses[name]

    @classmethod
    def builtin(cls, names, nnodes=65, **kw):
        """ResponseSet resolving each name from the built-in instrument
        library (e.g. ResponseSet.builtin(["PACS_100", "SPIRE_250"]))."""
        rs = cls()
        for name in names:
            rs._responses[name] = Response.from_builtin(
                name, nnodes=nnodes, **kw)
        return rs

    @classmethod
    def from_file(cls, listfile, dir=None, **kw):
        """Load 'name spec' lines (# comments allowed)."""
        rs = cls()
        base = dir if dir is not None else os.path.dirname(listfile)
        with open(listfile) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                name, spec = line.split(None, 1)
                rs.add(name, spec.strip(), dir=base, **kw)
        return rs

    def __getitem__(self, name) -> Response:
        return self._responses[name]

    def __contains__(self, name):
        return name in self._responses

    def __len__(self):
        return len(self._responses)

    def keys(self):
        return self._responses.keys()

    def pack(self, names):
        """Pad the named bands to a common node count.

        Returns (waves, weights) HOST float32 arrays of shape (nbands, nmax);
        padded entries carry weight 0 and a harmless wavelength so the SED
        eval stays finite. This is the representation the likelihood and
        the kernels contract against. Every fitter's _response_pack builds
        its pack here, under the span mbb.fit.response_pack (its bands and
        padded nodes) while the profiler records.
        """
        rs = [self[n] for n in names]
        nmax = max(r.wave.size for r in rs)
        with span("mbb.fit.response_pack", bands=len(rs), nodes=nmax):
            waves = np.full((len(rs), nmax), 500.0, dtype=np.float64)
            wts = np.zeros((len(rs), nmax), dtype=np.float64)
            for i, r in enumerate(rs):
                waves[i, :r.wave.size] = r.wave
                wts[i, :r.wave.size] = r.weights
            return waves.astype(np.float32), wts.astype(np.float32)
