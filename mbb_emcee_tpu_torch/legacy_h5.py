"""Tolerant reader for UPSTREAM mbb_emcee result files.

Torch twin of mbb_emcee_tpu/legacy_h5.py: `compat` gives a migrating user
the upstream API surface, and `hdf5io` round-trips files either package
writes; this module loads result files written by the original `mbb_emcee`
(`mbb_results.writeToHDF5`, ref: SURVEY.md C7 [MED schema confidence])
into `MBBResults`. Host numpy only: no tensor, no device.

The reference mount is empty, so the upstream on-disk layout is
RECONSTRUCTED: chain (nwalkers, nsteps, 5), lnprob (nwalkers, nsteps),
photometry arrays, and z/opthin/noalpha/wavenorm settings as attrs.
Because every name is a [MED]-confidence guess, the reader is
deliberately tolerant rather than exact:

  * every dataset in the file (at any depth) is matched by NORMALIZED
    basename (lowercased, ``_`` removed) against a candidate list per
    logical field;
  * attributes are gathered from every group, nearest-to-root winning;
  * the chain accepts (nwalkers, nsteps, 5), a flattened (N, 5), or a
    transposed layout (the size-5 parameter axis is located and moved
    last), and fewer-than-5 columns are expanded through the
    opthin/noalpha free-parameter map;
  * everything inferred (and every default assumed) is reported in ONE
    UserWarning so the user can audit the import;
  * an unrecognizable file fails with the full list of what was looked
    for and what was found.

Import happens automatically: ``MBBResults(h5file=...)`` (and therefore
``compat.mbb_results(h5file=...)``) falls back to this reader when the
file lacks the packages' own schema markers. h5py is imported when a file
is read: without it, reading raises an ImportError that names it.
"""

import warnings

import numpy as np

NPARAMS = 5

# candidate basenames per logical field, normalized (lower, no "_").
# First match in file-iteration order wins; names earlier in each list
# are the higher-confidence upstream guesses.
_DATASET_CANDIDATES = {
    "chain": ("chain", "chains", "posterior", "samples"),
    "lnprob": ("lnprobability", "lnprob", "loglike", "lnlike", "logprob",
               "loglikelihood"),
    "wave": ("wave", "wavelength", "wavelengths", "lambda", "waveobs"),
    "flux": ("flux", "fluxes", "fnu", "fluxdensity"),
    "flux_unc": ("fluxunc", "sigma", "unc", "fluxerror", "dflux", "error",
                 "fluxerr", "sigmaflux"),
    "cov": ("cov", "covmatrix", "covariance", "covar", "covmat"),
    "lir": ("lir", "lirchain"),
    "dustmass": ("dustmass", "mdust", "dustmasschain"),
    "peaklambda": ("peaklambda", "lambdapeak", "peaklam",
                   "peaklambdachain"),
}

_ATTR_CANDIDATES = {
    "redshift": ("z", "redshift"),
    "opthin": ("opthin", "opticallythin"),
    "noalpha": ("noalpha",),
    "wavenorm": ("wavenorm", "lambdanorm"),
    "lumdist": ("lumdist", "dl"),
    "param_names": ("paramnames", "parameters", "fitparams"),
    "lowlim": ("lowlim", "lowerlimits", "lowlimits"),
    "uplim": ("uplim", "upperlimits", "uplimits"),
    "fixed": ("fixed",),
    # Walker-geometry attrs (round 5): emcee-style files plausibly store
    # a flattened (N, npar) chain plus an nwalkers/iterations attr; a
    # recoverable walker axis keeps R-hat/ESS/autocorrelation meaningful
    # instead of silently degrading to a single-walker import.
    "nwalkers": ("nwalkers", "walkers", "nwalker"),
    "iterations": ("iterations", "nsteps", "niter", "nsamples", "nsample"),
}


def _norm(name):
    return name.lower().replace("_", "").replace("-", "")


def _h5py(what="reading an upstream mbb_emcee HDF5 file"):
    """The h5py module, or an ImportError that names it and `what`
    needed it."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(f"{what} needs h5py, which is not "
                          "installed") from err
    return h5py


def _walk(f):
    """(path, dataset) for every dataset, (path, attrs) for every
    group/file, both in h5py iteration order (root first)."""
    h5py = _h5py()
    datasets, attr_maps = [], [("/", dict(f.attrs))]

    def visit(path, obj):
        if isinstance(obj, h5py.Dataset):
            datasets.append((path, obj))
        else:
            attr_maps.append((path, dict(obj.attrs)))

    f.visititems(visit)
    return datasets, attr_maps


class UpstreamSchemaError(ValueError):
    """The file matched neither this package's schema nor any tolerated
    upstream layout; the message names what was looked for."""


def read_upstream_results(filename):
    """Read an upstream-layout mbb_emcee HDF5 file into an MBBResults
    payload dict (same keys `hdf5io._read_results` produces).

    Raises UpstreamSchemaError with a full wanted-vs-found account when
    no chain can be located. Emits one UserWarning listing every
    guessed name and assumed default."""
    h5py = _h5py()
    from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
    from mbb_emcee_tpu_torch.likelihood import Photometry, LikelihoodSpec

    notes = []
    with h5py.File(filename, "r") as f:
        datasets, attr_maps = _walk(f)

        found = {}
        for field, candidates in _DATASET_CANDIDATES.items():
            for rank, cand in enumerate(candidates):
                hits = [(p, d) for p, d in datasets
                        if _norm(p.rsplit("/", 1)[-1]) == cand]
                if hits:
                    path, dset = hits[0]
                    found[field] = np.asarray(dset, np.float64)
                    if rank > 0 or len(hits) > 1:
                        notes.append(
                            f"{field} <- '/{path}' (guessed; candidates "
                            f"were {candidates})")
                    else:
                        notes.append(f"{field} <- '/{path}'")
                    break

        attrs = {}
        for field, candidates in _ATTR_CANDIDATES.items():
            for cand in candidates:
                for path, amap in attr_maps:   # root first = nearest wins
                    for key, val in amap.items():
                        if _norm(key) == cand and field not in attrs:
                            attrs[field] = val
                            notes.append(f"attr {field} <- '{path}@{key}'")
            # (no break: first match already guarded by `field not in attrs`)

        if "chain" not in found:
            looked = {k: v for k, v in _DATASET_CANDIDATES.items()}
            raise UpstreamSchemaError(
                "not a recognizable mbb_emcee result file: no posterior "
                f"chain dataset found in {filename!r}. Looked for "
                f"(normalized basenames, any depth): {looked['chain']}; "
                f"datasets present: {[p for p, _ in datasets] or 'none'}; "
                "this package's own files carry a 'ParamConfig' group "
                "and an 'nwalkers' attr and are read by hdf5io instead.")

        opthin = bool(attrs.get("opthin", False))
        noalpha = bool(attrs.get("noalpha", False))
        if "opthin" not in attrs:
            notes.append("attr opthin absent -> assumed False")
        if "noalpha" not in attrs:
            notes.append("attr noalpha absent -> assumed False")
        wavenorm = float(attrs.get("wavenorm", 500.0))
        if "wavenorm" not in attrs:
            notes.append("attr wavenorm absent -> assumed 500.0 um")
        shape = MBBShape(opthin=opthin, noalpha=noalpha, wavenorm=wavenorm)

        chain = found["chain"]
        chain, chain_notes = _shape_chain(chain, found.get("lnprob"),
                                          opthin, noalpha,
                                          nwalkers_attr=attrs.get("nwalkers"),
                                          niter_attr=attrs.get("iterations"))
        notes.extend(chain_notes)
        nwalkers = chain.shape[0]

        lnp = found.get("lnprob")
        if lnp is not None:
            lnp = np.asarray(lnp, np.float64)
            if lnp.ndim == 1 and lnp.size == nwalkers * chain.shape[1]:
                lnp = lnp.reshape(nwalkers, chain.shape[1])
            elif lnp.shape == (chain.shape[1], nwalkers):
                lnp = lnp.T
            if lnp.shape != (nwalkers, chain.shape[1]):
                notes.append(
                    f"lnprob shape {lnp.shape} does not match the chain "
                    f"{chain.shape[:2]} -> dropped (best_fit and "
                    "model-check surfaces will be unavailable)")
                lnp = None
        if lnp is None and "lnprob" not in found:
            notes.append("no lnprob dataset -> filled with zeros "
                         "(best_fit/ppc meaningless; chains fine)")
        if lnp is None:
            lnp = np.zeros(chain.shape[:2])

        phot, phot_notes = _build_phot(found, Photometry)
        notes.extend(phot_notes)

        spec = LikelihoodSpec.default()
        for field, row in (("lowlim", "lower"), ("uplim", "upper")):
            if field in attrs:
                vals = np.asarray(attrs[field], np.float64).ravel()
                if vals.size == NPARAMS:
                    getattr(spec, row)[:] = vals
                    notes.append(f"{row} box limits taken from file")
        # Zero-variance chain columns were fixed parameters upstream;
        # record them so free-parameter summaries (R-hat, ESS, covar)
        # skip the degenerate columns.
        var = chain.reshape(-1, NPARAMS).var(axis=0)
        fixed_cols = var == 0.0
        if noalpha:
            fixed_cols[3] = True
        if opthin:
            fixed_cols[2] = True
        if fixed_cols.any():
            spec.fixed[:] = fixed_cols
            spec.fixed_values[:] = np.where(
                fixed_cols, chain.reshape(-1, NPARAMS)[0], 0.0)
            notes.append(
                "fixed parameters inferred from zero-variance chain "
                f"columns / model flags: {np.where(fixed_cols)[0].tolist()}")

        payload = {
            "nwalkers": int(nwalkers),
            "thin": 1,
            "shape": shape,
            "redshift": (float(attrs["redshift"])
                         if "redshift" in attrs else None),
            "lumdist": (float(attrs["lumdist"])
                        if "lumdist" in attrs else None),
            "cosmology_name": None,
            "chain": chain,
            "lnprobability": lnp,
            "acceptance_fraction": np.full(nwalkers, np.nan),
            "phot": phot,
            "param_spec": spec,
            "param_init": chain.reshape(-1, NPARAMS).mean(axis=0),
        }
        for field, attr in (("lir", "lir_chain"),
                            ("dustmass", "dustmass_chain"),
                            ("peaklambda", "peaklambda_chain")):
            if field in found:
                payload[attr] = np.asarray(found[field]).ravel()

    warnings.warn(
        "loaded an UPSTREAM-layout mbb_emcee file (reconstructed schema, "
        "MED confidence -- audit the mapping): " + "; ".join(notes),
        UserWarning, stacklevel=3)
    return payload


def _attr_int(val):
    """Coerce an h5py attr (numpy scalar/0-d/1-elem array/bytes) to a
    positive int, or None."""
    try:
        arr = np.asarray(val).ravel()
        if arr.size != 1:
            return None
        n = int(arr[0])
        return n if n > 0 else None
    except (TypeError, ValueError):
        return None


def _shape_chain(chain, lnp, opthin, noalpha, nwalkers_attr=None,
                 niter_attr=None):
    """Coerce the chain to (nwalkers, nsteps, 5). Tolerates flattened and
    transposed layouts and expands reduced-column chains through the
    opthin/noalpha free-parameter map. Flattened (N, npar) chains recover
    the walker axis from (in order) a 2-D lnprob's shape, an nwalkers
    attr, or an iterations attr."""
    notes = []
    chain = np.asarray(chain, np.float64)

    if chain.ndim == 3 and chain.shape[-1] not in (3, 4, 5):
        # parameter axis somewhere else: move the (unique) small axis last
        cand = [i for i, s in enumerate(chain.shape) if s in (3, 4, 5)]
        if len(cand) == 1:
            chain = np.moveaxis(chain, cand[0], -1)
            notes.append(
                f"chain parameter axis found at position {cand[0]} and "
                "moved last (transposed upstream layout)")

    if chain.ndim == 2:
        n_flat = chain.shape[0]
        nw = None
        if lnp is not None and np.asarray(lnp).ndim == 2:
            lnp_shape = np.asarray(lnp).shape
            if n_flat % lnp_shape[0] == 0:
                nw = lnp_shape[0]
        if nw is None:
            nw_attr = _attr_int(nwalkers_attr)
            if nw_attr is not None and n_flat % nw_attr == 0:
                nw = nw_attr
                notes.append(
                    f"flattened (N, npar) chain folded into {nw} walkers "
                    f"x {n_flat // nw} steps via the nwalkers attr "
                    "(walker-major emcee-2.x ordering assumed)")
        if nw is None:
            ni_attr = _attr_int(niter_attr)
            if ni_attr is not None and n_flat % ni_attr == 0 \
                    and n_flat > ni_attr:
                nw = n_flat // ni_attr
                notes.append(
                    f"flattened (N, npar) chain folded into {nw} walkers "
                    f"x {ni_attr} steps via the iterations attr")
        if nw is None:
            nw = 1
            notes.append(
                "chain was flattened (N, npar) with no walker count "
                "recoverable -> imported as a single walker")
        chain = chain.reshape(nw, -1, chain.shape[-1])

    if chain.ndim != 3:
        raise UpstreamSchemaError(
            f"chain has unusable shape {chain.shape}; wanted "
            "(nwalkers, nsteps, npar), (N, npar), or a transpose")

    ncol = chain.shape[-1]
    if ncol != NPARAMS:
        free = [0, 1, 4]
        if not opthin:
            free.insert(2, 2)
        if not noalpha:
            free.insert(-1, 3)
        free = sorted(free)
        if ncol != len(free):
            raise UpstreamSchemaError(
                f"chain has {ncol} parameter columns but the "
                f"opthin={opthin}/noalpha={noalpha} model "
                f"has {len(free)} free parameters; cannot map columns")
        full = np.zeros(chain.shape[:2] + (NPARAMS,))
        full[..., free] = chain
        notes.append(
            f"chain had {ncol} free-parameter columns; expanded to the "
            f"full 5-parameter layout via free indices {free} "
            "(fixed columns zero)")
        chain = full
    return chain, notes


def _build_phot(found, Photometry):
    """Photometry from whatever data arrays the file carries; a fully
    absent photometry section degrades to NaN placeholders (parameter
    and derived-quantity analysis need no photometry)."""
    notes = []
    wave = found.get("wave")
    flux = found.get("flux")
    unc = found.get("flux_unc")
    if wave is None:
        notes.append("no photometry wavelengths found -> placeholder "
                     "photometry (data accessors/PPC unavailable; "
                     "parameter and derived posteriors unaffected)")
        wave = np.array([250.0])
        flux = np.array([np.nan])
        unc = np.array([np.nan])
    else:
        wave = np.asarray(wave, np.float64).ravel()
        if flux is None:
            flux = np.full(wave.size, np.nan)
            notes.append("wavelengths but no fluxes found -> NaN fluxes")
        else:
            flux = np.asarray(flux, np.float64).ravel()
            if flux.size != wave.size:
                notes.append(
                    f"flux length {flux.size} does not match "
                    f"{wave.size} bands -> NaN placeholders")
                flux = np.full(wave.size, np.nan)
        if unc is None:
            unc = np.full(wave.size, np.nan)
            notes.append("no flux uncertainties found -> NaN")
        else:
            unc = np.asarray(unc, np.float64).ravel()
            if unc.size != wave.size:
                notes.append(
                    f"flux_unc length {unc.size} does not match "
                    f"{wave.size} bands -> NaN placeholders")
                unc = np.full(wave.size, np.nan)
    cov = found.get("cov")
    if cov is not None:
        cov = np.asarray(cov, np.float64)
        if cov.shape != (wave.size, wave.size):
            notes.append(f"covariance shape {cov.shape} does not match "
                         f"{wave.size} bands -> dropped")
            cov = None
    return Photometry(wave, flux, unc, cov=cov), notes
