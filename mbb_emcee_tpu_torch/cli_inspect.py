"""`mbb_tpu_inspect_torch`: summarize any HDF5 artifact mbb_emcee_tpu or
this port writes, straight from the shell -- no Python session, no model
file, no device.

    mbb_tpu_inspect_torch fit.h5
    mbb_tpu_inspect_torch survey.h5 --sources SMMJ02399,7 --percentile 95
    mbb_tpu_inspect_torch *.h5 --json

Torch twin of mbb_emcee_tpu/cli_inspect.py, with its options, text and
JSON. The reference's workflow for "what did last night's run say?" is an
interactive session (`mbb_results(h5file=...)` then method calls -- ref:
mbb_emcee/mbb_results.py [reconstructed], SURVEY.md §3.4); the batch/sed
surfaces here additionally need the model .py to reload a fitter.
Inspection must not: this module reads the raw datasets with h5py + numpy
only, so it works on every kind either package writes --

  * single MBB fits          (hdf5io.write_results)
  * MBB batch fits           (MultiFitter.writeToHDF5)
  * MAP-only triage dumps    (MultiFitter.write_map_h5)
  * generic-SED single fits  (SEDResults.writeToHDF5, kind='sed')
  * generic-SED batch fits   (SEDMultiFitter.writeToHDF5, 'sed-batch')
  * generic-SED MAP dumps    (cli_sed --map, kind='sed-map')
  * population fits          (HierarchicalFitter.writeToHDF5,
                              kind='hierarchy')
  * mid-run checkpoints      (checkpoint.py; `prng_impl` as stored)
  * upstream mbb_emcee files (legacy_h5's reconstructed schema)

and degrades gracefully on partial files (derived/evidence/LOO groups
are optional everywhere).  Convergence diagnostics (split-R-hat, bulk
ESS) reuse the port's host-numpy estimators (sampler.split_rhat /
effective_sample_size, imported when first needed); `--no-diag` skips
them for multi-GB chains. No tensor is made and no device is touched.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mbb_emcee_tpu_torch.constants import PARAM_NAMES
from mbb_emcee_tpu_torch.legacy_h5 import (
    _ATTR_CANDIDATES, _DATASET_CANDIDATES, _h5py, _norm, _shape_chain, _walk)

# The root `package` attrs of the two packages' single-fit and batch files:
# either package's file is read here.
_SINGLE_PACKAGES = ("mbb_emcee_tpu", "mbb_emcee_tpu_torch")
_BATCH_PACKAGES = ("mbb_emcee_tpu.multifit", "mbb_emcee_tpu_torch.multifit")

# Default central-interval width, matching par_cen's (50 +/- 34.15).
_DEFAULT_PCT = 68.3

# Recognized derived-quantity datasets: HDF5 name -> (label, unit).
# Single MBB files use the bare names; sed/batch writers use *Chain.
_DERIVED = {
    "LIR": ("L_IR", "Lsun"),
    "LIRChain": ("L_IR", "Lsun"),
    "DustMass": ("M_dust", "Msun"),
    "DustMassChain": ("M_dust", "Msun"),
    "PeakLambda": ("peak lambda", "um"),
    "PeakLambdaChain": ("peak lambda", "um"),
}


def _dec(v):
    """attrs values arrive as bytes, numpy scalars, or str; normalize."""
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _names(arr):
    return [_dec(n) for n in np.asarray(arr)]


def _cen(flat, pct):
    """(median, +err, -err) central interval of a flat sample array."""
    flat = np.asarray(flat, np.float64).ravel()
    flat = flat[np.isfinite(flat)]
    if flat.size == 0:
        return (np.nan, np.nan, np.nan)
    half = pct / 2.0
    lo, mid, hi = np.percentile(flat, [50.0 - half, 50.0, 50.0 + half])
    return (float(mid), float(hi - mid), float(mid - lo))


def detect_kind(f):
    """Classify an open h5py.File into one of the packages' schemas (a
    file of mbb_emcee_tpu or of this port)."""
    kind = _dec(f.attrs.get("kind", ""))
    if kind in ("sed", "sed-batch", "sed-map", "hierarchy"):
        return kind
    pkg = _dec(f.attrs.get("package", ""))
    if pkg in _BATCH_PACKAGES:
        return "batch"
    if pkg in _SINGLE_PACKAGES and "Chain" in f:
        return "single"
    if "MAPFit" in f and "ChainFree" not in f:
        return "map"
    if "prng_impl" in f.attrs and "version" in f.attrs:
        return "checkpoint"
    # Last resort: an UPSTREAM mbb_emcee result file (reconstructed
    # schema, MED confidence -- see legacy_h5). Any chain-candidate
    # dataset at any depth qualifies.
    datasets, _ = _walk(f)
    for cand in _DATASET_CANDIDATES["chain"]:
        if any(_norm(p.rsplit("/", 1)[-1]) == cand for p, _ in datasets):
            return "upstream"
    raise ValueError(
        "not an mbb_emcee_tpu HDF5 artifact (no recognized kind/package "
        "attribute or dataset layout), and no upstream-mbb_emcee chain "
        "dataset either")


def _param_table(chain_flat_by_param, names, fixed, fixed_values, pct):
    """[{name, median, +, -} or {name, fixed}] in parameter order."""
    rows = []
    for i, name in enumerate(names):
        if fixed is not None and fixed[i]:
            rows.append({"name": name, "fixed": float(fixed_values[i])})
        else:
            mid, up, dn = _cen(chain_flat_by_param[i], pct)
            rows.append({"name": name, "median": mid,
                         "uperr": up, "lowerr": dn})
    return rows


def _read_param_config(f, group="ParamConfig"):
    """(fixed_mask, fixed_values) from ParamConfig/ParamSpec, or Nones."""
    for gname, fx, fv in ((group, "Fixed", "FixedValues"),
                          ("ParamSpec", "fixed", "fixed_values")):
        if gname in f and fx in f[gname]:
            g = f[gname]
            return (np.asarray(g[fx]).astype(bool), np.asarray(g[fv]))
    return None, None


def _diagnostics(chain_snw, max_cost=2e8):
    """max split-R-hat + min bulk ESS of a (nsteps, nwalkers, ndim)
    chain; skipped (None) above ~max_cost samples to keep inspection
    instant on multi-GB dumps."""
    nsteps = chain_snw.shape[0]
    if nsteps < 4 or chain_snw.size > max_cost:
        return None
    from mbb_emcee_tpu_torch.sampler import split_rhat, effective_sample_size
    rhat = split_rhat(chain_snw)
    ess = effective_sample_size(chain_snw, kind="bulk")
    return {"max_rhat": float(np.nanmax(rhat)),
            "min_bulk_ess": float(np.nanmin(ess))}


def _derived_rows(f, pct, source=None):
    rows = []
    for dsname, (label, unit) in _DERIVED.items():
        if dsname not in f or not hasattr(f[dsname], "shape"):
            continue
        data = np.asarray(f[dsname])
        if source is not None and data.ndim >= 2:
            data = data[source]
        mid, up, dn = _cen(data, pct)
        rows.append({"name": label, "unit": unit, "median": mid,
                     "uperr": up, "lowerr": dn})
    return rows


def _evidence_info(f):
    """lnZ summaries from Evidence (nested) / PTEvidence groups, both
    the single-fit attrs layout and the batch dataset layout."""
    out = {}
    if "Evidence" in f:
        g = f["Evidence"]
        if "logz" in g.attrs:
            out["logz_nested"] = [float(g.attrs["logz"]),
                                  float(g.attrs["logz_err"])]
        elif "LogZ" in g:
            out["logz_nested"] = [np.asarray(g["LogZ"], np.float64),
                                  np.asarray(g["LogZErr"], np.float64)]
    if "PTEvidence" in f:
        g = f["PTEvidence"]
        if "logz" in g.attrs:
            out["logz_pt"] = [float(g.attrs["logz"]),
                              float(g.attrs["logz_err"])]
        elif "LogZ" in g:
            out["logz_pt"] = [np.asarray(g["LogZ"], np.float64),
                              np.asarray(g["LogZErr"], np.float64)]
    if "LOO" in f:
        g = f["LOO"]
        if "elpd_loo" in g.attrs:
            out["elpd_loo"] = [float(g.attrs["elpd_loo"]),
                               float(g.attrs["se_elpd_loo"])]
        elif "ElpdLoo" in g:
            out["elpd_loo"] = [np.asarray(g["ElpdLoo"], np.float64),
                               np.asarray(g["SeElpdLoo"], np.float64)]
    return out


def _inspect_single(f, kind, pct, diag):
    """Single-fit kinds: 'single' (MBB) and 'sed'. Chain is
    (nwalkers, nsteps, npar)."""
    chain = np.asarray(f["Chain"])
    lnp = np.asarray(f["LogLike"])
    names = _names(f.attrs["param_names"])
    fixed, fixed_values = _read_param_config(f)
    nw, ns, npar = chain.shape
    flat = [chain[:, :, i].ravel() for i in range(npar)]
    info = {
        "kind": kind,
        "nwalkers": nw, "nsteps": ns,
        "thin": int(f.attrs.get("thin", 1)),
        "params": _param_table(flat, names, fixed, fixed_values, pct),
        "best_lnprob": float(np.nanmax(lnp)),
        "acceptance": float(np.mean(np.asarray(
            f["AcceptanceFraction"]))) if "AcceptanceFraction" in f
        else None,
        "derived": _derived_rows(f, pct),
    }
    if kind == "sed":
        info["model"] = _dec(f.attrs.get("model_name", ""))
    else:
        info["model"] = ("MBB opthin" if f.attrs.get("opthin")
                         else "MBB") + \
            (" noalpha" if f.attrs.get("noalpha") else "")
        info["wavenorm"] = float(f.attrs.get("wavenorm", np.nan))
    z = _dec(f.attrs.get("redshift", np.nan))
    if z is not None and np.isfinite(z):
        info["redshift"] = float(z)
    if "Photometry" in f:
        info["nbands"] = int(np.asarray(f["Photometry"]["Wave"]).size)
    if diag:
        free = (np.flatnonzero(~fixed) if fixed is not None
                else np.arange(npar))
        d = _diagnostics(np.transpose(chain[:, :, free], (1, 0, 2)))
        if d:
            info.update(d)
    info.update(_evidence_info(f))
    return info


def _inspect_upstream(f, pct, diag):
    """An UPSTREAM mbb_emcee result file (legacy_h5's reconstructed
    schema): same tolerant dataset/attr matching, h5py+numpy only."""
    datasets, attr_maps = _walk(f)
    found = {}
    for field, candidates in _DATASET_CANDIDATES.items():
        for cand in candidates:
            hits = [d for p, d in datasets
                    if _norm(p.rsplit("/", 1)[-1]) == cand]
            if hits:
                found[field] = np.asarray(hits[0], np.float64)
                break
    attrs = {}
    for field, candidates in _ATTR_CANDIDATES.items():
        for cand in candidates:
            for _, amap in attr_maps:
                for key, val in amap.items():
                    if _norm(key) == cand and field not in attrs:
                        attrs[field] = val
    opthin = bool(attrs.get("opthin", False))
    noalpha = bool(attrs.get("noalpha", False))
    chain, _ = _shape_chain(found["chain"], found.get("lnprob"),
                            opthin, noalpha,
                            nwalkers_attr=attrs.get("nwalkers"),
                            niter_attr=attrs.get("iterations"))
    nw, ns, npar = chain.shape
    flat = [chain[:, :, i].ravel() for i in range(npar)]
    fixed = np.asarray([v.var() == 0.0 for v in flat])
    fixed[3] |= noalpha
    fixed[2] |= opthin
    info = {
        "kind": "upstream",
        "model": ("MBB opthin" if opthin else "MBB")
        + (" noalpha" if noalpha else "") + " (upstream mbb_emcee file)",
        "nwalkers": nw, "nsteps": ns, "thin": 1,
        "params": _param_table(flat, PARAM_NAMES, fixed,
                               [v[0] for v in flat], pct),
        "best_lnprob": (float(np.nanmax(found["lnprob"]))
                        if "lnprob" in found else np.nan),
        "acceptance": None,
        "derived": [],
        # The upstream classification is a last-resort sniff (any
        # chain-candidate dataset qualifies), so a generic emcee/arviz
        # export can land here with MBB labels that mean nothing --
        # say so in the render rather than only in the import warning.
        "caveat": ("schema reconstructed from dataset-name guesses "
                   "(MED confidence) -- parameter labels assume an "
                   "mbb_emcee 5-parameter chain; audit with "
                   "MBBResults(h5file=...) which reports the full "
                   "mapping"),
    }
    for field, label, unit in (("lir", "L_IR", "Lsun"),
                               ("dustmass", "M_dust", "Msun"),
                               ("peaklambda", "lambda_peak", "um")):
        if field in found:
            mid, up, dn = _cen(np.asarray(found[field]).ravel(), pct)
            info["derived"].append({"name": label, "median": mid,
                                    "uperr": up, "lowerr": dn,
                                    "unit": unit})
    if "redshift" in attrs:
        info["redshift"] = float(attrs["redshift"])
    if "wave" in found:
        info["nbands"] = int(np.asarray(found["wave"]).size)
    if diag:
        d = _diagnostics(np.transpose(chain[:, :, ~fixed], (1, 0, 2)))
        if d:
            info.update(d)
    return info


def _select_sources(tokens, source_names, nsources):
    """Resolve --sources tokens (indices or names) to an index array."""
    if not tokens:
        return None
    idx = []
    for tok in tokens:
        tok = tok.strip()
        if tok.lstrip("-").isdigit():
            i = int(tok)
            if not -nsources <= i < nsources:
                raise ValueError(f"source index {i} out of range "
                                 f"(nsources={nsources})")
            idx.append(i % nsources)
        elif source_names and tok in source_names:
            idx.append(source_names.index(tok))
        else:
            raise ValueError(f"unknown source {tok!r}")
    return np.asarray(idx)


def _inspect_batch(f, kind, pct, diag, sources, max_rows):
    """Batch kinds: 'batch' (MBB MultiFitter) and 'sed-batch'.
    ChainFree is (S, nsteps, nwalkers, nfree)."""
    chain = f["ChainFree"]        # keep as dataset: slice per source
    S, ns, nw, nfree = chain.shape
    if kind == "batch":
        fixed, _ = _read_param_config(f)
        all_names = list(PARAM_NAMES)
    else:
        fixed, _ = _read_param_config(f)
        all_names = _names(f.attrs["param_names"])
    free_names = ([n for n, fx in zip(all_names, fixed) if not fx]
                  if fixed is not None else all_names[:nfree])
    if len(free_names) != nfree:          # defensive: stale spec
        free_names = [f"p{i}" for i in range(nfree)]

    source_names = (_names(f["SourceNames"]) if "SourceNames" in f
                    else None)
    sel = _select_sources(sources, source_names, S)
    shown = (sel if sel is not None
             else np.arange(min(S, max_rows)))
    lnp = f["LnProbability"]
    accept = (np.asarray(f["AcceptanceFraction"])
              if "AcceptanceFraction" in f else None)
    ev = _evidence_info(f)

    rows = []
    for s in shown:
        s = int(s)
        ch = np.asarray(chain[s])         # (nsteps, nwalkers, nfree)
        flat = [ch[:, :, i].ravel() for i in range(nfree)]
        row = {
            "source": (source_names[s] if source_names
                       else f"src{s}"),
            "index": s,
            "params": _param_table(flat, free_names, None, None, pct),
            "best_lnprob": float(np.nanmax(np.asarray(lnp[s]))),
            "acceptance": (float(np.mean(accept[s]))
                           if accept is not None else None),
            "derived": _derived_rows(f, pct, source=s),
        }
        if diag:
            d = _diagnostics(ch)
            if d:
                row.update(d)
        for key in ("logz_nested", "logz_pt", "elpd_loo"):
            if key in ev:
                row[key] = [float(np.asarray(ev[key][0]).ravel()[s]),
                            float(np.asarray(ev[key][1]).ravel()[s])]
        rows.append(row)

    info = {"kind": kind, "nsources": S, "nwalkers": nw, "nsteps": ns,
            "thin": int(f.attrs.get("thin", 1)),
            "free_params": free_names, "sources": rows,
            "shown": len(rows)}
    if kind == "sed-batch":
        info["model"] = _dec(f.attrs.get("model_name", ""))
    else:
        info["model"] = ("MBB opthin" if f.attrs.get("opthin")
                         else "MBB") + \
            (" noalpha" if f.attrs.get("noalpha") else "")
    if "MAPFit" in f:
        info["has_map"] = True
    if "XLAContinuation" in f or "Keys" in f:
        info["continuable"] = True
    return info


def _inspect_map(f, kind, pct):
    """MAP-only triage dumps: MultiFitter.write_map_h5 ('map', group
    MAPFit) and cli_sed --map ('sed-map', datasets at root).

    Params is stored FULL-space (S, npar) while Sigma is free-space
    (S, nfree); the file records no fixed mask, so the free set is
    reconstructed from the model flags (opthin drops lambda0, noalpha
    drops alpha). If a user additionally fix_param'ed something the
    widths can no longer be paired with columns and are omitted rather
    than mislabeled."""
    if kind == "map":
        g = f["MAPFit"]
        names = list(PARAM_NAMES)
        free = [n for n in names
                if not (n == "lambda0" and f.attrs.get("opthin"))
                and not (n == "alpha" and f.attrs.get("noalpha"))]
    else:
        g = f
        names = _names(f.attrs["param_names"])
        free = names
    params = np.asarray(g["Params"], np.float64)
    sigma = np.asarray(g["Sigma"], np.float64)
    lnp = np.asarray(g["LnProb"], np.float64)
    interior = (np.asarray(g["Interior"]).astype(bool)
                if "Interior" in g else None)
    # The single-fit CLI's --map artifact stores a 1-D (npar,) vector
    # and scalar LnProb (cli.py); normalize to the batch layout
    if params.ndim == 1:
        params = params[None, :]
        sigma = np.atleast_2d(sigma)
        lnp = np.atleast_1d(lnp)
        if interior is not None:
            interior = np.atleast_1d(interior)
    S, npar = params.shape
    if len(names) != npar:
        names = [f"p{i}" for i in range(npar)]
        free = names
    sig_by_name = (dict(zip(free, range(sigma.shape[1])))
                   if sigma.shape[1] == len(free) else {})
    source_names = (_names(f["SourceNames"]) if "SourceNames" in f
                    else None)
    rows = []
    for s in range(S):
        prow = []
        for i, n in enumerate(names):
            cell = {"name": n, "map": float(params[s, i])}
            if n in sig_by_name:
                cell["sigma"] = float(sigma[s, sig_by_name[n]])
            prow.append(cell)
        rows.append({
            "source": source_names[s] if source_names else f"src{s}",
            "index": s,
            "params": prow,
            "lnprob": float(lnp[s]),
            "interior": (bool(interior[s]) if interior is not None
                         else None),
        })
    return {"kind": kind, "nsources": S, "sources": rows,
            "model": _dec(f.attrs.get("model_name", "MBB"))}


def _inspect_hierarchy(f, pct):
    chain = np.asarray(f["chain_free"])       # (nsteps, nwalkers, nfree)
    names = _names(f.attrs["hyper_names"])
    ns, nw, nh = chain.shape
    # chain_free columns are FREE-hyper-space; the file's free_idx attr
    # maps them to full-space hyper names (hierarchy.writeToHDF5). With
    # a fixed hyper not at the tail, names[:nh] would mislabel columns.
    if "free_idx" in f.attrs:
        free_idx = np.asarray(f.attrs["free_idx"]).astype(int)
        free_names = [names[i] for i in free_idx[:nh]]
    else:
        free_names = names[:nh]
    flat = [chain[:, :, i].ravel() for i in range(nh)]
    ess = np.asarray(f["reweight_ess"], np.float64)
    return {"kind": "hierarchy", "nwalkers": nw, "nsteps": ns,
            "params": _param_table(flat, free_names, None, None, pct),
            "best_lnprob": float(np.nanmax(np.asarray(
                f["lnprobability"]))),
            "nsources": int(np.asarray(f["samples"]).shape[0]),
            "min_reweight_ess": float(np.nanmin(ess))}


def _inspect_checkpoint(f):
    info = {"kind": "checkpoint",
            "multi": bool(f.attrs.get("multi", False)),
            "tier": _dec(f.attrs.get("tier", "stretch")),
            "prng_impl": _dec(f.attrs.get("prng_impl", "?"))}
    meta = {k: _dec(v) for k, v in f.attrs.items()
            if k not in ("version", "multi", "prng_impl", "tier")
            and np.isscalar(_dec(v))}
    info["meta"] = meta
    # Progress so far: v2 checkpoints store chain blocks under
    # Segments/segNNNNN/Chain (record axis 0 single-fit, 1 batch);
    # v1 stored a single ChainSoFar dataset (checkpoint.py layout).
    axis = 1 if info["multi"] else 0
    if "Segments" in f and len(f["Segments"]):
        shapes = [f["Segments"][n]["Chain"].shape
                  for n in f["Segments"] if "Chain" in f["Segments"][n]]
        if shapes:
            shape = list(shapes[0])
            shape[axis] = sum(s[axis] for s in shapes)
            info["chain_shape"] = shape
    elif "ChainSoFar" in f:
        info["chain_shape"] = list(f["ChainSoFar"].shape)
    return info


def inspect_file(path, pct=_DEFAULT_PCT, diag=True, sources=(),
                 max_rows=20):
    """One file -> one plain dict (JSON-serializable). h5py is imported
    here: without it this raises an ImportError that names it."""
    h5py = _h5py("inspecting an HDF5 file")
    with h5py.File(path, "r") as f:
        kind = detect_kind(f)
        if kind in ("single", "sed"):
            info = _inspect_single(f, kind, pct, diag)
        elif kind in ("batch", "sed-batch"):
            info = _inspect_batch(f, kind, pct, diag, sources, max_rows)
        elif kind in ("map", "sed-map"):
            info = _inspect_map(f, kind, pct)
        elif kind == "hierarchy":
            info = _inspect_hierarchy(f, pct)
        elif kind == "upstream":
            info = _inspect_upstream(f, pct, diag)
        else:
            info = _inspect_checkpoint(f)
    info["file"] = str(path)
    return info


# -- rendering ---------------------------------------------------------------

def _fmt_val(row):
    if "fixed" in row:
        return f"{row['name']} = {row['fixed']:.6g} (fixed)"
    return (f"{row['name']} = {row['median']:.6g} "
            f"+{row['uperr']:.3g} / -{row['lowerr']:.3g}")


def _render(info, pct):
    out = [f"{info['file']}: {info['kind']}"
           + (f" [{info['model']}]" if info.get("model") else "")]
    push = out.append
    if info.get("caveat"):
        push(f"  CAVEAT: {info['caveat']}")
    if info["kind"] in ("single", "sed", "hierarchy", "upstream"):
        geom = f"  {info['nwalkers']} walkers x {info['nsteps']} steps"
        if info.get("thin", 1) > 1:
            geom += f" (thin={info['thin']})"
        if "nbands" in info:
            geom += f", {info['nbands']} bands"
        if "redshift" in info:
            geom += f", z={info['redshift']:g}"
        if "nsources" in info:
            geom += f", {info['nsources']} sources"
        push(geom)
        for row in info["params"]:
            push(f"    {_fmt_val(row)}   [{pct:g}% CI]")
        for row in info.get("derived", []):
            unit = f" {row['unit']}" if row["unit"] else ""
            push(f"    {row['name']} = {row['median']:.4g} "
                 f"+{row['uperr']:.3g} / -{row['lowerr']:.3g}{unit}")
        tail = [f"best lnP = {info['best_lnprob']:.4g}"]
        if info.get("acceptance") is not None:
            tail.append(f"accept = {info['acceptance']:.3f}")
        if "max_rhat" in info:
            tail.append(f"max R-hat = {info['max_rhat']:.4f}")
        if "min_bulk_ess" in info:
            tail.append(f"min bulk ESS = {info['min_bulk_ess']:.0f}")
        if "min_reweight_ess" in info:
            tail.append(
                f"min reweight ESS = {info['min_reweight_ess']:.0f}")
        push("  " + ", ".join(tail))
        for key, label in (("logz_nested", "lnZ(nested)"),
                           ("logz_pt", "lnZ(PT)"),
                           ("elpd_loo", "elpd_loo")):
            if key in info:
                v, e = info[key]
                push(f"  {label} = {v:.3f} +/- {e:.3f}")
    elif info["kind"] in ("batch", "sed-batch"):
        push(f"  {info['nsources']} sources x {info['nwalkers']} "
             f"walkers x {info['nsteps']} steps; free params: "
             + ", ".join(info["free_params"])
             + ("; continuable" if info.get("continuable") else ""))
        for row in info["sources"]:
            cells = "  ".join(_fmt_val(p) for p in row["params"])
            line = f"  [{row['index']:>3}] {row['source']:<16} {cells}"
            extras = []
            if row.get("max_rhat") is not None:
                extras.append(f"R-hat {row['max_rhat']:.3f}")
            for key, label in (("logz_nested", "lnZ"),
                               ("logz_pt", "lnZ_PT"),
                               ("elpd_loo", "elpd")):
                if key in row:
                    extras.append(f"{label} {row[key][0]:.2f}")
            if extras:
                line += "   (" + ", ".join(extras) + ")"
            push(line)
            for d in row.get("derived", []):
                unit = f" {d['unit']}" if d["unit"] else ""
                push(f"        {d['name']} = {d['median']:.4g} "
                     f"+{d['uperr']:.3g} / -{d['lowerr']:.3g}{unit}")
        if info["shown"] < info["nsources"]:
            push(f"  ... {info['nsources'] - info['shown']} more "
                 f"sources (--sources or --max-rows to show)")
    elif info["kind"] in ("map", "sed-map"):
        push(f"  MAP triage, {info['nsources']} sources")
        for row in info["sources"]:
            cells = "  ".join(
                f"{p['name']}={p['map']:.4g}"
                + (f"+/-{p['sigma']:.3g}" if "sigma" in p else "")
                for p in row["params"])
            flag = ("" if row["interior"] in (True, None)
                    else "  [edge]")
            push(f"  [{row['index']:>3}] {row['source']:<16} {cells} "
                 f" lnP={row['lnprob']:.4g}{flag}")
    else:   # checkpoint
        push(f"  mid-run checkpoint ({'batch' if info['multi'] else 'single'}"
             f"-fit, {info.get('tier', 'stretch')} tier), "
             f"prng={info['prng_impl']}")
        if "chain_shape" in info:
            push(f"  chain so far: {tuple(info['chain_shape'])}")
        for k in sorted(info.get("meta", {})):
            push(f"    {k} = {info['meta'][k]}")
    return "\n".join(out)


def build_parser():
    p = argparse.ArgumentParser(
        prog="mbb_tpu_inspect_torch",
        description="Summarize mbb_emcee_tpu HDF5 outputs (any kind: "
                    "single/batch/sed/MAP/population/checkpoint) "
                    "without refitting or reloading models.")
    p.add_argument("files", nargs="+", help="HDF5 file(s) to inspect")
    p.add_argument("--percentile", type=float, default=_DEFAULT_PCT,
                   help="central-interval width in %% (default 68.3)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON (one object per file)")
    p.add_argument("--no-diag", action="store_true",
                   help="skip R-hat/ESS diagnostics (instant on huge "
                        "chains: no rank normalization or autocorrelation "
                        "FFTs over the stored chains)")
    p.add_argument("--sources", default=None,
                   help="comma-separated source names/indices to show "
                        "(batch kinds)")
    p.add_argument("--max-rows", type=int, default=20,
                   help="max sources printed without --sources "
                        "(default 20)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not 0.0 < args.percentile < 100.0:
        raise SystemExit("--percentile must be in (0, 100)")
    sources = ([t for t in args.sources.split(",") if t.strip()]
               if args.sources else ())
    rc = 0
    results = []
    for path in args.files:
        try:
            info = inspect_file(path, pct=args.percentile,
                                diag=not args.no_diag,
                                sources=sources,
                                max_rows=args.max_rows)
        except (OSError, ValueError, KeyError) as e:
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1
            continue
        results.append(info)
        if not args.json:
            print(_render(info, args.percentile))
    if args.json and results:
        print(json.dumps(results if len(results) > 1 else results[0],
                         default=lambda o: (o.tolist()
                                            if isinstance(o, np.ndarray)
                                            else float(o))))
    return rc


if __name__ == "__main__":
    sys.exit(main())
