"""HDF5 persistence for fit results, in the schema of mbb_emcee_tpu/hdf5io.py
(_SCHEMA_VERSION 1), so a file written by either package loads in the
other. h5py is imported inside the functions: only HDF5 I/O needs it.

    / attrs: schema_version, package, param_names, nwalkers, thin, opthin,
             noalpha, wavenorm, redshift (NaN if unset), lumdist (NaN if
             unset), cosmology[, cosmology_H0/Om0/Ol0]
    /Chain (nwalkers, nsteps, 5)   /LogLike (nwalkers, nsteps)
    /AcceptanceFraction (nwalkers,)
    /Photometry/{Wave,Flux,FluxUnc[,Cov][,BandNames]}
    /ResponsePack/{Nodes,Weights}  (optional)
    /ParamConfig/{Lower,Upper,Fixed,FixedValues,PriorMean,PriorInvSigma,
                  Initial[,PhotUpperLimits]}
    /LIR, /DustMass, /PeakLambda  (optional derived chains, attrs = meta)
    /Evidence/{Samples,LogLike,LogWt}  (optional nested-sampling run,
              attrs = logz, logz_err, h, n_iter, n_like, converged)
    /LOO  (optional WAIC + PSIS-LOO summaries, modelcheck.write_loo_group)
    /PTEvidence  (optional, after run_pt: attrs logz, logz_err[, logz_ti,
                  logz_ti_err])

A MAP-triage file (the --map flows of both CLIs; no chains) holds the model
shape attrs, /Wave, /Flux, /Unc and
    /MAPFit/{Params,LnProb,Cov,Sigma,Interior,GradNorm}
(one row per source in the batch layout), which the batch results file
also carries after MultiFitter.run_map().
"""

from __future__ import annotations

import numpy as np

from mbb_emcee_tpu_torch.constants import PARAM_NAMES

_SCHEMA_VERSION = 1


def is_native_results_file(h5file):
    """True when the file carries this schema (a 'nwalkers' root attr and a
    'ParamConfig' group)."""
    import h5py
    with h5py.File(h5file, "r") as f:
        return "nwalkers" in f.attrs and "ParamConfig" in f


def is_sed_results_file(h5file):
    """True when the file is a generic model's results (sed.SEDResults,
    root attr kind = "sed"), which MBBResults refuses."""
    import h5py
    with h5py.File(h5file, "r") as f:
        kind = f.attrs.get("kind", "")
    return (kind.decode() if isinstance(kind, bytes) else str(kind)) == "sed"


MAP_FIELDS = ("Params", "LnProb", "Cov", "Sigma", "Interior", "GradNorm")


def write_map_group(f, params, lnprob, cov, sigma, interior, grad_norm):
    """The /MAPFit group of an open h5py file, in MAP_FIELDS' order."""
    g = f.create_group("MAPFit")
    for name, data in zip(MAP_FIELDS, (params, lnprob, cov, sigma, interior,
                                       grad_norm)):
        g.create_dataset(name, data=data)


def write_map_file(filename, shape, wave, flux, unc, fields, attrs=None,
                   datasets=None):
    """A MAP-triage file: the model shape, the photometry, any extra root
    `attrs` and `datasets` (dicts), and /MAPFit from `fields`
    (write_map_group's arguments)."""
    import h5py
    with h5py.File(filename, "w") as f:
        for k, v in (attrs or {}).items():
            f.attrs[k] = v
        f.attrs["wavenorm"] = shape.wavenorm
        f.attrs["opthin"] = shape.opthin
        f.attrs["noalpha"] = shape.noalpha
        f.create_dataset("Wave", data=wave)
        f.create_dataset("Flux", data=flux)
        f.create_dataset("Unc", data=unc)
        for k, v in (datasets or {}).items():
            f.create_dataset(k, data=v)
        write_map_group(f, *fields)
    return filename


def write_results(filename, res):
    import h5py
    with h5py.File(filename, "w") as f:
        _write_results(f, res)


def _write_results(f, res):
    f.attrs["schema_version"] = _SCHEMA_VERSION
    f.attrs["package"] = "mbb_emcee_tpu_torch"
    f.attrs["param_names"] = np.array([n.encode() for n in PARAM_NAMES])
    f.attrs["nwalkers"] = res.nwalkers
    f.attrs["thin"] = res.thin
    f.attrs["opthin"] = res.shape.opthin
    f.attrs["noalpha"] = res.shape.noalpha
    f.attrs["wavenorm"] = res.shape.wavenorm
    f.attrs["redshift"] = np.nan if res.redshift is None else res.redshift
    f.attrs["lumdist"] = np.nan if res.lumdist is None else res.lumdist
    f.attrs["cosmology"] = (res.cosmology_name or "").encode()
    cosmo = res._cosmo
    if cosmo is not None and hasattr(cosmo, "H0"):
        f.attrs["cosmology_H0"] = float(cosmo.H0)
        f.attrs["cosmology_Om0"] = float(cosmo.Om0)
        f.attrs["cosmology_Ol0"] = (np.nan if cosmo.Ol0 is None
                                    else float(cosmo.Ol0))

    f.create_dataset("Chain", data=np.asarray(res.chain, np.float32),
                     compression="gzip", compression_opts=4)
    f.create_dataset("LogLike",
                     data=np.asarray(res.lnprobability, np.float32),
                     compression="gzip", compression_opts=4)
    f.create_dataset("AcceptanceFraction",
                     data=np.asarray(res.acceptance_fraction, np.float32))

    ph = f.create_group("Photometry")
    ph.create_dataset("Wave", data=res.phot.wave)
    ph.create_dataset("Flux", data=res.phot.flux)
    ph.create_dataset("FluxUnc", data=res.phot.unc)
    if res.phot.cov is not None:
        ph.create_dataset("Cov", data=res.phot.cov)
    if res.phot.band_names is not None:
        ph.create_dataset("BandNames", data=np.array(
            [n.encode() for n in res.phot.band_names]))

    if res.response_pack is not None:
        g = f.create_group("ResponsePack")
        g.create_dataset("Nodes", data=np.asarray(res.response_pack[0],
                                                  np.float64))
        g.create_dataset("Weights", data=np.asarray(res.response_pack[1],
                                                    np.float64))

    pc = f.create_group("ParamConfig")
    spec = res.param_spec
    pc.create_dataset("Lower", data=spec.lower)
    pc.create_dataset("Upper", data=spec.upper)
    pc.create_dataset("Fixed", data=spec.fixed.astype(np.uint8))
    pc.create_dataset("FixedValues", data=spec.fixed_values)
    pc.create_dataset("PriorMean", data=spec.prior_mean)
    pc.create_dataset("PriorInvSigma", data=spec.prior_isigma)
    pc.create_dataset("Initial", data=res.param_init)
    if spec.uplim_bands is not None:
        pc.create_dataset("PhotUpperLimits",
                          data=spec.uplim_bands.astype(np.uint8))

    for name, chain, meta in (
            ("LIR", res.lir_chain, res.lir_meta),
            ("DustMass", res.dustmass_chain, res.dustmass_meta),
            ("PeakLambda", res.peaklambda_chain, None)):
        if chain is not None:
            ds = f.create_dataset(name, data=np.asarray(chain, np.float64),
                                  compression="gzip", compression_opts=4)
            for k, v in (meta or {}).items():
                ds.attrs[k] = v
    ev = getattr(res, "evidence", None)
    if ev is not None:
        g = f.create_group("Evidence")
        g.attrs["logz"] = ev.logz
        g.attrs["logz_err"] = ev.logz_err
        g.attrs["h"] = ev.h
        g.attrs["n_iter"] = ev.n_iter
        g.attrs["n_like"] = ev.n_like
        g.attrs["converged"] = bool(ev.converged)
        for name, arr in (("Samples", ev.samples), ("LogLike", ev.loglike),
                          ("LogWt", ev.logwt)):
            g.create_dataset(name, data=np.asarray(arr, np.float64),
                             compression="gzip", compression_opts=4)
    if res.logz_pt is not None:
        g = f.create_group("PTEvidence")
        g.attrs["logz"], g.attrs["logz_err"] = res.logz_pt
        if res.logz_ti is not None:
            g.attrs["logz_ti"], g.attrs["logz_ti_err"] = res.logz_ti
    if res.loo_result is not None:
        from mbb_emcee_tpu_torch.modelcheck import write_loo_group
        write_loo_group(f, res.loo_result)


def read_results(filename):
    """Read back into a dict of MBBResults attribute values."""
    import h5py
    with h5py.File(filename, "r") as f:
        return _read_results(f)


def _read_results(f):
    from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
    from mbb_emcee_tpu_torch.likelihood import Photometry, LikelihoodSpec

    out = {}
    out["nwalkers"] = int(f.attrs["nwalkers"])
    out["thin"] = int(f.attrs["thin"])
    out["shape"] = MBBShape(opthin=bool(f.attrs["opthin"]),
                            noalpha=bool(f.attrs["noalpha"]),
                            wavenorm=float(f.attrs["wavenorm"]))
    z = float(f.attrs["redshift"])
    out["redshift"] = None if np.isnan(z) else z
    dl = float(f.attrs["lumdist"])
    out["lumdist"] = None if np.isnan(dl) else dl
    cname = f.attrs["cosmology"]
    cname = cname.decode() if isinstance(cname, bytes) else str(cname)
    out["cosmology_name"] = cname or None
    if "cosmology_H0" in f.attrs:
        ol0 = float(f.attrs["cosmology_Ol0"])
        out["cosmology_params"] = (float(f.attrs["cosmology_H0"]),
                                   float(f.attrs["cosmology_Om0"]),
                                   None if np.isnan(ol0) else ol0)

    out["chain"] = np.asarray(f["Chain"], np.float64)
    out["lnprobability"] = np.asarray(f["LogLike"], np.float64)
    out["acceptance_fraction"] = np.asarray(f["AcceptanceFraction"],
                                            np.float64)

    ph = f["Photometry"]
    names = None
    if "BandNames" in ph:
        names = [n.decode() for n in np.asarray(ph["BandNames"])]
    out["phot"] = Photometry(
        np.asarray(ph["Wave"]), np.asarray(ph["Flux"]),
        np.asarray(ph["FluxUnc"]),
        cov=np.asarray(ph["Cov"]) if "Cov" in ph else None,
        band_names=names)

    if "ResponsePack" in f:
        g = f["ResponsePack"]
        out["response_pack"] = (np.asarray(g["Nodes"]),
                                np.asarray(g["Weights"]))

    pc = f["ParamConfig"]
    out["param_spec"] = LikelihoodSpec(
        lower=np.asarray(pc["Lower"]),
        upper=np.asarray(pc["Upper"]),
        fixed=np.asarray(pc["Fixed"]).astype(bool),
        fixed_values=np.asarray(pc["FixedValues"]),
        prior_mean=np.asarray(pc["PriorMean"]),
        prior_isigma=np.asarray(pc["PriorInvSigma"]),
        uplim_bands=(np.asarray(pc["PhotUpperLimits"]).astype(bool)
                     if "PhotUpperLimits" in pc else None))
    out["param_init"] = np.asarray(pc["Initial"])

    for name, attr, meta_attr in (
            ("LIR", "lir_chain", "lir_meta"),
            ("DustMass", "dustmass_chain", "dustmass_meta"),
            ("PeakLambda", "peaklambda_chain", None)):
        if name in f:
            out[attr] = np.asarray(f[name])
            if meta_attr:
                out[meta_attr] = dict(f[name].attrs)
    if "Evidence" in f:
        from mbb_emcee_tpu_torch.nested import NestedResult
        g = f["Evidence"]
        out["evidence"] = NestedResult(
            logz=float(g.attrs["logz"]), logz_err=float(g.attrs["logz_err"]),
            h=float(g.attrs["h"]), samples=np.asarray(g["Samples"]),
            loglike=np.asarray(g["LogLike"]), logwt=np.asarray(g["LogWt"]),
            n_iter=int(g.attrs["n_iter"]), n_like=int(g.attrs["n_like"]),
            converged=bool(g.attrs.get("converged", True)))
    if "PTEvidence" in f:
        g = f["PTEvidence"]
        out["logz_pt"] = (float(g.attrs["logz"]), float(g.attrs["logz_err"]))
        if "logz_ti" in g.attrs:
            out["logz_ti"] = (float(g.attrs["logz_ti"]),
                              float(g.attrs["logz_ti_err"]))
    if "LOO" in f:
        from mbb_emcee_tpu_torch.modelcheck import read_loo_group
        out["loo_result"] = read_loo_group(f["LOO"])
    return out
