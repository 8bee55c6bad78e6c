"""Batch command line: run_mbb_emcee_tpu_torch_batch.

Torch twin of mbb_emcee_tpu/cli_batch.py. Reads a source CATALOG
(catalog.py format: shared bands, one row per source) and fits the whole
batch through MultiFitter -- on a CUDA device each sampling phase is one
launch of the multi-source kernel -- then writes one HDF5 file in the JAX
package's batch schema (MultiFitter.from_h5 of either package reloads it).

Usage example:
    run_mbb_emcee_tpu_torch_batch catalog.txt batch.h5 -b 150 -n 1000 \
        --get-lir --get-peaklambda --summary --device cuda

The flags are the JAX batch CLI's (MAP triage --map / --init-map, the
--ppc / --loo checks, --hmc, --pt, the per-source nested-sampling evidence
--get-evidence and the --population stage with its --plot-population figure
included) plus --device (default cuda; --device cpu runs the plain torch
path) and --profile-dir (a torch.profiler trace of the batch fit). Flags
whose features are not ported yet exit non-zero up front with the
ROADMAP.md item that carries them.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time

from mbb_emcee_tpu_torch.cli import (
    _responses, _uplim_mask, _validate_extend_flags)
from mbb_emcee_tpu_torch.constants import PARAM_NAMES

# Flags of the JAX package's batch CLI whose features wait, and the
# ROADMAP.md queue-A item that carries each.
_WAITING = (
    ("mesh_devices", "--mesh-devices", "A11"),
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="run_mbb_emcee_tpu_torch_batch",
        description="Fit a catalog of modified-blackbody sources as one "
                    "batch on a CUDA GPU (one multi-source kernel launch "
                    "per sampling phase) or the CPU.")
    p.add_argument("catalog", help="catalog file: 'wave = ...' header + "
                                   "'name z flux unc [flux unc ...]' rows")
    p.add_argument("outfile", help="output HDF5 file (whole batch; reload "
                                   "with MultiFitter.from_h5)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to fit (default: cuda; --device cpu runs the "
                        "plain torch path on the CPU)")

    g = p.add_argument_group("sampler")
    g.add_argument("-w", "--nwalkers", type=int, default=250)
    g.add_argument("-b", "--burn", type=int, default=50,
                   help="burn-in steps (default 50)")
    g.add_argument("-n", "--nsteps", type=int, default=250,
                   help="production steps per walker (default 250)")
    g.add_argument("--thin", type=int, default=1,
                   help="record every THIN-th step")
    g.add_argument("--no-recenter-burn", action="store_true",
                   help="skip the per-source re-center-on-best-walker "
                        "re-burn phase")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--stretch-a", type=float, default=2.0,
                   help="stretch-move scale parameter a (default 2)")
    g.add_argument("--sampler-backend", choices=["auto", "torch", "fused"],
                   default="auto",
                   help="'fused' runs each sampling phase as one launch of "
                        "the multi-source CUDA kernel; 'torch' is the plain "
                        "torch multi run; 'auto' (default) is fused on "
                        "cuda, torch on cpu")
    g.add_argument("--mesh-devices", type=int, default=None, metavar="N")
    g.add_argument("--checkpoint", default=None,
                   help="HDF5 file to flush the batch's chains + sampler "
                        "state to during the production run")
    g.add_argument("--checkpoint-interval", type=int, default=100,
                   help="recorded steps between checkpoint flushes")
    g.add_argument("--resume", action="store_true",
                   help="resume an interrupted batch run from --checkpoint")
    g.add_argument("--hmc", action="store_true",
                   help="gradient-based Hamiltonian MC instead of the "
                        "stretch move (--burn becomes the warmup length)")
    g.add_argument("--hmc-leapfrog", type=int, default=16,
                   help="leapfrog steps per HMC trajectory (default 16)")
    g.add_argument("--hmc-target-accept", type=float, default=0.8,
                   help="dual-averaging target acceptance (default 0.8)")
    g.add_argument("--pt", action="store_true",
                   help="parallel tempering with replica exchange "
                        "(mixes the optically thick T-lambda0 bimodality; "
                        "also reports per-source stepping-stone lnZ)")
    g.add_argument("--pt-rungs", type=int, default=12,
                   help="temperature rungs for --pt (default 12)")
    g.add_argument("--pt-beta-min", type=float, default=None,
                   help="hottest nonzero inverse temperature "
                        "(default: auto)")
    g.add_argument("--map", action="store_true",
                   help="MAP + Laplace triage of every source only (no "
                        "MCMC): per-source table and a MAPFit-only HDF5 "
                        "file")
    g.add_argument("--map-starts", type=int, default=8,
                   help="optimizer starts per source for --map / --init-map")
    g.add_argument("--init-map", action="store_true",
                   help="seed each source's walker ball at its MAP mode "
                        "with ~2 Laplace-sigma scatter")

    g = p.add_argument_group(
        "serving loop",
        "run-until-converged: after the production run, keep extending "
        "until every source's split-R-hat is below the threshold")
    g.add_argument("--extend-until", type=float, default=None,
                   metavar="RHAT",
                   help="extend production until max per-source split-"
                        "R-hat < RHAT (e.g. 1.05)")
    g.add_argument("--extend-step", type=int, default=None,
                   help="steps per extension (default: --nsteps)")
    g.add_argument("--max-steps", type=int, default=None,
                   help="stop extending after this many total production "
                        "steps (default: 10x --nsteps)")
    g.add_argument("--tau-mult", type=float, default=None,
                   help="additionally require chain length >= TAU_MULT x "
                        "the largest autocorrelation time (emcee's rule "
                        "of thumb is ~50)")

    g = p.add_argument_group("model")
    g.add_argument("--opthin", action="store_true",
                   help="optically thin model (drops lambda0)")
    g.add_argument("--noalpha", action="store_true",
                   help="no Wien-side power-law merge (drops alpha)")
    g.add_argument("--wavenorm", type=float, default=500.0,
                   help="observer-frame normalization wavelength, um")

    g = p.add_argument_group("parameters",
                             f"PARAM is one of {', '.join(PARAM_NAMES)}; "
                             "applied to every source in the batch")
    g.add_argument("--initval", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--initscatter", nargs=2, action="append", default=[],
                   metavar=("PARAM", "SCATTER"))
    g.add_argument("--lowlim", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--uplim", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--fixed", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--prior", nargs=3, action="append", default=[],
                   metavar=("PARAM", "MEAN", "SIGMA"),
                   help="Gaussian prior")

    g = p.add_argument_group("data")
    g.add_argument("--responsefile", default=None,
                   help="filter list file ('band spec' lines) enabling "
                        "response-integrated fluxes (the catalog needs a "
                        "'bands = ...' header row)")
    g.add_argument("--responsedir", default=None,
                   help="directory filter files are relative to")
    g.add_argument("--builtin-responses", action="store_true",
                   help="resolve the catalog's band names against the "
                        "built-in instrument library (PACS_70/100/160, "
                        "SPIRE_250/350/500, SCUBA2_450/850, ...) and fit "
                        "with response-integrated fluxes")
    g.add_argument("--photon-counter", action="store_true",
                   help="photon-counting detector convention for responses")
    g.add_argument("--phot-uplim", action="append", default=[],
                   metavar="BAND",
                   help="flag this band (name or 0-based index) as an "
                        "UPPER LIMIT for every source, in addition to "
                        "any 'uplims' catalog header row (repeatable)")
    g.add_argument("--corrfile", default=None,
                   help="FITS image with the shared (nb, nb) band "
                        "CORRELATION matrix (each source's covariance is "
                        "D_s R D_s with its own catalog uncertainties; a "
                        "covariance matrix is normalized to its "
                        "correlation); not combinable with upper limits")
    g.add_argument("--corrextn", type=int, default=0,
                   help="FITS extension of --corrfile (default 0)")

    g = p.add_argument_group(
        "derived quantities",
        "computed for the whole batch, using the catalog's per-source "
        "redshift column")
    g.add_argument("--cosmology", default="WMAP9",
                   help="named cosmology (WMAP5/7/9, Planck13/15/18)")
    g.add_argument("--get-lir", action="store_true",
                   help="compute per-source L_IR(8-1000um rest) posteriors")
    g.add_argument("--lir-wavemin", type=float, default=8.0)
    g.add_argument("--lir-wavemax", type=float, default=1000.0)
    g.add_argument("--get-dustmass", action="store_true")
    g.add_argument("--kappa", type=float, default=2.64,
                   help="dust opacity m^2/kg (default 2.64)")
    g.add_argument("--kappa-wave", type=float, default=125.0,
                   help="rest wavelength of kappa, um (default 125)")
    g.add_argument("--get-peaklambda", action="store_true")
    g.add_argument("--derived-thin", type=int, default=1,
                   help="thin factor for derived-quantity chains")
    g.add_argument("--get-evidence", action="store_true",
                   help="per-source Bayesian evidence lnZ by batched "
                        "nested sampling (one lnZ column per source in "
                        "--summary)")
    g.add_argument("--ppc", action="store_true",
                   help="per-source posterior-predictive p-values")
    g.add_argument("--loo", action="store_true",
                   help="per-source WAIC + PSIS-LOO (stored in the batch "
                        "file)")
    g.add_argument("--nlive", type=int, default=512,
                   help="nested-sampling live points (default 512)")

    g = p.add_argument_group(
        "population (hierarchical hyper-inference over the fitted batch)")
    g.add_argument("--population", nargs="+", default=None, metavar="PARAM",
                   help="after the batch fit, infer the population "
                        "distribution of these free parameters (e.g. "
                        "'--population T beta'): box-truncated-normal "
                        "population via importance reweighting of the "
                        "stored per-source chains; prints the hyper-"
                        "posterior and writes the hyper chain "
                        "to --population-out")
    g.add_argument("--population-burn", type=int, default=200,
                   help="hyper-sampler burn-in steps (default 200)")
    g.add_argument("--population-steps", type=int, default=1000,
                   help="hyper-sampler production steps (default 1000)")
    g.add_argument("--population-walkers", type=int, default=64,
                   help="hyper-sampler walkers (default 64)")
    g.add_argument("--population-out", default=None, metavar="FILE",
                   help="hyper chain output (default: OUTFILE with "
                        ".pop.h5)")
    g.add_argument("--population-sigma-log-uniform", action="store_true",
                   help="scale-invariant (log-uniform) hyper-prior on the "
                        "population widths (default: uniform in sigma)")
    g.add_argument("--population-correlated", action="store_true",
                   help="bivariate population with a free correlation "
                        "rho (exactly two --population params): is the "
                        "catalog's T-beta trend a population property?")
    g.add_argument("--plot-population", default=None, metavar="PNG",
                   help="save the population-band figure (deconvolved "
                        "density over the per-source-median histogram; "
                        "one panel per --population parameter, suffixed "
                        "for >1)")

    g = p.add_argument_group("output")
    g.add_argument("--chunk-size", type=int, default=None, metavar="C",
                   help="process the catalog in fixed C-source chunks "
                        "(bounds host and device memory for huge catalogs; "
                        "every chunk keeps the batch shape, so the sampler "
                        "is built once). The final chunk overlaps the "
                        "previous one so it is exactly C sources. Writes "
                        "OUTFILE.partNNN.h5 per chunk")
    g.add_argument("--store-thin", type=int, default=1,
                   help="thin the STORED chains by this factor (summaries "
                        "printed here always use the full chain)")
    g.add_argument("--summary", action="store_true",
                   help="print a per-source summary table (median +/- "
                        "errors, R-hat)")

    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the batch fit "
                        "(a Chrome trace: open it in Perfetto)")
    return p


def _refuse_waiting_flags(args):
    for attr, flag, item in _WAITING:
        if getattr(args, attr):
            raise SystemExit(
                f"{flag} is not ported to mbb_emcee_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


def _safe_rhat(mf):
    """(S,) max split-R-hat per source, NaN when fewer than 4 steps are
    recorded (the file is still written and the summary printed)."""
    import numpy as np
    try:
        return mf.gelman_rubin().max(axis=1)
    except ValueError:
        return np.full(mf.nsources, np.nan)


def _summary_table(mf, offset=0, ppc=None):
    """Per-source lines: free-parameter medians +/- 1 sigma, split-R-hat,
    the stepping-stone lnZ after --pt, the nested lnZ after --get-evidence
    and, given a PPCBatchResult `ppc`, the posterior-predictive p-value;
    `offset` shifts the printed indices to catalog positions (chunks).
    Shared with cli_sed (getattr: a batch that never ran PT or the
    evidence may lack those attributes)."""
    names = mf.free_param_names
    cen = {p: mf.par_cen(p) for p in names}          # (S, 3) each
    rhat = _safe_rhat(mf)
    logz_pt = getattr(mf, "logz_pt", None)
    evidence = getattr(mf, "evidence", None)
    lines = ["#   source            " +
             "".join(f"{p:>24}" for p in names) + f"{'max-Rhat':>10}" +
             ("" if logz_pt is None else f"{'lnZ(PT)':>12}") +
             ("" if evidence is None else f"{'lnZ':>12}") +
             ("" if ppc is None else f"{'PPC p':>8}")]
    srcnames = mf.source_names or [f"src{i + offset}"
                                   for i in range(mf.nsources)]
    for i, nm in enumerate(srcnames):
        cells = "".join(
            f"  {cen[p][i, 0]:>10.4g} +{cen[p][i, 1]:.3g}/-{cen[p][i, 2]:.3g}"
            .rjust(24) for p in names)
        line = f"{i + offset:>3} {nm:<16}{cells}{rhat[i]:>10.3f}"
        if logz_pt is not None:
            line += f"{logz_pt[0][i]:>12.2f}"
        if evidence is not None:
            line += f"{evidence.logz[i]:>12.2f}"
        if ppc is not None:
            line += f"{ppc.p_value[i]:>8.3f}"
        lines.append(line)
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_waiting_flags(args)
    from mbb_emcee_tpu_torch.fitter import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    if importlib.util.find_spec("h5py") is None:
        raise SystemExit("writing the HDF5 output file needs h5py, which is "
                         "not installed")

    import logging
    from mbb_emcee_tpu_torch.catalog import read_catalog
    from mbb_emcee_tpu_torch.multifit import MultiFitter
    from mbb_emcee_tpu_torch.utils.log import enable_console

    cat = read_catalog(args.catalog)
    C = args.chunk_size
    if C is not None and C <= 0:
        raise SystemExit("--chunk-size must be positive")
    chunked = C is not None and C < cat.nsources
    if args.map:
        if (args.hmc or args.pt or args.extend_until is not None
                or args.init_map):
            raise SystemExit("--map is a triage mode; drop --hmc/--pt/"
                             "--extend-until/--init-map")
        if args.checkpoint or args.resume:
            raise SystemExit("--map runs in seconds; checkpointing does not "
                             "apply")
        if args.get_lir or args.get_dustmass or args.get_peaklambda \
                or args.get_evidence or args.ppc or args.loo \
                or args.population:
            raise SystemExit("derived-quantity posteriors, --ppc, --loo "
                             "and --population need chains; run without "
                             "--map for them")
    if args.hmc and args.pt:
        raise SystemExit("--hmc and --pt are mutually exclusive")
    if args.extend_until is not None and (args.hmc or args.pt):
        raise SystemExit("--extend-until works with the stretch-move "
                         "sampler only")
    if args.init_map and (args.hmc or args.pt or args.resume):
        raise SystemExit("--init-map seeds the stretch-move walker "
                         "ball; drop --hmc/--pt/--resume")
    if args.extend_until is not None:
        _validate_extend_flags(args)
    if (args.get_lir or args.get_dustmass) and not cat.has_redshifts:
        # before sampling: failing after the run would lose every chunk
        raise SystemExit("--get-lir/--get-dustmass need finite "
                         "redshifts in the catalog's z column")
    if args.population_correlated and (args.population is None
                                       or len(args.population) != 2):
        raise SystemExit("--population-correlated needs exactly two "
                         "--population parameters (e.g. "
                         "'--population T beta --population-correlated')")
    if chunked and args.population:
        raise SystemExit(
            "--population needs every source's chain at once; run it on "
            "an unchunked fit (or load the part files and call "
            "hierarchy.HierarchicalFitter yourself)")
    if chunked and (args.checkpoint or args.resume):
        raise SystemExit(
            "--chunk-size is not combinable with --checkpoint/--resume "
            "(chunks are already bounded; checkpoint a single-chunk run "
            "instead)")
    if ((args.responsefile is not None or args.builtin_responses)
            and cat.band_names is None):
        raise SystemExit(
            "response mode requires a 'bands = ...' header row in the "
            "catalog naming each column")
    responses = _responses(args, cat.band_names)

    mf = MultiFitter(nwalkers=args.nwalkers, wavenorm=args.wavenorm,
                     noalpha=args.noalpha, opthin=args.opthin,
                     responses=responses, seed=args.seed, a=args.stretch_a,
                     sampler_backend=args.sampler_backend,
                     device=args.device)
    # With --chunk-size only one C-source tile is bound at a time; the
    # first now, so data-dependent setters (the band correlation) work.
    first = slice(0, C) if chunked else slice(None)
    mf.set_data(cat.wave, cat.flux[first], cat.unc[first],
                band_names=cat.band_names,
                source_names=list(cat.names[first]),
                redshifts=cat.redshifts[first] if cat.has_redshifts
                else None)
    # None, shared (nb,), or per-source (S, nb) when the catalog used
    # '<flux' tokens; --phot-uplim bands OR in (broadcasting over sources)
    uplims = cat.uplim_mask()
    if args.phot_uplim:
        shared = _uplim_mask(args.phot_uplim, cat.wave.size,
                             cat.band_names)
        uplims = shared if uplims is None else (uplims | shared)
    if uplims is not None and uplims.any():
        mf.set_phot_upperlimits(
            uplims[first] if uplims.ndim == 2 else uplims)

    if args.corrfile is not None:
        from mbb_emcee_tpu_torch.utils.fits import read_band_correlation
        try:
            mf.set_band_correlation(
                read_band_correlation(args.corrfile, extn=args.corrextn))
        except ValueError as e:
            raise SystemExit(f"--corrfile: {e}")

    for param, v in args.initval:
        mf.set_param_init(param, float(v))
    for param, v in args.initscatter:
        mf.set_param_init(param, scatter=float(v))
    for param, v in args.lowlim:
        mf.set_lowlim(param, float(v))
    for param, v in args.uplim:
        mf.set_uplim(param, float(v))
    for param, v in args.fixed:
        mf.fix_param(param, float(v))
    for param, m, s in args.prior:
        mf.set_gaussian_prior(param, float(m), float(s))

    log = enable_console(logging.INFO if args.verbose else logging.WARNING)
    log.info(f"Device: {mf.device}")
    serve, what = ((_map_and_write, "MAP-triaged") if args.map
                   else (_fit_and_write, "served"))
    if not chunked:
        return serve(mf, args, log, args.outfile)
    return _serve_chunked(mf, cat, args, log, uplims, C, serve, what)


def _serve_chunked(mf, cat, args, log, uplims, C, serve_fn, what):
    """Fixed C-source tiles, so every chunk keeps the batch shape and reuses
    the sampler (the data are runtime operands). The final chunk OVERLAPS
    the previous one instead of padding, so every part holds real sources.
    `serve_fn(mf, args, log, outfile, offset)` fits whatever is bound (the
    MCMC or the MAP triage) and writes one part file."""
    import os

    import numpy as np

    starts = list(range(0, cat.nsources - C + 1, C))
    if starts[-1] + C < cat.nsources:
        starts.append(cat.nsources - C)
    base, ext = os.path.splitext(args.outfile)
    nb = cat.wave.size
    for ci, s0 in enumerate(starts):
        sl = slice(s0, s0 + C)
        if uplims is not None and uplims.ndim == 2 and uplims.any():
            # a per-source mask binds to source identities; clear before
            # re-binding data (set_data refuses a stale 2-D mask)
            mf.set_phot_upperlimits(np.zeros(nb, bool))
        mf.set_data(cat.wave, cat.flux[sl], cat.unc[sl],
                    band_names=cat.band_names,
                    source_names=list(cat.names[s0:s0 + C]),
                    redshifts=(cat.redshifts[sl]
                               if cat.has_redshifts else None))
        if uplims is not None and uplims.any():
            mf.set_phot_upperlimits(
                uplims[sl] if uplims.ndim == 2 else uplims)
        part = f"{base}.part{ci:03d}{ext or '.h5'}"
        log.info(f"chunk {ci + 1}/{len(starts)}: sources "
                 f"{s0}..{s0 + C - 1} -> {part}")
        serve_fn(mf, args, log, part, offset=s0)
    print(f"{cat.nsources} sources {what} in {len(starts)} chunks of {C} "
          f"(fixed batch shape; final chunk overlaps its predecessor) "
          f"-> {base}.part*{ext or '.h5'}")
    return 0


def _map_and_write(mf, args, log, outfile, offset=0):
    """MAP-triage the bound batch, write `outfile` (a MAPFit-only HDF5
    file) and print the per-source table; `offset` shifts the printed
    indices to catalog positions (chunks)."""
    t0 = time.perf_counter()
    mf.run_map(nstarts=args.map_starts, verbose=args.verbose)
    dt = time.perf_counter() - t0
    mf.write_map_h5(outfile)
    names = mf.free_param_names
    cols = {p: mf.map_cen(p) for p in names}   # (S, 2) each
    lines = ["#   source            "
             + "".join(f"{p:>20}" for p in names) + "      lnp  flag"]
    srcnames = (mf.source_names
                or [f"src{i + offset}" for i in range(mf.nsources)])
    for i, nm in enumerate(srcnames):
        cells = "".join(
            f"{cols[p][i, 0]:>12.4g} +-{cols[p][i, 1]:<.2g}".rjust(20)
            for p in names)
        flag = "" if mf.map_interior[i] else "edge"
        lines.append(f"{i + offset:>3} {nm:<16}{cells}"
                     f"{mf.map_lnprob[i]:>9.2f}  {flag}")
    print("\n".join(lines))
    n_edge = int((~mf.map_interior).sum())
    print(f"{mf.nsources} sources MAP-fit in {dt:.1f}s (host clock, "
          f"{args.map_starts} starts each); {n_edge} flagged 'edge' (run the "
          f"MCMC for those); written to {outfile}")
    return 0


def _report_checks(mf, args, offset):
    """--ppc / --loo lines after the batch fit."""
    import numpy as np
    if args.ppc:
        ppc = mf.posterior_predictive(thin=args.derived_thin)
        flagged = np.where(ppc.p_value < 0.01)[0]
        names = mf.source_names
        print(f"posterior predictive: median p "
              f"{np.median(ppc.p_value):.3f} over {mf.nsources} sources; "
              f"{flagged.size} with p < 0.01"
              + ("" if not flagged.size else ": " + ", ".join(
                  (names[i] if names is not None else f"src{i + offset}")
                  + f"={ppc.p_value[i]:.4f}" for i in flagged[:20])
                  + (" ..." if flagged.size > 20 else "")))
    if args.loo:
        loo = mf.compute_loo(thin=args.derived_thin)
        bad = np.where(loo.n_bad_k > 0)[0]
        print(f"PSIS-LOO: total elpd_loo {np.sum(loo.elpd_loo):.2f} over "
              f"{mf.nsources} sources (total p_loo "
              f"{np.sum(loo.p_loo):.1f}); {bad.size} source(s) with "
              f"unreliable tail fits (k-hat > 0.7)")


def _fit_and_write(mf, args, log, outfile, offset=0):
    """Fit the bound batch, run the --extend-until serving loop, compute
    the derived posteriors, write `outfile`, print the summary."""
    import numpy as np

    from mbb_emcee_tpu_torch.utils.profiling import trace

    log.info(f"Batch fit: {mf.nsources} sources x {args.nwalkers} walkers, "
             f"burn={args.burn}, steps={args.nsteps}")
    t0 = time.perf_counter()
    ck = dict(checkpoint=args.checkpoint,
              checkpoint_interval=args.checkpoint_interval,
              resume=args.resume)
    with trace(args.profile_dir, device=args.device):
        if args.pt:
            mf.run_pt(nrungs=args.pt_rungs,
                      beta_min=(args.pt_beta_min
                                if args.pt_beta_min is not None
                                else "auto"),
                      nburn=args.burn, nsteps=args.nsteps, thin=args.thin,
                      verbose=args.verbose, **ck)
        elif args.hmc:
            mf.run_hmc(nwarmup=args.burn, nsteps=args.nsteps, thin=args.thin,
                       n_leapfrog=args.hmc_leapfrog,
                       target_accept=args.hmc_target_accept,
                       verbose=args.verbose, **ck)
        else:
            if args.init_map:
                mf.run_map(nstarts=args.map_starts, verbose=args.verbose)
            mf.run(nburn=args.burn, nsteps=args.nsteps, thin=args.thin,
                   recenter_burn=not args.no_recenter_burn,
                   verbose=args.verbose,
                   init="map" if args.init_map else "auto", **ck)
        # actual updates; a resumed run skips the burn-in
        total = args.nsteps
        if not (args.resume and args.checkpoint):
            total += (args.burn if args.no_recenter_burn or args.pt or args.hmc
                      else 2 * args.burn)

        if args.extend_until is not None:
            step = args.extend_step or args.nsteps
            max_steps = args.max_steps or 10 * args.nsteps
            # Fixed window + floor stride: R-hat over the full chain span at a
            # fixed reduction shape as the chain grows.
            window = max(4, args.nsteps // max(args.thin, 1))

            def _converged():
                nrec = int(mf.chain_free.shape[1])
                return mf.converged(rhat_max=args.extend_until, window=window,
                                    stride=max(1, nrec // window),
                                    tau_mult=args.tau_mult)

            done = args.nsteps
            while done < max_steps:
                ok = _converged()
                n_bad = int(np.sum(~ok))
                if n_bad == 0:
                    break
                log.info(f"  {n_bad}/{mf.nsources} sources above full-span "
                         f"R-hat {args.extend_until}; extending by {step} "
                         f"steps")
                mf.extend(step, verbose=args.verbose)
                done += step
                total += step
            else:
                ok = _converged()
            log.info(f"serving loop done at {done} production steps: "
                     f"{int(np.sum(ok))}/{mf.nsources} sources converged")
    secs = time.perf_counter() - t0
    log.info(f"  batch fit: {total} steps in {secs:.2f}s "
             f"({mf.nsources * args.nwalkers * total / secs:,.0f} "
             f"walker-steps/s, host clock, build and first-call costs "
             f"included)")
    if args.profile_dir:
        log.info(f"profiler trace written to {args.profile_dir}")

    if args.get_evidence:
        ev = mf.compute_evidence(nlive=args.nlive, verbose=args.verbose)
        print(f"ln Z: median {np.median(ev.logz):.4f} over "
              f"{mf.nsources} sources (median err "
              f"{np.median(ev.logz_err):.4f})")

    if args.get_lir:
        mf.compute_lir(wavemin=args.lir_wavemin, wavemax=args.lir_wavemax,
                       thin=args.derived_thin, cosmology=args.cosmology)
    if args.get_dustmass:
        mf.compute_dustmass(kappa=args.kappa, kappa_wave=args.kappa_wave,
                            thin=args.derived_thin,
                            cosmology=args.cosmology)
    if args.get_peaklambda:
        mf.compute_peaklambda(thin=args.derived_thin)
    _report_checks(mf, args, offset)

    mf.writeToHDF5(outfile, thin=args.store_thin)
    if args.summary:
        print(_summary_table(mf, offset=offset))
    else:
        rhat = _safe_rhat(mf)
        print(f"{mf.nsources} sources fit; max split-R-hat "
              f"{rhat.max():.3f} (median {np.median(rhat):.3f}); "
              f"batch written to {outfile}")
    if args.population:
        # the population stage runs AFTER the batch file is on disk: its
        # failure must not lose the fits
        from mbb_emcee_tpu_torch.hierarchy import run_population_stage
        print(run_population_stage(mf, args, outfile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
