"""Serve a catalog with a USER-DEFINED SED model from the shell:
run_sed_tpu_torch.

    run_sed_tpu_torch mymodel.py catalog.txt out.h5 -w 128 -b 200 -n 600 \\
        --extend-until 1.05 --get-lir --get-peaklambda --ppc --summary

Torch twin of mbb_emcee_tpu/cli_sed.py. `mymodel.py` is any Python file
defining a module-level `MODEL` (an `mbb_emcee_tpu_torch.SEDModel`, whose
fnu is written in torch; pass `mymodel.py:NAME` for a different attribute;
examples/*_torch.py ship three). The catalog format is the batch CLI's
(catalog.py): a 'wave = ...' header, optional 'bands = ...' naming row,
then one 'name z flux unc ...' row per source -- `nan nan` marks a missing
band and `<value` a per-source upper limit.

This is the generic-model analog of run_mbb_emcee_tpu_torch_batch
(sedmulti.SEDMultiFitter underneath, on the plain batch stretch step: the
hand-written kernels are specialized to the 5-parameter MBB, so this path
launches none of them): the extend-until-converged serving loop, batched
HMC/PT tiers, MAP triage + map-seeded runs, per-source derived posteriors
and the PPC sweep, mid-run checkpoint/resume and the --population stage.
Parameters are addressed by the MODEL's own names (--prior T_cold 18 2).
The flags are the JAX CLI's plus --device (default cuda; --device cpu runs
the plain torch path on the CPU); --mesh-devices exits non-zero with the
ROADMAP.md item that carries it. The output files are the JAX package's
kind='sed-batch' and kind='sed-map' layouts, which either package reads.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from typing import NamedTuple

# Flags of the JAX package's generic CLI whose features wait, and the
# ROADMAP.md queue-A item that carries each.
_WAITING = (
    ("mesh_devices", "--mesh-devices", "A11"),
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="run_sed_tpu_torch",
        description="Fit a catalog with a user-defined torch SED model "
                    "(module-level SEDModel), batched on a CUDA GPU or the "
                    "CPU.")
    p.add_argument("modelfile",
                   help="Python file defining the SEDModel (module-level "
                        "MODEL; use 'file.py:ATTR' for another name)")
    p.add_argument("catalog", help="catalog file ('wave = ...' header + "
                                   "'name z flux unc ...' rows)")
    p.add_argument("outfile", help="output HDF5 (reload with "
                                   "SEDMultiFitter.from_h5 + the model)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to fit (default: cuda; --device cpu runs the "
                        "plain torch path on the CPU)")

    g = p.add_argument_group("sampler")
    g.add_argument("-w", "--nwalkers", type=int, default=250)
    g.add_argument("-b", "--burn", type=int, default=50,
                   help="burn-in steps (run twice around the re-center)")
    g.add_argument("-n", "--nsteps", type=int, default=250,
                   help="recorded production steps")
    g.add_argument("--thin", type=int, default=1)
    g.add_argument("--no-recenter-burn", action="store_true")
    g.add_argument("--seed", type=int, default=207)
    g.add_argument("--stretch-a", type=float, default=2.0)
    g.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="shard the source axis over an N-device mesh")
    g.add_argument("--checkpoint", default=None,
                   help="flush complete state here every "
                        "--checkpoint-interval records (bitwise resume)")
    g.add_argument("--checkpoint-interval", type=int, default=100)
    g.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from --checkpoint")
    g.add_argument("--hmc", action="store_true",
                   help="gradient-based HMC instead of the stretch move")
    g.add_argument("--hmc-leapfrog", type=int, default=16)
    g.add_argument("--hmc-target-accept", type=float, default=0.8)
    g.add_argument("--pt", action="store_true",
                   help="parallel tempering (multimodal posteriors; also "
                        "yields per-source stepping-stone lnZ)")
    g.add_argument("--pt-rungs", type=int, default=12)
    g.add_argument("--pt-beta-min", type=float, default=None,
                   help="coldest inverse temperature (default: per-source "
                        "auto ladders)")
    g.add_argument("--map", action="store_true",
                   help="MAP + Laplace triage only (no MCMC): mode, error "
                        "bars, interior flags per source")
    g.add_argument("--map-starts", type=int, default=8)
    g.add_argument("--init-map", action="store_true",
                   help="run the MAP triage first and seed each source's "
                        "walker ball at its own mode")

    g = p.add_argument_group("serving loop")
    g.add_argument("--extend-until", type=float, default=None,
                   metavar="RHAT",
                   help="extend until every source's split-R-hat is below "
                        "RHAT")
    g.add_argument("--extend-step", type=int, default=None)
    g.add_argument("--max-steps", type=int, default=None)
    g.add_argument("--tau-mult", type=float, default=None,
                   help="additionally require chain length >= TAU_MULT x "
                        "the autocorrelation time")

    g = p.add_argument_group(
        "parameters", "addressed by the MODEL's parameter names")
    g.add_argument("--initval", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--initscatter", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--lowlim", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--uplim", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--fixed", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"))
    g.add_argument("--prior", nargs=3, action="append", default=[],
                   metavar=("PARAM", "MEAN", "SIGMA"))

    g = p.add_argument_group("data")
    g.add_argument("--responsefile", default=None,
                   help="filter list file enabling response-integrated "
                        "band fluxes (catalog needs a 'bands = ...' row)")
    g.add_argument("--responsedir", default=None)
    g.add_argument("--builtin-responses", action="store_true",
                   help="resolve the catalog's bands against the built-in "
                        "instrument library")
    g.add_argument("--photon-counter", action="store_true")
    g.add_argument("--phot-uplim", action="append", default=[],
                   metavar="BAND",
                   help="flag this band (name or index) as an upper limit "
                        "for every source (repeatable)")
    g.add_argument("--corrfile", default=None,
                   help="FITS image holding a shared (nb, nb) band "
                        "CORRELATION matrix (a covariance is normalized "
                        "to its correlation): each source samples under "
                        "C_s = D_s R D_s with its own unc scales "
                        "(set_band_correlation); incompatible with "
                        "upper-limit flags")
    g.add_argument("--corrextn", type=int, default=0,
                   help="FITS extension of --corrfile (default 0)")

    g = p.add_argument_group("derived quantities")
    g.add_argument("--cosmology", default="WMAP9")
    g.add_argument("--get-lir", action="store_true",
                   help="per-source L_IR posteriors (needs catalog z, "
                        "or --lir-zparam for photo-z models)")
    g.add_argument("--lir-wavemin", type=float, default=8.0)
    g.add_argument("--lir-wavemax", type=float, default=1000.0)
    g.add_argument("--lir-zparam", metavar="PARAM", default=None,
                   help="marginalize L_IR over a SAMPLED redshift "
                        "parameter (photo-z models, e.g. 'z') instead "
                        "of catalog redshifts")
    g.add_argument("--get-dustmass", action="store_true",
                   help="per-source dust-mass posteriors marginalized "
                        "over the sampled z (photo-z MBB models only; "
                        "photoz.compute_dustmass_batch)")
    g.add_argument("--anchor-z", type=float, metavar="SIGMA",
                   default=None,
                   help="per-source Gaussian prior on the model's "
                        "sampled 'z' parameter centered on the CATALOG "
                        "z column with this sigma; rows with non-finite "
                        "catalog z stay free (mixed spec-z/photo-z "
                        "catalogs in one batch)")
    g.add_argument("--get-peaklambda", action="store_true")
    g.add_argument("--derived-thin", type=int, default=1)
    g.add_argument("--get-evidence", action="store_true",
                   help="per-source nested-sampling lnZ (difference two "
                        "runs for per-source Bayes factors between model "
                        "variants)")
    g.add_argument("--nlive", type=int, default=512)
    g.add_argument("--ppc", action="store_true",
                   help="per-source posterior-predictive p-values (which "
                        "sources does the model NOT describe?)")
    g.add_argument("--loo", action="store_true",
                   help="batched WAIC + PSIS-LOO predictive assessment "
                        "(difference two model variants' per-source "
                        "elpd_loo on the same catalog)")

    g = p.add_argument_group(
        "population (hierarchical hyper-inference over the fitted batch)")
    g.add_argument("--population", nargs="+", default=None, metavar="PARAM",
                   help="after the fit, infer the population distribution "
                        "of these free parameters (model's own names); "
                        "hyper chain written to --population-out")
    g.add_argument("--population-burn", type=int, default=200)
    g.add_argument("--population-steps", type=int, default=1000)
    g.add_argument("--population-walkers", type=int, default=64)
    g.add_argument("--population-out", default=None, metavar="FILE",
                   help="hyper-chain HDF5 (default: OUTFILE + .pop.h5)")
    g.add_argument("--population-sigma-log-uniform", action="store_true")
    g.add_argument("--population-correlated", action="store_true",
                   help="bivariate population with a free correlation "
                        "(exactly two --population params)")
    g.add_argument("--plot-population", default=None, metavar="PNG",
                   help="save the population-band figure (deconvolved "
                        "density over the per-source-median histogram; "
                        "one panel per --population parameter, suffixed "
                        "for >1)")

    g = p.add_argument_group("output")
    g.add_argument("--summary", action="store_true",
                   help="per-source summary table")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _is_jax_sed_model(obj):
    """Whether `obj` is an SEDModel of the JAX package, told by the module
    of its class (or a base class), without importing that package."""
    return any(c.__name__ == "SEDModel"
               and c.__module__.split(".")[0] == "mbb_emcee_tpu"
               for c in type(obj).__mro__)


def load_model(spec):
    """'file.py' or 'file.py:ATTR' -> the torch SEDModel it defines."""
    import os
    from mbb_emcee_tpu_torch.sed import SEDModel

    path, _, attr = spec.partition(":")
    attr = attr or "MODEL"
    if not os.path.exists(path):
        raise SystemExit(f"model file {path!r} not found")
    name = os.path.splitext(os.path.basename(path))[0]
    modspec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(modspec)
    try:
        modspec.loader.exec_module(mod)
    except Exception as e:
        raise SystemExit(f"importing {path!r} failed: {e}")
    model = getattr(mod, attr, None)
    if model is None:
        raise SystemExit(
            f"{path!r} defines no attribute {attr!r}; define a "
            f"module-level SEDModel named MODEL (or pass file.py:NAME)")
    if _is_jax_sed_model(model):
        raise SystemExit(
            f"{path}:{attr} is a JAX SEDModel (mbb_emcee_tpu); "
            f"run_sed_tpu_torch needs a torch model file defining an "
            f"mbb_emcee_tpu_torch.SEDModel -- see the torch twins "
            f"examples/two_temp_model_torch.py, "
            f"examples/cmb_high_z_model_torch.py and "
            f"examples/photoz_model_torch.py")
    if not isinstance(model, SEDModel):
        raise SystemExit(
            f"{path}:{attr} is {type(model).__name__}, not an SEDModel")
    return model


def _refuse_waiting_flags(args):
    for attr, flag, item in _WAITING:
        if getattr(args, attr) is not None:
            raise SystemExit(
                f"{flag} is not ported to mbb_emcee_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


def _summary(mf, ppc=None):
    # the batch CLI's table is the single implementation (it carries
    # the NaN-R-hat fallback and the lnZ/PPC column rules)
    from mbb_emcee_tpu_torch.cli_batch import _summary_table
    return _summary_table(mf, ppc=ppc)


class SEDFit(NamedTuple):
    """What fit() leaves for main() to write: the parsed arguments, the
    model, the fitted SEDMultiFitter (MAP-triaged only under --map) and the
    --ppc result (None without --ppc)."""
    args: argparse.Namespace
    model: object
    mf: object
    ppc: object


def _validate(args, model, mf):
    """Every flag combination main() refuses, checked before sampling (a
    bad combination found after the production run would abort before the
    output file is written and lose the fit)."""
    from mbb_emcee_tpu_torch.cli import _validate_extend_flags
    if args.hmc and args.pt:
        raise SystemExit("--hmc and --pt are mutually exclusive")
    if args.lir_zparam is not None:
        try:
            model.param_index(args.lir_zparam)
        except ValueError as e:
            raise SystemExit(f"--lir-zparam: {e}")
    if args.get_dustmass:
        from mbb_emcee_tpu_torch.photoz import PhotoZMBBModel
        if not isinstance(model, PhotoZMBBModel):
            raise SystemExit(
                "--get-dustmass applies to photo-z MBB models "
                "(photoz_mbb); for fixed-z MBB catalogs use the batch "
                "MBB CLI's --get-dustmass")
    if args.population_correlated and (args.population is None
                                       or len(args.population) != 2):
        raise SystemExit("--population-correlated needs exactly two "
                         "--population parameters")
    if args.extend_until is not None and (args.hmc or args.pt):
        raise SystemExit("--extend-until works with the stretch-move "
                         "sampler only")
    if args.extend_until is not None:
        _validate_extend_flags(args)
    if (args.get_lir and args.lir_zparam is None
            and mf.redshifts is None):
        raise SystemExit(
            "--get-lir needs finite redshifts in the catalog's z column "
            "(or --lir-zparam for photo-z models)")
    if args.init_map and (args.hmc or args.pt or args.resume):
        raise SystemExit("--init-map seeds the stretch-move walker "
                         "ball; drop --hmc/--pt/--resume")
    if args.map:
        if (args.hmc or args.pt or args.extend_until is not None
                or args.init_map or args.checkpoint or args.resume):
            raise SystemExit("--map is a triage mode; drop --hmc/--pt/"
                             "--extend-until/--init-map/--checkpoint")
        if (args.get_lir or args.get_peaklambda or args.get_evidence
                or args.get_dustmass or args.ppc or args.loo
                or args.population):
            raise SystemExit("derived-quantity posteriors, --ppc, --loo "
                             "and --population need chains; run without "
                             "--map for them")


def _anchor_z(args, model, mf, cat):
    """--anchor-z: the catalog z column as a per-source Gaussian prior on
    the model's sampled 'z' (sigma inf, i.e. off, where z is not finite)."""
    import numpy as np
    if args.anchor_z <= 0:
        raise SystemExit("--anchor-z sigma must be positive")
    try:
        zi = model.param_index("z")
    except ValueError:
        raise SystemExit(
            f"--anchor-z needs a sampled 'z' parameter; model "
            f"{model.name!r} has none (photo-z models: photoz_mbb)")
    # cat.redshifts keeps NaN where unknown (mixed catalogs), which is
    # exactly the per-source prior's "off" encoding.
    zcat = np.asarray(cat.redshifts, np.float64)
    if not np.isfinite(zcat).any():
        raise SystemExit(
            "--anchor-z needs at least one finite redshift in the "
            "catalog's z column")
    on = np.isfinite(zcat)
    zlo, zhi = float(model.lower[zi]), float(model.upper[zi])
    bad = on & ((zcat < zlo) | (zcat > zhi))
    if bad.any():
        b = int(np.argwhere(bad)[0, 0])
        raise SystemExit(
            f"--anchor-z: catalog z={zcat[b]:g} (source index {b}) "
            f"lies outside the model's z box [{zlo:g}, {zhi:g}] -- "
            f"the anchored walkers would pile up at the boundary; "
            f"widen the model's z_upper/z_lower or fix the catalog")
    mf.set_gaussian_prior(
        "z", np.where(on, zcat, 0.0),
        np.where(on, float(args.anchor_z), np.inf))


def _serve_until_converged(args, mf, log):
    """The --extend-until loop: extend every source by --extend-step until
    each one's split-R-hat (over a fixed window with a floor stride, so the
    reduction keeps its shape as the chain grows) is below the threshold,
    or --max-steps production steps are reached."""
    import numpy as np
    step = args.extend_step or args.nsteps
    max_steps = args.max_steps or 10 * args.nsteps
    window = max(4, args.nsteps // max(args.thin, 1))

    def _converged():
        nrec = int(mf.chain_free.shape[1])
        return mf.converged(rhat_max=args.extend_until, window=window,
                            stride=max(1, nrec // window),
                            tau_mult=args.tau_mult)

    total = args.nsteps
    while total < max_steps:
        n_bad = int(np.sum(~_converged()))
        if n_bad == 0:
            break
        log.info(f"  {n_bad}/{mf.nsources} sources above R-hat "
                 f"{args.extend_until}; extending by {step}")
        mf.extend(step, verbose=args.verbose)
        total += step


def _map_triage(args, model, mf):
    """--map: the batched MAP + Laplace triage and its printed table."""
    mf.run_map(nstarts=args.map_starts, verbose=args.verbose)
    names = mf.free_param_names
    n_bad = int((~mf.map_interior).sum())
    print(f"MAP triage [{model.name}]: {mf.nsources} sources x "
          f"{args.map_starts} starts; {n_bad} modes at a box edge "
          f"(run the MCMC for those)")
    if args.summary:
        srcnames = mf.source_names or [f"src{i}" for i in
                                       range(mf.nsources)]
        cols = {p: mf.map_cen(p) for p in names}
        for i, nm in enumerate(srcnames):
            cells = "  ".join(
                f"{p}={cols[p][i, 0]:.4g}+/-{cols[p][i, 1]:.3g}"
                for p in names)
            flag = "" if mf.map_interior[i] else "  [edge]"
            print(f"{i:>3} {nm:<16}{cells}{flag}")


def _derived(args, model, mf):
    """--get-evidence / --get-lir / --get-dustmass / --get-peaklambda /
    --ppc / --loo after the fit; returns the PPC result (or None)."""
    import numpy as np
    if args.get_evidence:
        ev = mf.compute_evidence(nlive=args.nlive, verbose=args.verbose)
        print(f"ln Z [{model.name}]: median {np.median(ev.logz):.4f} "
              f"over {mf.nsources} sources (median err "
              f"{np.median(ev.logz_err):.4f})")
    if args.get_lir:
        # preconditions validated before the run (_validate)
        mf.compute_lir(wavemin=args.lir_wavemin, wavemax=args.lir_wavemax,
                       thin=args.derived_thin, cosmology=args.cosmology,
                       z_param=args.lir_zparam)
    if args.get_dustmass:
        from mbb_emcee_tpu_torch.photoz import compute_dustmass_batch
        compute_dustmass_batch(mf, thin=args.derived_thin,
                               cosmology=args.cosmology)
    if args.get_peaklambda:
        mf.compute_peaklambda(thin=args.derived_thin)
    ppc = None
    if args.ppc:
        ppc = mf.posterior_predictive(thin=args.derived_thin)
        flagged = np.where(ppc.p_value < 0.01)[0]
        print(f"posterior predictive [{model.name}]: median p "
              f"{np.median(ppc.p_value):.3f} over {mf.nsources} sources; "
              f"{flagged.size} flagged p<0.01")
    if args.loo:
        loo = mf.compute_loo(thin=args.derived_thin)
        bad = np.where(loo.n_bad_k > 0)[0]
        print(f"PSIS-LOO [{model.name}]: total elpd_loo "
              f"{np.sum(loo.elpd_loo):.2f} over {mf.nsources} sources "
              f"(total p_loo {np.sum(loo.p_loo):.1f}); {bad.size} "
              f"source(s) with unreliable tail fits (k-hat > 0.7)")
    return ppc


def fit(argv=None):
    """The fit stage of run_sed_tpu_torch: parse `argv`, load the model and
    the catalog, validate every flag, then run the MAP triage (--map) or
    the sampler, the --extend-until loop and the derived posteriors and
    checks, printing what the JAX CLI prints up to that point. Writes no
    file (a --checkpoint aside). Returns an SEDFit for main() to write."""
    args = build_parser().parse_args(argv)
    _refuse_waiting_flags(args)
    from mbb_emcee_tpu_torch.fitter import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None

    import logging
    from mbb_emcee_tpu_torch.catalog import read_catalog
    from mbb_emcee_tpu_torch.cli import _responses, _uplim_mask
    from mbb_emcee_tpu_torch.sedmulti import SEDMultiFitter
    from mbb_emcee_tpu_torch.utils.log import enable_console

    log = enable_console(logging.INFO if args.verbose else logging.WARNING)
    model = load_model(args.modelfile)
    cat = read_catalog(args.catalog)
    if ((args.responsefile is not None or args.builtin_responses)
            and cat.band_names is None):
        raise SystemExit(
            "response mode requires a 'bands = ...' header row in the "
            "catalog")
    responses = _responses(args, cat.band_names)

    mf = SEDMultiFitter(model, nwalkers=args.nwalkers, seed=args.seed,
                        a=args.stretch_a, device=args.device)
    if responses is not None:
        mf.set_responses(responses)
    mf.set_data(cat.wave, cat.flux, cat.unc, band_names=cat.band_names,
                source_names=list(cat.names),
                redshifts=cat.redshifts if cat.has_redshifts else None)
    uplims = cat.uplim_mask()
    if args.phot_uplim:
        shared = _uplim_mask(args.phot_uplim, cat.wave.size,
                             cat.band_names)
        uplims = shared if uplims is None else (uplims | shared)
    if uplims is not None and uplims.any():
        mf.set_phot_upperlimits(uplims)

    if args.corrfile is not None:
        from mbb_emcee_tpu_torch.utils.fits import read_band_correlation
        try:
            mf.set_band_correlation(
                read_band_correlation(args.corrfile, extn=args.corrextn))
        except ValueError as e:
            raise SystemExit(f"--corrfile: {e}")

    try:
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
    except ValueError as e:
        raise SystemExit(str(e))
    if args.anchor_z is not None:
        _anchor_z(args, model, mf, cat)
    _validate(args, model, mf)

    log.info(f"Device: {mf.device}")
    if args.map:
        _map_triage(args, model, mf)
        return SEDFit(args, model, mf, None)

    log.info(f"SED batch fit [{model.name}]: {mf.nsources} sources x "
             f"{args.nwalkers} walkers, burn={args.burn}, "
             f"steps={args.nsteps}")
    ck = dict(verbose=args.verbose, checkpoint=args.checkpoint,
              checkpoint_interval=args.checkpoint_interval,
              resume=args.resume)
    if args.pt:
        mf.run_pt(nrungs=args.pt_rungs,
                  beta_min=(args.pt_beta_min
                            if args.pt_beta_min is not None else "auto"),
                  nburn=args.burn, nsteps=args.nsteps, thin=args.thin, **ck)
    elif args.hmc:
        mf.run_hmc(nwarmup=args.burn, nsteps=args.nsteps, thin=args.thin,
                   n_leapfrog=args.hmc_leapfrog,
                   target_accept=args.hmc_target_accept, **ck)
    else:
        if args.init_map:
            mf.run_map(nstarts=args.map_starts, verbose=args.verbose)
        mf.run(nburn=args.burn, nsteps=args.nsteps, thin=args.thin,
               recenter_burn=not args.no_recenter_burn,
               init="map" if args.init_map else "auto", **ck)
    if args.extend_until is not None:
        _serve_until_converged(args, mf, log)
    return SEDFit(args, model, mf, _derived(args, model, mf))


def _write_map(path, model, mf):
    """The --map artifact: the JAX CLI's kind='sed-map' file."""
    import h5py
    import numpy as np
    with h5py.File(path, "w") as f:
        f.attrs["kind"] = "sed-map"
        f.attrs["model_name"] = model.name.encode()
        f.attrs["param_names"] = np.array(
            [n.encode() for n in model.param_names])
        f.create_dataset("Params", data=mf.map_params)
        f.create_dataset("LnProb", data=mf.map_lnprob)
        f.create_dataset("Sigma", data=mf.map_sigma)
        f.create_dataset("Cov", data=mf.map_cov)
        f.create_dataset("Interior", data=mf.map_interior)


def main(argv=None):
    if importlib.util.find_spec("h5py") is None:
        raise SystemExit("writing the HDF5 output file needs h5py, which is "
                         "not installed")
    args, model, mf, ppc = fit(argv)
    if args.map:
        _write_map(args.outfile, model, mf)
        return 0

    mf.writeToHDF5(args.outfile)
    if args.summary:
        print(_summary(mf, ppc=ppc))
    elif not args.verbose:
        cen = mf.par_cen(mf.free_param_names[0])
        print(f"fit {mf.nsources} sources [{model.name}]; "
              f"{mf.free_param_names[0]} medians "
              f"{cen[:, 0].min():.4g}-{cen[:, 0].max():.4g} -> "
              f"{args.outfile}")

    if args.population:
        # after the batch file is safely on disk (same rule as the MBB
        # batch CLI; one shared stage implementation)
        from mbb_emcee_tpu_torch.hierarchy import run_population_stage
        print(run_population_stage(mf, args, args.outfile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
