"""Command-line entry point: run_mbb_emcee_tpu_torch.

The flags of mbb_emcee_tpu/cli.py (positional photometry file + output
HDF5, sampler geometry, model shape, per-parameter limits / priors / initial
values / fixing, covariance file, instrument-response mode, checkpoint /
resume, the --extend-until serving loop, derived-quantity switches, MAP
triage (--map, --init-map), model checking (--ppc, --loo, --loo-exact),
Hamiltonian MC (--hmc), parallel tempering (--pt) and the nested-sampling
evidence (--get-evidence)) plus --device
(default cuda; --device cpu runs the plain torch path).
Flags whose features are not ported yet exit non-zero up front with the
ROADMAP.md item that carries them.

Usage example:
    run_mbb_emcee_tpu_torch phot.txt fit.h5 -z 2.2 --nwalkers 250 -b 100 \
        -n 500 --get-lir --get-dustmass --get-peaklambda --device cuda
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time

from mbb_emcee_tpu_torch.constants import PARAM_NAMES

# Flags of the JAX package's CLI whose features wait, and the ROADMAP.md
# queue-A item that carries each.
_WAITING = (
    ("plot_sed", "--plot-sed", "A10b"),
    ("plot_corner", "--plot-corner", "A10b"),
    ("plot_chain", "--plot-chain", "A10b"), ("plot_ppc", "--plot-ppc", "A10b"),
    ("profile_dir", "--profile-dir", "A8"),
)


def _validate_extend_flags(args):
    """--extend-until sanity, shared with the batch CLI and checked BEFORE
    sampling, so a bad flag cannot lose a finished run: split-R-hat needs
    >= 4 recorded steps per pass, and extend() continues with the
    production thin, so the extension length must be positive and
    divisible by it."""
    thin = max(args.thin, 1)
    if args.nsteps // thin < 4:
        raise SystemExit(
            f"--extend-until needs at least 4 recorded steps per pass; "
            f"--nsteps {args.nsteps} / --thin {args.thin} records only "
            f"{args.nsteps // thin}")
    step = args.extend_step if args.extend_step is not None else args.nsteps
    if step <= 0:
        raise SystemExit(f"--extend-step must be positive; got {step}")
    if step % thin:
        raise SystemExit(
            f"--extend-step {step} must be divisible by --thin {thin} "
            f"(extensions record every thin-th step)")
    if args.max_steps is not None and args.max_steps <= 0:
        raise SystemExit("--max-steps must be positive")


def build_parser():
    p = argparse.ArgumentParser(
        prog="run_mbb_emcee_tpu_torch",
        description="Fit a modified blackbody to photometry with an "
                    "affine-invariant MCMC ensemble sampler on a CUDA GPU "
                    "(PyTorch + hand-written CUDA kernels) or the CPU.")
    p.add_argument("photfile", help="text photometry: '[band] wave_um "
                                    "flux_mJy unc_mJy' per line")
    p.add_argument("outfile", help="output HDF5 file")
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
                   help="skip the re-center-on-best-walker re-burn phase")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--n-ensembles", type=int, default=1,
                   help="run this many independent ensembles through the "
                        "batch tier (one multi-source kernel launch per "
                        "phase on cuda) and merge their chains; diagonal "
                        "uncertainties only")
    g.add_argument("--stretch-a", type=float, default=2.0,
                   help="stretch-move scale parameter a (default 2)")
    g.add_argument("--nthreads", type=int, default=None,
                   help="accepted for reference compatibility; ignored")
    g.add_argument("--checkpoint", default=None,
                   help="HDF5 file to flush chain + sampler state to during "
                        "the production run")
    g.add_argument("--checkpoint-interval", type=int, default=100,
                   help="recorded steps between checkpoint flushes")
    g.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from --checkpoint")
    g.add_argument("--sampler-backend", choices=["auto", "torch", "fused"],
                   default="auto",
                   help="'fused' runs each sampling phase as one CUDA "
                        "kernel launch; 'torch' is the plain torch sampler; "
                        "'auto' (default) is fused on cuda, torch on cpu")
    g.add_argument("--hmc", action="store_true",
                   help="sample with gradient-based Hamiltonian MC instead "
                        "of the stretch move (torch.autograd of the plain "
                        "likelihood; --burn becomes the warmup length)")
    g.add_argument("--hmc-leapfrog", type=int, default=16,
                   help="leapfrog steps per HMC trajectory (default 16)")
    g.add_argument("--hmc-target-accept", type=float, default=0.8,
                   help="dual-averaging target acceptance (default 0.8)")
    g.add_argument("--pt", action="store_true",
                   help="parallel tempering: K temperature rungs with "
                        "replica exchange (mixes the T-lambda0 bimodality "
                        "of optically thick fits; also reports the "
                        "stepping-stone and thermodynamic-integration lnZ)")
    g.add_argument("--pt-rungs", type=int, default=12,
                   help="temperature rungs for --pt (default 12)")
    g.add_argument("--pt-beta-min", type=float, default=None,
                   help="hottest nonzero inverse temperature (default: "
                        "auto -- sized after burn-in so the evidence "
                        "ladder bridges the prior box)")
    g.add_argument("--map", action="store_true",
                   help="MAP + Laplace triage only (seconds, no MCMC): "
                        "prints the mode and its error bars and writes a "
                        "MAPFit-only HDF5 file")
    g.add_argument("--map-starts", type=int, default=8,
                   help="optimizer starts for --map / --init-map")
    g.add_argument("--init-map", action="store_true",
                   help="seed the walker ball at the MAP mode with ~2 "
                        "Laplace-sigma scatter (triage-then-refine)")

    g = p.add_argument_group(
        "serving loop",
        "run-until-converged: after the production run, keep extending "
        "until split-R-hat is below the threshold (same flags as the batch "
        "CLI)")
    g.add_argument("--extend-until", type=float, default=None,
                   metavar="RHAT",
                   help="extend production until max split-R-hat < RHAT "
                        "(e.g. 1.05)")
    g.add_argument("--extend-step", type=int, default=None,
                   help="steps per extension (default: --nsteps)")
    g.add_argument("--max-steps", type=int, default=None,
                   help="stop extending after this many total production "
                        "steps (default: 10x --nsteps)")
    g.add_argument("--tau-mult", type=float, default=None,
                   help="additionally require recorded chain length >= "
                        "TAU_MULT x the integrated autocorrelation time")

    g = p.add_argument_group("model")
    g.add_argument("--opthin", action="store_true",
                   help="optically thin model (drops lambda0)")
    g.add_argument("--noalpha", action="store_true",
                   help="no Wien-side power-law merge (drops alpha)")
    g.add_argument("--wavenorm", type=float, default=500.0,
                   help="observer-frame normalization wavelength, um")

    g = p.add_argument_group("parameters",
                             f"PARAM is one of {', '.join(PARAM_NAMES)}")
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
    g.add_argument("--covfile", default=None,
                   help="FITS file with a photometric covariance matrix")
    g.add_argument("--covextn", type=int, default=0,
                   help="FITS extension of the covariance (default 0)")
    g.add_argument("--cov-is-total", action="store_true",
                   help="covariance already includes diag(unc^2)")
    g.add_argument("--responsefile", default=None,
                   help="filter list file ('band spec' lines) enabling "
                        "response-integrated fluxes")
    g.add_argument("--responsedir", default=None,
                   help="directory filter files are relative to")
    g.add_argument("--builtin-responses", action="store_true",
                   help="resolve the photometry band names against the "
                        "built-in instrument library (PACS_70/100/160, "
                        "SPIRE_250/350/500, SCUBA2_450/850, ...) and fit "
                        "with response-integrated fluxes")
    g.add_argument("--photon-counter", action="store_true",
                   help="photon-counting detector convention for responses")
    g.add_argument("--phot-uplim", action="append", default=[],
                   metavar="BAND",
                   help="flag this photometry band (name or 0-based "
                        "index) as an UPPER LIMIT (repeatable)")

    g = p.add_argument_group("derived quantities")
    g.add_argument("-z", "--redshift", type=float, default=None)
    g.add_argument("--cosmology", default="WMAP9",
                   help="named cosmology (WMAP5/7/9, Planck13/15/18)")
    g.add_argument("--lumdist", type=float, default=None,
                   help="explicit luminosity distance in Mpc")
    g.add_argument("--get-lir", action="store_true",
                   help="compute L_IR(8-1000um rest) posterior")
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
    g.add_argument("--ppc", action="store_true",
                   help="posterior-predictive goodness-of-fit check")
    g.add_argument("--loo", action="store_true",
                   help="WAIC + PSIS-LOO predictive assessment (stored in "
                        "the output file)")
    g.add_argument("--loo-exact", action="store_true",
                   help="--loo, then refit without each band whose PSIS "
                        "k-hat exceeds 0.7 (diagonal errors only)")
    g.add_argument("--get-evidence", action="store_true",
                   help="also compute the Bayesian evidence lnZ by nested "
                        "sampling over the parameter box (compare two runs' "
                        "lnZ for a Bayes factor between model variants)")
    g.add_argument("--nlive", type=int, default=512,
                   help="nested-sampling live points (default 512)")

    g = p.add_argument_group("plots")
    g.add_argument("--plot-sed", default=None, metavar="PNG")
    g.add_argument("--plot-corner", default=None, metavar="PNG")
    g.add_argument("--plot-chain", default=None, metavar="PNG")
    g.add_argument("--plot-ppc", default=None, metavar="PNG")

    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile-dir", default=None)
    return p


def _refuse_waiting_flags(args):
    for attr, flag, item in _WAITING:
        if getattr(args, attr):
            raise SystemExit(
                f"{flag} is not ported to mbb_emcee_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


def _uplim_mask(specs, nbands, band_names):
    """Resolve repeated --phot-uplim values (band name or 0-based index)
    into an (nbands,) boolean mask; names match first."""
    import numpy as np
    mask = np.zeros(nbands, bool)
    for b in specs:
        if band_names is not None and b in band_names:
            i = band_names.index(b)
        else:
            try:
                i = int(b)
            except ValueError:
                known = ", ".join(band_names) if band_names else "none"
                raise SystemExit(
                    f"--phot-uplim {b!r}: unknown band name "
                    f"(known: {known}); use a 0-based index instead")
        if not 0 <= i < nbands:
            raise SystemExit(f"--phot-uplim {b}: index out of range "
                             f"(have {nbands} bands)")
        mask[i] = True
    return mask


def _responses(args, band_names):
    """The ResponseSet of --responsefile, or of --builtin-responses for the
    photometry's `band_names`; None in point mode."""
    from mbb_emcee_tpu_torch.response import ResponseSet
    if args.responsefile is not None:
        return ResponseSet.from_file(args.responsefile, dir=args.responsedir,
                                     photon_counter=args.photon_counter)
    if not args.builtin_responses:
        return None
    # an explicit --photon-counter is forwarded; otherwise each band keeps
    # its instrument's own detector convention
    kw = {"photon_counter": True} if args.photon_counter else {}
    return ResponseSet.builtin(band_names, **kw)


def _serve_until_converged(fit, args, log):
    """The --extend-until loop: extend the production run by --extend-step
    until every free parameter's split-R-hat is below the threshold (and,
    with --tau-mult, the chain is long enough), or --max-steps production
    steps are reached. Returns the steps added."""
    import numpy as np
    step = args.extend_step or args.nsteps
    max_steps = args.max_steps or 10 * args.nsteps

    def converged():
        # one R-hat reduction feeds both the display and the predicate
        rhat = fit.gelman_rubin()
        ok = fit.converged(rhat_max=args.extend_until,
                           tau_mult=args.tau_mult, rhat=rhat)
        return ok, float(np.max(rhat))

    total = args.nsteps
    while total < max_steps:
        ok, rhat = converged()
        if ok:
            break
        log.info(f"  split-R-hat {rhat:.4f} >= {args.extend_until}; "
                 f"extending by {step}")
        fit.extend(step, verbose=args.verbose)
        total += step
    else:
        ok, rhat = converged()
    log.info(f"  serving loop done at {total} production steps: "
             f"split-R-hat {rhat:.4f} "
             f"({'converged' if ok else 'max-steps cap hit'})")
    return total - args.nsteps


def _validate_triage_flags(args):
    """--map / --init-map / --loo-exact / --hmc / --pt combinations,
    refused before anything runs (the JAX CLI's rules and messages)."""
    if args.loo_exact and args.covfile is not None:
        raise SystemExit(
            "--loo-exact refits run through the batched likelihood "
            "(diagonal uncertainties only); with --covfile use --loo, whose "
            "pointwise factors are already the exact conditional predictive "
            "densities under the covariance")
    if args.map:
        if (args.hmc or args.pt or args.checkpoint or args.resume
                or args.extend_until is not None or args.init_map):
            raise SystemExit("--map is a triage mode; drop "
                             "--hmc/--pt/--checkpoint/--resume/"
                             "--extend-until/--init-map")
        if (args.get_lir or args.get_dustmass or args.get_peaklambda
                or args.get_evidence or args.loo or args.loo_exact
                or args.ppc):
            raise SystemExit("derived-quantity posteriors, --ppc and the "
                             "--plot-* figures need chains; run without "
                             "--map for them")
    if args.extend_until is not None and (args.hmc or args.pt):
        raise SystemExit("--extend-until works with the stretch-move "
                         "sampler only")
    if args.init_map and (args.hmc or args.pt or args.resume
                          or args.n_ensembles > 1):
        raise SystemExit("--init-map seeds the stretch-move walker "
                         "ball of a single ensemble; drop "
                         "--hmc/--pt/--resume/--n-ensembles")
    if args.hmc and args.pt:
        raise SystemExit("--hmc and --pt are mutually exclusive")
    if args.n_ensembles > 1 and (args.hmc or args.pt):
        raise SystemExit("--n-ensembles applies to the stretch-move "
                         "sampler only; drop --hmc/--pt")
    for flag, on in (("--pt", args.pt), ("--hmc", args.hmc)):
        if on and (args.checkpoint or args.resume):
            raise SystemExit(f"{flag} does not support --checkpoint/--resume")


def _map_and_write(fit, args):
    """--map: MAP + Laplace triage, printed, and a MAPFit-only HDF5 file
    (the JAX CLI's layout, as the batch CLI's --map output)."""
    from mbb_emcee_tpu_torch import hdf5io
    t0 = time.perf_counter()
    r = fit.fit_map(nstarts=args.map_starts, verbose=args.verbose)
    for n, v, sg in zip(fit.free_param_names, r.x, r.sigma):
        print(f"  {n:8s} {v:.5g} +/- {sg:.3g}  (MAP, Laplace)")
    print(f"  lnprob   {r.lnprob:.3f}   ({time.perf_counter() - t0:.1f}s "
          f"host clock, {args.map_starts} starts)"
          + ("" if r.interior else
             "\n  note: mode near a box bound -- Laplace error bars are "
             "not trustworthy; run the full MCMC"))
    hdf5io.write_map_file(
        args.outfile, fit.shape, fit.phot.wave, fit.phot.flux, fit.phot.unc,
        (fit.free_space.expand(r.x), r.lnprob, r.cov, r.sigma, r.interior,
         r.grad_norm))
    return 0


def _report_checks(res, args):
    """--ppc / --loo lines after the fit; returns the LooResult (or None)
    for --loo-exact."""
    import math
    if args.ppc:
        ppc = res.posterior_predictive(thin=args.derived_thin)
        labels = (ppc.band_names if ppc.band_names is not None
                  else [f"{w:.0f}um" for w in res.data_wave])
        bands = "  ".join(
            f"{n}:{p:.3f}" if math.isfinite(p) else f"{n}:uplim"
            for n, p in zip(labels, ppc.band_p))
        print(f"posterior predictive p = {ppc.p_value:.3f} "
              f"(ndata={ppc.ndata}, nfree={ppc.nfree}); "
              f"band tail probs: {bands}")
    if not (args.loo or args.loo_exact):
        return None
    loo = res.compute_loo(thin=args.derived_thin)
    print(f"elpd_loo = {loo.elpd_loo:.3f} +/- {loo.se_elpd_loo:.3f} "
          f"(p_loo={loo.p_loo:.2f}); elpd_waic = {loo.elpd_waic:.3f} "
          f"+/- {loo.se_elpd_waic:.3f}; max Pareto k-hat = "
          f"{float(max(loo.pareto_k)):.2f}"
          + (f"  [{loo.n_bad_k} band(s) with k>0.7: unreliable]"
             if loo.n_bad_k else ""))
    return loo


def _exact_loo(fit, loo, args):
    """--loo-exact: refit without each band PSIS-LOO flagged (k-hat >
    0.7), after the output file is written."""
    from mbb_emcee_tpu_torch.modelcheck import PARETO_K_WARN
    bad = loo.pareto_k > PARETO_K_WARN
    if not bad.any():
        print(f"exact LOO refits: nothing flagged (all k-hat <= "
              f"{PARETO_K_WARN})")
        return
    flagged = loo.point_index[bad]
    exact = fit.compute_loo_exact(bands=[int(b) for b in flagged],
                                  nburn=args.burn, nsteps=args.nsteps,
                                  thin=args.derived_thin)
    labels = (exact.band_names if exact.band_names is not None
              else [f"band{i}" for i in exact.point_index])
    terms = "  ".join(
        f"{n}: {v:.3f}+/-{sg:.3f} (psis {p:.3f})"
        for n, v, sg, p in zip(labels, exact.pointwise_loo, exact.se_mc,
                               loo.pointwise_loo[bad]))
    print(f"exact LOO refits for {flagged.size} flagged band(s): {terms}")


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
    if args.n_ensembles > 1 and args.covfile is not None:
        raise SystemExit(
            "--n-ensembles runs through the batched likelihood, which "
            "supports diagonal uncertainties only; drop --covfile or "
            "--n-ensembles")
    _validate_triage_flags(args)
    if (args.get_lir or args.get_dustmass) and args.redshift is None:
        # before sampling: failing after the run would lose the fit
        raise SystemExit(
            "--get-lir/--get-dustmass need the source redshift: pass "
            "-z/--redshift (add --lumdist to override the luminosity "
            "distance)")
    if args.extend_until is not None:
        _validate_extend_flags(args)

    import logging
    from mbb_emcee_tpu_torch.fitter import MBBFitter
    from mbb_emcee_tpu_torch.likelihood import Photometry
    from mbb_emcee_tpu_torch.results import MBBResults
    from mbb_emcee_tpu_torch.utils.log import enable_console

    log = enable_console(logging.INFO if args.verbose else logging.WARNING)
    names = (Photometry.from_file(args.photfile).band_names
             if args.builtin_responses else None)
    if args.builtin_responses and names is None:
        raise SystemExit(
            "--builtin-responses requires a leading band-name column in the "
            "photometry file ('name wave flux unc' per line)")
    responses = _responses(args, names)
    fit = MBBFitter(nwalkers=args.nwalkers, photfile=args.photfile,
                    wavenorm=args.wavenorm, noalpha=args.noalpha,
                    opthin=args.opthin, responses=responses, seed=args.seed,
                    a=args.stretch_a, device=args.device,
                    sampler_backend=args.sampler_backend,
                    n_ensembles=args.n_ensembles)
    if args.covfile is not None:
        fit.read_cov(args.covfile, args.covextn, args.cov_is_total)
    if args.phot_uplim:
        phot = fit._require_data()
        fit.set_phot_upperlimits(
            _uplim_mask(args.phot_uplim, phot.nbands, phot.band_names))
    for param, v in args.initval:
        fit.set_param_init(param, float(v))
    for param, v in args.initscatter:
        fit.set_param_init(param, scatter=float(v))
    for param, v in args.lowlim:
        fit.set_lowlim(param, float(v))
    for param, v in args.uplim:
        fit.set_uplim(param, float(v))
    for param, v in args.fixed:
        fit.fix_param(param, float(v))
    for param, m, s in args.prior:
        fit.set_gaussian_prior(param, float(m), float(s))

    log.info(f"Device: {fit.device}")
    if args.map:
        return _map_and_write(fit, args)
    log.info(f"Running fit: {args.nwalkers} walkers, burn={args.burn}, "
             f"steps={args.nsteps}, thin={args.thin}")
    t0 = time.perf_counter()
    what = "burn + production"
    if args.pt:
        what = "tempered burn + production"
        fit.run_pt(nrungs=args.pt_rungs,
                   beta_min=(args.pt_beta_min if args.pt_beta_min is not None
                             else "auto"),
                   nburn=args.burn, nsteps=args.nsteps, thin=args.thin,
                   verbose=args.verbose)
        total = args.burn + args.nsteps
    elif args.hmc:
        what = "warmup + production"
        fit.run_hmc(nwarmup=args.burn, nsteps=args.nsteps, thin=args.thin,
                    n_leapfrog=args.hmc_leapfrog,
                    target_accept=args.hmc_target_accept,
                    verbose=args.verbose)
        total = args.burn + args.nsteps
    else:
        if args.init_map:
            fit.fit_map(nstarts=args.map_starts, verbose=args.verbose)
        fit.run(nburn=args.burn, nsteps=args.nsteps, thin=args.thin,
                recenter_burn=not args.no_recenter_burn,
                verbose=args.verbose, checkpoint=args.checkpoint,
                checkpoint_interval=args.checkpoint_interval,
                resume=args.resume, init="map" if args.init_map else "auto")
        # actual ensemble updates; a resumed run skips the burn-in
        total = args.nsteps
        if not (args.resume and args.checkpoint):
            total += args.burn if args.no_recenter_burn else 2 * args.burn
    if args.extend_until is not None:
        total += _serve_until_converged(fit, args, log)
    secs = time.perf_counter() - t0
    walkers = args.nwalkers * args.n_ensembles
    log.info(f"  fit ({what}): {total} steps in {secs:.2f}s "
             f"({walkers * total / secs:,.0f} walker-steps/s, "
             f"host clock, build and first-call costs included)")

    if args.get_evidence:
        ev = fit.compute_evidence(nlive=args.nlive, verbose=args.verbose)
        print(f"ln Z = {ev.logz:.4f} +/- {ev.logz_err:.4f} "
              f"({ev.n_like} likelihood evaluations)")

    res = MBBResults(fit=fit, redshift=args.redshift,
                     cosmology=args.cosmology, lumdist=args.lumdist)
    if args.get_lir:
        res.compute_lir(args.lir_wavemin, args.lir_wavemax,
                        thin=args.derived_thin)
    if args.get_dustmass:
        res.compute_dustmass(args.kappa, args.kappa_wave,
                             thin=args.derived_thin)
    if args.get_peaklambda:
        res.compute_peaklambda(thin=args.derived_thin)
    loo = _report_checks(res, args)
    # the chain is on disk before the optional exact-LOO refits run
    res.writeToHDF5(args.outfile)
    print(res)
    if args.loo_exact:
        _exact_loo(fit, loo, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
