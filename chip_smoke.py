"""On-card smoke run of the PyTorch + CUDA port (mbb_emcee_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without printing a result):

  0. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     nvcc path;
  1. build: compile the kernels of mbb_emcee_tpu_torch/csrc with nvcc, and
     require 0 spill bytes in the ptxas report of every K3 layout (each one
     the planner may pick) and of every K1 instantiation;
  2. K1 (lnprob kernel) against its plain torch version on the card, 4096
     parameter vectors (about 10% out of the box) for seven likelihoods;
  3. K2 (stretch-move kernel) against its plain replay on the card, on
     shared external uniforms;
  4. determinism of the kernel's Philox mode, and its replay by the plain
     version drawing the same Philox stream;
  5. the main path: MBBFitter + MBBResults at 250 walkers x 5 bands on the
     parity sentinel's configs, held against the recorded fp64 oracle
     moments, with the kernels' launch counts;
  6. time: marginal walker-steps/s of the kernel sampler against the plain
     torch sampler on the card;
  7. K3 (multi-source stretch-move kernel) against its plain replay on the
     card, on shared external uniforms: 5 sources with per-source upper
     limits and a missing band, a band-correlated case, a 5 x 65 response
     pack;
  8. K3's Philox mode: bitwise deterministic, replayed bitwise by the plain
     multi run, and equal to K2 bitwise for one source; then K3 against the
     plain multi run at the shapes the batch path gives it (256 sources,
     and 4), where a chain may part from the plain one only on an accept
     decision that sits within lnprob rounding of its threshold;
  9. the batch path through the user's entry points, with K3's launch count
     taken over each entry point's run (3 launches each, no plain run):
     MBBFitter(n_ensembles=4) on the parity sentinel's config 1 against the
     recorded fp64 oracle moments, and MultiFitter at 256 sources x 250
     walkers x 5 bands (full model) with summaries and derived posteriors,
     each derived quantity timed on its first and its second call (host
     clock and CUDA events; with --profile-derived the device's busy time
     too) and the chunks it is cut into;
 10. time: K3's aggregate walker-steps/s at 256 x 250 x 5 against the plain
     multi run on the card, in point mode and in response mode (config 3's
     5 x 65 pack), each with its bound;
 11. response mode: K1 against its plain version on BASELINE config 3's
     5 x 65 built-in pack, a 5 x 129 pack, an 8 x 400 pack (above the old
     2080-float staging cap) and an 8 x 1000 pack (above 48 KB of shared
     memory); K2's external-uniforms replay against its plain run on the
     5 x 65 pack (the shape phase 14 runs K2 at), the 5 x 129 and the
     8 x 1000 packs, and K3 against its plain multi run on the 129-node
     pack;
 12. extend: run(n) against run(n1) + extend(n - n1), bitwise, for MBBFitter
     on K2 and MultiFitter on K3, with their launch counts;
 13. time: K1 and K2 in response mode (config 3, 250 walkers x 5 bands x 65
     nodes) against their plain versions, beside K2 in point mode on the
     same model;
 14. the <=1% parity contract of tests/data/hwparity_oracle.json at its FULL
     geometry through MBBFitter.run (8 fits x 250 walkers x (1500 burn +
     8000 steps) per config): configs 0, 1, 2, 3 (response mode, K2 with
     the 5 x 65 pack), 5 and 6, every row printed, and config 4's derived
     L_IR, dust mass and peak wavelength with the elementwise L_IR check
     against the scipy oracle; the kernels' launch counts over the phase;
 15. K2's layouts (ops/sampler_kernel.py plan_stretch_launch: G lanes per
     walker in a cluster of C blocks) against the one-thread-per-walker
     layout (G = 1, C = 1) on shared external uniforms: point mode (configs
     1, 2, 6) bitwise; config 3's 5 x 65 pack and the 8 x 1000 pack, where
     a chain may part only on an accept decision within lnprob rounding of
     its threshold; the planned layout of each case;
 16. the plan sweep: K2's device time on every layout G x C in each mode of
     the planner's table (point mode with and without the Wien merge solve,
     response mode), each in turns with G = 1, C = 1;
 17. K3's layouts (ops/multifit_kernel.py plan_multi_launch: G lanes per
     walker in one block per source, or a cluster of C blocks per source)
     against G = 1, C = 1 on shared external uniforms at 1, 4 and 256
     sources: point mode (configs 1 and 2 with per-source upper limits and
     a missing band, config 6's band correlation) bitwise; config 3's
     5 x 65 and 5 x 129 packs where a chain may part only on an accept
     decision within lnprob rounding of its threshold; the planned layout
     of each case against the plain multi run under that rule; K3 at one
     source on every layout against K2, bitwise;
 18. the K3 sweep: K3's device time on every layout the planner may pick,
     at 4, 16, 32, 64, 256 and 1024 sources, in each mode of its table, each
     in turns with G = 1, C = 1, beside how many sources of it the card
     runs at once;
 19. K1's layouts (ops/lnprob_kernel.py plan_lnprob_launch: G lanes per
     vector, blocks of a few warps looping over tiles) against one thread
     per vector in blocks of 128 and against the plain version, on 4096
     vectors and on 1, 31, 33 and 250: point mode (configs 0, 1, 2, 5, 6)
     bitwise, the 5 x 65, 5 x 129, 8 x 400 and 8 x 1000 packs within K1's
     tolerance, floors identical; the planned layout at every batch size of
     the sweep; and response mode with correlated band errors (config 3's
     5 x 65 pack under config 5's covariance) on K1's layouts, K2's replay
     and K3 with that band correlation, each against its plain version;
 20. the K1 sweep: K1's device time on every layout at 250, 4,096, 62,500
     and 1,048,576 vectors in each mode of the planner's table, each in
     turns with one thread per vector in blocks of 128, beside its bound at
     that batch size; then the host's time per mbb_lnprob call and per
     MBBFitter.__call__ beside the device's;
 21. MAP and model checking through the user's entry points: fit_map on
     the card at config 2 and in response mode (config 3's 5 x 65 pack),
     each mode held against the same call on the CPU (1e-2 Laplace sigma,
     lnp 1e-3), and map_importance's 2048 Laplace draws through K1 (1
     launch each); fit_map then run(init="map", MAP_SEEDED_BURN, 250) on
     K2 (3 launches each) against the sentinel's configs 1 and 6 as phase 5
     holds its fits; MultiFitter at 256 sources x 250 walkers x 5 bands:
     run_map (8 starts), map_importance, run(init="map") on K3 (3
     launches), then posterior_predictive and compute_loo over 256 x
     62,500 samples, each timed on its first and second call; and
     compute_loo_exact at config 1 on K3 (3 launches) against PSIS-LOO
     (0.3 nats where k-hat <= 0.7). No plain sampler run on any of these
     paths; every time beside the nvidia-smi line;
 22. HMC and parallel tempering through the user's entry points, at config
     2 (250 walkers x 5 bands): MBBFitter.run_pt() at its defaults on K1
     (2 launches per tempered step + 1 per ladder start, counted; no plain
     run), replayed by the plain likelihood on the card on the same Philox
     draws (positions bitwise up to the step where a decision within 1e-4
     of its threshold falls the other way), its cold chain against K2's
     run(200, 1000) on the same data (medians and 68% widths within
     max(1%, 3 sigma_MC)) and its stepping-stone lnZ against the CPU's
     run_pt(nsteps=200) on the same draws over their first 199 records
     (3x the combined batch-means error); run_hmc(100 + 200 x 8 leapfrog
     steps) against the same K2 fit (max(2%, 3 sigma_MC)), its time per
     gradient, and one short call under torch.profiler for the kernels per
     leapfrog step;
     MultiFitter.run_pt(12 rungs, 100 + 200) and run_hmc(25 + 100 x 2) at
     16 of the batch cell's sources, each whole and in production segments
     of 50 records through the checkpoint= path (its flush replaced by a
     recorder: the card's machine has no h5py), chains bitwise equal;
 23. nested sampling and the population tier through the user's entry
     points: MBBFitter.compute_evidence() at its defaults at config 2 on K1
     (1 + n_iter x nsteps launches counted, no plain likelihood call, n_iter
     and ms per iteration printed), replayed by the plain likelihood on the
     card on the same Philox draws over its first NESTED_REPLAY_ITERS
     iterations (live and dead points bitwise, lnprob within K1's
     tolerance, up to a decision within 1e-4 of its threshold),
     its lnZ against the CPU's same call (in a worker process beside the
     card's work) and run_pt()'s stepping stone (phase 22's, 3x the
     combined error), its weighted posterior medians against K2's
     run(200, 1000) (max(2%, 3 sigma_MC)), the device's busy share of a
     short call under torch.profiler; the thin model's evidence on the same
     data beside it; MultiFitter.compute_evidence over NESTED_BATCH_SOURCES
     of the batch cell's sources (every source converged; sources 0-1
     against the CPU's same call); and the population stage on the batch
     cell's MultiFitter.run(50, 250) on K3: HierarchicalFitter.from_batch
     (T, beta).run(200, 1000), the correlated variant at CORRELATED_DEPTH,
     the hyper evidence and reweight_ess, the full-size hyper-lnprob
     against the CPU's at POP_CHECK_VECTORS hyper vectors and the hyper
     medians against the same call on the CPU at POP_CPU_SAMPLES stored
     samples per source;
 24. the generic-model tier (sed.py: SEDModel, SEDFitter, SEDResults; no
     kernel of its own, the plain torch sampler over the vmapped user model)
     through the user's entry points at 250 walkers x 5 bands: (a)
     build_sed_lnprob of the wrapped 5-parameter MBB against K1 on the same
     250 and 4,096 vectors, config 2 and config 3's 5 x 65 pack (K1's
     tolerance); (b) SEDFitter.run(200, 1000) against MBBFitter.run(200,
     1000) on K2 (medians and 68% widths within max(2%, 3 sigma_MC); no
     kernel launched, 3 plain sampler runs) and run(n1) + extend(n2)
     bitwise run(n1 + n2); (c) compute_lir (rtol 1e-4) and
     compute_peaklambda (rtol 2e-3) of SEDResults and MBBResults on the SED
     chain, and compute_lir(z_param=...) of a sampled-redshift model
     against the CPU; (d) examples/two_temp_model.py's model and
     cmb_corrected_mbb(5.0, opthin=True, noalpha=True) through run(50, 250)
     against the CPU's same call (medians within 3 sigma_MC); (e) fit_map
     against the CPU's, map_importance, run(init="map") and run_pt against
     the K2 fit, run_hmc against the CPU's same call, posterior_predictive
     and compute_loo against the MBB band fluxes on the same chain,
     compute_evidence against MBBFitter.compute_evidence on K1 (3x the
     combined error), each at the depths SED_* name; (f) the stretch step's marginal time, kernels and
     device busy share under torch.profiler, beside K2's on the same
     posterior;
 25. the generic batch tier and submm photo-z (sedmulti.py, photoz.py; no
     kernel of their own: the plain batch stretch step over the vmapped
     user model) through the user's entry points: (a) photoz_mbb's fnu,
     every variant of cmb / opthin / noalpha, on PZ_VECTORS rows with z at
     both bounds, on the card against the CPU, and each against the CPU's
     fp64 evaluation of the same formulas (|d ln f| <= 1e-5 plus 8 ulp of
     the Planck argument plus the CMB visibility's conditioning); (b) tests/test_photoz.py:352's photo-z
     fit (T prior; beta, lambda0, alpha fixed) at 250 walkers and PZ_FIT,
     its P(z) median and 68% width against the exact (T, fnorm, z) grid
     marginal of PZ_GRID points evaluated on the card in one batched call
     (that test's tolerances); (c) SEDMultiFitter of the wrapped MBB at the
     batch cell's width (256 sources x 250 walkers x 5 bands, band 0
     missing in 16) through run(50, 250) against MultiFitter.run(50, 250)
     on K3 on the same data (per-source medians and 68% widths within
     max(2%, 3 sigma_MC); 0 K1 and 0 K3 launches, 3 plain multi runs) and
     run(n1) + extend(n2) bitwise run(n1 + n2) at 16 sources; (d)
     compute_lir (rtol 1e-4) and compute_peaklambda (rtol 2e-3) of
     SEDMultiFitter and MultiFitter on the same chain, thinned, and
     compute_dustmass_batch of a 16-source photo-z batch against the CPU
     (rtol 1e-4); (e) the batch stretch step's marginal time, kernels per
     step and device busy share under torch.profiler, beside K3's per-step
     time at the same batch. Budget: 40 s, advisory (a run over it
     prints OVER and still passes: the host's clock varies 1.5x across
     machines);
 26. the generic command line and the plots (cli_sed.py, plotting.py; no
     kernel of their own) through the user's entry points, at the batch
     cell's width (256 sources x 250 walkers x 5 bands) on a mock catalog
     of the shipped examples/two_temp_model_torch.py, depth cut to -b 20
     -n 40: (a) run_sed_tpu_torch's fit stage (cli_sed.fit) bitwise
     SEDMultiFitter(model, 250, seed=5).run(20, 40) on the same data, 0 K1,
     K2 and K3 launches (3 plain multi runs); (b) the fit stage with
     --extend-until 1.1 --max-steps 120 --ppc --get-lir --get-peaklambda
     --derived-thin 10 --summary: the production length is what the logged
     extensions add up to, at most --max-steps, the summary carries its
     'PPC p' column, every p-value, L_IR and lambda_peak median finite;
     (c) the three model-file twins (examples/*_torch.py) through
     cli_sed.load_model, fnu on the card against the CPU on 4,096 rows at
     phase 25 (a)'s bound; (d) without matplotlib (the card's machine has
     none) mbb_emcee_tpu_torch.plotting imports and a plot hook raises the
     ImportError naming it; _mc_marginal on the card against the CPU
     (rtol 1e-5); (e) the two-temperature batch step's marginal time and
     kernels per step. Budget: 20 s, advisory, as phase 25's;
 27. the migration surface (compat.py, utils/profiling.py, legacy_h5.py,
     cli_inspect.py; no kernel of their own) at config 2's width (250
     walkers x 5 bands, the rate cell's mock data written to a text
     photometry file under build/chip_smoke/): (a) compat.mbb_fitter with
     the upstream positional order (nthreads = 4 in the 8th slot),
     redshift=2.5, run(50, 250): bitwise MBBFitter(...).run(50, 250) by
     keyword on the card, 2 K1 and 3 K2 launches as MBBFitter.run's own
     (FIT_LAUNCHES), like(theta) == fit(theta),
     mbb_results(cosmo_type=...).compute_lir() bitwise MBBResults(
     cosmology=...)'s; (b) profiling.trace(dir) around a second
     MBBFitter.run(50, 250) in a fresh worker process (its first
     torch.profiler session, as a CLI's --profile-dir is; a process that has
     run many sessions can drop a later trace's device events): one Chrome
     trace file that parses, whose
     device-kernel events name mbb_stretch_kernel three times and the lnprob
     kernel at least once, the same 2 K1 and 3 K2 launches counted (the
     trace adds none), StepTimer's rate over the same call, the trace's
     size and the seconds it adds over the untraced call; (c) without h5py
     (the card's machine has none) legacy_h5, cli_inspect and compat import,
     read_upstream_results and inspect_file raise the ImportError naming
     it, and mbb_tpu_inspect_torch's parser parses. Budget: 20 s, advisory;
 28. multi-device sharding (parallel/, the mesh= legs of the batch tiers
     and MBBFitter, --mesh-devices) through the user's entry points, the
     mesh across the cards when the machine has several, else its shards
     sharing cuda:0: (a) MultiFitter(mesh=4 shards).run(50, 250) with the
     default sampler_backend at the batch cell's width (256 sources x 250
     walkers x 5 bands) bitwise the unsharded K3 run, 3 K3 launches per
     shard and no plain run; (b) K3 at source0=64 on sources 64-127 bitwise
     rows 64:128 of the whole launch, and against the plain multi run at
     the same offset by phase 8's rule; (c) ShardedEnsembleSampler on 5
     shards at config 2 (250 walkers), K1 per shard, bitwise
     EnsembleSampler on the same K1 lnprob and seed, K1 launches counted,
     and K1 on each shard's device at its 25-vector blocks against
     build_lnprob's plain version at phase 2's tolerances;
     (d) MBBFitter(mesh=5 shards).run(50, 250) on K1 (its launches counted,
     no K2) against K2's fit within max(1%, 3 sigma_MC); (e)
     cli_batch.main with --device cuda and --mesh-devices one more than the
     cards present raises walker_mesh's error; (f) the sharded single
     fit's ms and kernels per step beside K2's, the sharded K3 run's time
     beside the unsharded one's at the batch cell and at 64 times its
     catalog (16,384 sources, several waves per card; bitwise required).
     Budget: 20 s, advisory.

It then prints the kernel table as one JSON line (with each kernel's bound
and the kernels' planned layouts), the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits with code 1
before any phase. `--phases 3,15` (or `21`, ..., `27`, `28`) runs the
build and those phases alone, a rehearsal that prints no kernel table and
no result line;
`--profile-derived` adds torch.profiler's device busy time to the derived
posteriors' timings of phases 9 and 14 (about a minute more). A whole run
takes about 5-6 minutes on one H100 (H100 80GB HBM3 at 700 W), the
kernels' build included.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel-vs-plain checks on the card. Both sides are fp32
# with the same formulas in the same operation order (the kernels are built
# with -fmad=false); what differs is the order of the band and prior sums
# and torch's own elementwise kernels, i.e. a few ulp of lnprob.
K1_RTOL, K1_ATOL = 1e-5, 1e-4
# alpha fixed at 0 puts the Wien merge root at the SED peak (a double root
# of the slope condition): there the fixed-iteration solve amplifies an ulp
# of difference in its inputs (tests/test_pallas.py uses 8e-2 for the TPU
# kernel at this point).
K1_ALPHA0_RTOL, K1_ALPHA0_ATOL = 2e-3, 2e-3
# Replay tolerances of tests/test_pallas_sampler.py:97-100.
K2_RTOL, K2_ATOL, K2_LNP_ATOL = 2e-5, 1e-5, 1e-4

NWALKERS = 250
DEVICE = "cuda"
# The batch cell: bench.py's multisource shape, 256 sources x 250 walkers.
NSOURCES = 256

# The card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
# limit): fp32 outside the tensor cores, and device memory.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operation counts of the bound: a libdevice exp, expm1 or log counts as 20
# fp32 operations and a division as 10 (their instruction sequences), any
# other add, multiply, compare, min/max or select as 1.
OPS_TRANS, OPS_DIV = 20, 10


def lnprob_ops(icfg):
    """fp32 operations of one lnprob of csrc/lnprob.cuh for the likelihood
    configuration icfg (opthin, noalpha, use_chol, nb, nnodes, ...), counted
    from its formulas: the same for every walker (out-of-box walkers run the
    whole chain on clipped values)."""
    opthin, noalpha, use_chol, nb, nnodes = (int(v) for v in icfg[:5])
    t, d = OPS_TRANS, OPS_DIV
    # grey ln S: x, 3u - log_expm1(x) [+ beta u | + log1mexp(tau)]
    grey = 3 * t + 5 + (2 if opthin else 3 * t + 6)
    # g and g': x, q, g'_Planck [+ tau, h(tau), clamp, g'] + g
    slope = 2 * t + d + 7 + (3 if opthin else 2 * t + d + 17)
    node = 1 + grey + 5 + (t + 4)       # ln x, ln S, Wien select, w e^(..)
    n = 20 + 2 * t + 2 + t              # box, ln T, ln x0, ln fnorm
    if not noalpha:                     # bracket, 6 bisections, 2 Newton
        n += (2 * t + 7) + 6 * (slope + 5) + 2 * (slope + d + 4) + grey
    n += 1 + grey + 5                   # the normalization point
    n += nb * nnodes * node + 3 * nb    # band sums, residuals
    n += nb * (nb + 1) + 2 * nb if use_chol else 3 * nb
    return n + 20 + 4                   # priors, lnp


def stretch_step_ops(philox):
    """fp32/int32 operations of one walker's proposal and accept test beside
    its lnprob: the Philox-4x32-10 draw (10 rounds of 2 multiplies, 2
    high multiplies, 4 xors and 2 key adds; 3 uniform maps) or nothing for
    external uniforms, z, the partner, the proposal, and ln z, ln u2."""
    draw = 10 * 10 + 9 if philox else 0
    return draw + (4 + OPS_DIV) + 3 + 3 * 5 + (2 * OPS_TRANS + 5) + 1


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops at the fp32 peak and bytes at
    the memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def k1_bound(icfg, n, nfree, nconsts):
    """K1 on n vectors: n lnprobs; reads theta and the constants, writes n
    floats."""
    return bound(n * lnprob_ops(icfg), 4 * (n * nfree + nconsts + n))


def k2_bound(icfg, nsrc, nw, nfree, nconsts, nsteps, nrec):
    """K2 (nsrc = 1) or K3 over nsrc ensembles of nw walkers, Philox mode:
    the initial lnprob of every walker, then one lnprob and one proposal
    per walker per step; reads positions, accepts and the constants, writes
    the chain records and the final state."""
    ops = nsrc * nw * (lnprob_ops(icfg)
                       + nsteps * (lnprob_ops(icfg) + stretch_step_ops(True)))
    nbytes = 4 * (nsrc * nw * (nfree + 1) + nconsts
                  + nsrc * nrec * nw * (nfree + 1) + nsrc * nw * (nfree + 2))
    return bound(ops, nbytes)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def port_response_pack(nnodes=65):
    """(ResponseSet, (waves, weights)) of BASELINE config 3's bands from the
    port's built-in library: tools/validate_tpu_parity.py's response_pack,
    which imports the JAX package. The pack is the JAX package's bit for bit
    (tests/test_torch_response.py), so vp.mock_data gives config 3 the data
    its recorded oracle moments were made from."""
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.response import ResponseSet
    rs = ResponseSet.builtin(vp.BANDS, nnodes=nnodes)
    return rs, rs.pack(vp.BANDS)


def use_port_response_pack():
    """Build config 3's mock data without jax: bind the parity tool's
    response_pack to port_response_pack (the same formula then runs in
    vp.mock_data on the port's pack)."""
    from tools import validate_tpu_parity as vp
    vp.response_pack = port_response_pack


def problem(ci, alpha_fixed_at=None, response_pack=None):
    """(phot, shape, spec) of parity config `ci` (tools/validate_tpu_parity
    .py), as its fits set it up: T <= 100, beta <= 5, the config's priors,
    lambda0/alpha fixed at their true values where the shape drops them,
    and the flagged upper-limit band."""
    import dataclasses
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.likelihood import Photometry, LikelihoodSpec
    from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape

    cfg = vp.CONFIGS[ci]
    flux, unc, cov = vp.mock_data(cfg)
    phot = Photometry(vp.WAVE, flux, unc, cov=cov)
    shape = MBBShape(opthin=cfg["opthin"], noalpha=cfg["noalpha"])
    spec = LikelihoodSpec.default()
    spec.upper[0], spec.upper[1] = vp.UPPER[0], vp.UPPER[1]
    for (pi, mean, sig) in cfg["priors"]:
        spec.prior_mean[pi] = mean
        spec.prior_isigma[pi] = 1.0 / sig
    if cfg["opthin"]:
        spec.fixed[2], spec.fixed_values[2] = True, vp.TRUE[2]
    if cfg["noalpha"]:
        spec.fixed[3], spec.fixed_values[3] = True, vp.TRUE[3]
    if alpha_fixed_at is not None:
        spec.fixed[3], spec.fixed_values[3] = True, alpha_fixed_at
    ub = cfg.get("uplim_band")
    if ub is not None:
        mask = np.zeros(flux.size, bool)
        mask[ub] = True
        spec = dataclasses.replace(spec, uplim_bands=mask)
    return phot, shape, spec


def numpy_response_pack(wave, nnodes=65, half_width=0.25):
    """(nbands, nnodes) nodes log-spaced across +-half_width in ln lambda
    around each band, with trapezoid weights normalized to sum 1."""
    import numpy as np
    u = np.linspace(-half_width, half_width, nnodes)
    nodes = np.asarray(wave, np.float64)[:, None] * np.exp(u)[None, :]
    w = np.full(nnodes, u[1] - u[0])
    w[0] *= 0.5
    w[-1] *= 0.5
    w = w / w.sum()
    return nodes, np.broadcast_to(w, nodes.shape).copy()


def thetas(free_space, n=4096, seed=3, out_frac=0.1):
    """n free-space vectors around the truth, out_frac of them pushed out
    of the box in one coordinate."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    rng = np.random.default_rng(seed)
    free = free_space.free_idx
    th = vp.TRUE[free][None, :] * rng.uniform(0.7, 1.3, (n, free.size))
    bad = rng.choice(n, int(out_frac * n), replace=False)
    col = rng.integers(0, free.size, bad.size)
    lo, hi = free_space.lower[col], free_space.upper[col]
    th[bad, col] = np.where(rng.random(bad.size) < 0.5, lo - 0.5 * abs(lo)
                            - 1.0, hi * 1.5 + 1.0)
    return th.astype(np.float32), bad


def phase_device():
    import torch
    log(f"[0] device: {nvidia_smi_line()}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from mbb_emcee_tpu_torch.ops.build import find_nvcc
    log(f"[0] nvcc: {find_nvcc()}")


def phase_build():
    """Build the kernels, print nvcc's register and spill report, and
    require 0 spill bytes on every K3 layout (MULTI_LAYOUTS: the planner may
    pick each of them) and on every K1 instantiation (LNPROB_GROUPS, with a
    block per tile and looping).
    Returns the report's rows of the K3 and of the K1 instantiations."""
    from mbb_emcee_tpu_torch.ops.build import (
        build_kernels, build_log, ptxas_report)
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import LNPROB_GROUPS
    from mbb_emcee_tpu_torch.ops.multifit_kernel import MULTI_LAYOUTS
    t0 = time.time()
    build_kernels()
    log(f"[1] build: {time.time() - t0:.1f} s")
    for line in (build_log() or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[1]   {line.strip()}")
    rows = [r for r in ptxas_report(build_log() or "")
            if r["kernel"] == "mbb_multi_stretch_kernel"]
    for r in rows:
        log(f"[1] K3 G={r['group']} {'cluster' if r['cluster'] else 'block'}"
            f": {r['registers']} registers, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads")
    have = {(r["group"], r["cluster"]): r for r in rows}
    planned = sorted(MULTI_LAYOUTS)
    bad = [lay for lay in planned if lay not in have
           or have[lay]["spill_stores"] or have[lay]["spill_loads"]]
    log(f"[1] K3 layouts {planned}: 0 spill bytes "
        f"{'PASS' if not bad else 'FAIL ' + str(bad)}")
    if bad:
        raise AssertionError(f"K3 layouts {bad} spill or are missing from "
                             "the ptxas report")
    k1_kernels = ("mbb_lnprob_kernel", "mbb_lnprob_loop_kernel")
    k1_rows = [r for r in ptxas_report(build_log() or "")
               if r["kernel"] in k1_kernels]
    for r in k1_rows:
        log(f"[1] K1 {r['kernel']} G={r['group']}: {r['registers']} "
            f"registers, {r['spill_stores']} B spill stores, "
            f"{r['spill_loads']} B spill loads")
    have = {(r["kernel"], r["group"]): r for r in k1_rows}
    bad = [(k, g) for k in k1_kernels for g in LNPROB_GROUPS
           if (k, g) not in have or have[(k, g)]["spill_stores"]
           or have[(k, g)]["spill_loads"]]
    log(f"[1] K1 instantiations G in {LNPROB_GROUPS}, a block per tile and "
        f"looping: 0 spill bytes {'PASS' if not bad else 'FAIL ' + str(bad)}")
    if bad:
        raise AssertionError(f"K1 instantiations {bad} spill or are missing "
                             "from the ptxas report")
    return rows, k1_rows


def phase_k1():
    """K1 against build_lnprob's function on the card, per case."""
    from tools import validate_tpu_parity as vp

    cases = [("config0 thin3", dict(ci=0)), ("config1 thick4", dict(ci=1)),
             ("config2 full5", dict(ci=2)), ("config5 cov", dict(ci=5)),
             ("config6 cov+uplim", dict(ci=6)),
             ("response 5x65", dict(ci=2, response_pack=numpy_response_pack(
                 vp.WAVE))),
             ("alpha fixed at 0", dict(ci=2, alpha_fixed_at=0.0))]
    worst = 0.0
    for name, kw in cases:
        ci = kw.pop("ci")
        tol = ((K1_ALPHA0_RTOL, K1_ALPHA0_ATOL) if "alpha" in name
               else (K1_RTOL, K1_ATOL))
        worst = max(worst, _k1_case("2", name, *problem(ci, **kw),
                                    kw.get("response_pack"), *tol))
    # MBBFitter.__call__ (one K1 launch on cuda) against the CPU fitter
    from mbb_emcee_tpu_torch import MBBFitter
    phot, _, _ = problem(2)
    vals = []
    for device in (DEVICE, "cpu"):
        fit = MBBFitter(device=device)
        fit.set_data(phot.wave, phot.flux, phot.unc)
        vals.append(fit(vp.TRUE))
    ok = abs(vals[0] - vals[1]) <= K1_ATOL + K1_RTOL * abs(vals[1])
    log(f"[2] MBBFitter.__call__ at the truth: {DEVICE} {vals[0]:.7g}, cpu "
        f"{vals[1]:.7g} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MBBFitter.__call__ disagrees across devices")
    return worst


def _ball(free_space, n, seed, device):
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.sampler import make_initial_ball
    g = torch.Generator().manual_seed(seed)
    c = vp.TRUE[free_space.free_idx]
    return make_initial_ball(g, c, 0.05 * abs(c), n, free_space.lower,
                             free_space.upper, device=device)


def _compare_runs(tag, got, want):
    """(state, chain, lnp) pairs -> max abs chain difference; raises if the
    chains, lnprobs or accept counts disagree."""
    import numpy as np
    (sg, cg, lg), (sw, cw, lw) = got, want
    cg, cw = cg.cpu().numpy(), cw.cpu().numpy()
    lg, lw = lg.cpu().numpy(), lw.cpu().numpy()
    ag, aw = sg.naccept.cpu().numpy(), sw.naccept.cpu().numpy()
    ok_c = np.allclose(cg, cw, rtol=K2_RTOL, atol=K2_ATOL)
    ok_l = np.allclose(lg, lw, rtol=K2_RTOL, atol=K2_LNP_ATOL)
    ok_a = np.array_equal(ag, aw)
    dmax = float(np.abs(cg - cw).max())
    log(f"[{tag}] chain max |d| {dmax:.3g}, lnp max |d| "
        f"{float(np.abs(lg - lw).max()):.3g}, accepts {int(ag.sum())} vs "
        f"{int(aw.sum())} {'PASS' if ok_c and ok_l and ok_a else 'FAIL'}")
    if not (ok_c and ok_l and ok_a):
        raise AssertionError(f"[{tag}] kernel run disagrees with plain")
    return dmax


def phase_k2():
    """K2 in external-uniforms mode against the plain replay on the card:
    250 walkers, config 2, 3 records x thin 2."""
    return _k2_replay("3", *problem(2), None)


def phase_determinism():
    """Philox mode twice with one seed: bitwise-equal chains; and the plain
    version drawing the same Philox stream replays the kernel."""
    import dataclasses
    import torch
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import stretch_run_plain

    phot, shape, spec = problem(2)
    samp = FusedSampler(NWALKERS, phot, shape, spec, device=DEVICE)
    p0 = _ball(samp.free_space, NWALKERS, 4, DEVICE)
    state = samp.init_state(p0, seed=0x5EED_1234_ABCD)
    r1 = samp.run_mcmc(state, 200, thin=10)
    r2 = samp.run_mcmc(state, 200, thin=10)
    same = (torch.equal(r1[1], r2[1]) and torch.equal(r1[2], r2[2])
            and torch.equal(r1[0].naccept, r2[0].naccept))
    log(f"[4] Philox mode, same seed twice: chains bitwise "
        f"{'equal PASS' if same else 'DIFFERENT FAIL'}")
    if not same:
        raise AssertionError("kernel chains are not deterministic")
    r3 = samp.run_mcmc(dataclasses.replace(state, seed=state.seed + 1), 200,
                       thin=10)
    if torch.equal(r1[1], r3[1]):
        raise AssertionError("another seed gave the same chain")
    log("[4] another seed gives another chain PASS")
    got = samp.run_mcmc(state, 6, thin=2)
    want = stretch_run_plain(state, samp.ops.plain, 3, 2, samp.a)
    _compare_runs("4", got, want)


def use_repo_tests_package():
    """Bind the name `tests` to this checkout's tests/ directory (a
    namespace package, which an installed package named `tests` would
    otherwise shadow), so tools/validate_tpu_parity.py finds the fp64
    oracle under tests/reference_impl."""
    import types
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg


def port_fitter(ci, flux, unc, cov, seed, device=None, opthin=None,
                mesh=None):
    """A port MBBFitter of parity config `ci` on `device` (default DEVICE;
    with `mesh`, its walker axis sharded over the mesh), set up as
    tools/validate_tpu_parity.py's jax_fit sets up the JAX fitter;
    `opthin` overrides the config's model shape."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBFitter

    cfg = vp.CONFIGS[ci]
    responses, band_names = None, None
    if cfg["response"]:
        responses, _ = port_response_pack()
        band_names = vp.BANDS
    opthin = cfg["opthin"] if opthin is None else opthin
    fit = MBBFitter(nwalkers=NWALKERS, seed=seed, opthin=opthin,
                    noalpha=cfg["noalpha"], responses=responses,
                    device=device or DEVICE, mesh=mesh)
    fit.set_data(vp.WAVE, flux, unc, cov=cov, band_names=band_names)
    fit.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    ub = cfg.get("uplim_band")
    if ub is not None:
        mask = np.zeros(flux.size, bool)
        mask[ub] = True
        fit.set_phot_upperlimits(mask)
    for (pi, mean, sig) in cfg["priors"]:
        fit.set_gaussian_prior(pi, mean, sig)
    for i in range(5):
        fit.set_param_init(i, vp.TRUE[i])
    return fit


def port_fit(ci, flux, unc, cov, seed, nburn, nsteps):
    """One port MBBFitter run of parity config `ci` (port_fitter) on the
    kernel sampler."""
    fit = port_fitter(ci, flux, unc, cov, seed)
    fit.run(nburn=nburn, nsteps=nsteps)
    if type(fit.sampler).__name__ != "FusedSampler":
        raise AssertionError("the fitter did not select the kernel sampler")
    return fit


def tau_se(chain_free, flat, free):
    """Per-run SE of (median, 68% width) from the measured autocorrelation
    time: tools/validate_tpu_parity.py's tau_se with the port's
    autocorrelation_time."""
    import numpy as np
    from mbb_emcee_tpu_torch.sampler import autocorrelation_time
    tau = np.maximum(np.nan_to_num(autocorrelation_time(chain_free),
                                   nan=1.0), 1.0)
    n_eff = flat.shape[0] / tau
    std = flat[:, free].std(axis=0)
    return 1.2533 * std / np.sqrt(n_eff), 1.54 * std / np.sqrt(n_eff)


def _counts(reset=False):
    """Zero (reset=True) or read the launch counts of K1, K2 and K3 and the
    run counts of the two plain samplers."""
    from mbb_emcee_tpu_torch import sampler as plain_sampler
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.multifit_kernel import mbb_multi_stretch_run
    from mbb_emcee_tpu_torch.ops.sampler_kernel import mbb_stretch_run
    fns = {"mbb_lnprob": (mbb_lnprob, "launches"),
           "mbb_stretch_run": (mbb_stretch_run, "launches"),
           "mbb_multi_stretch_run": (mbb_multi_stretch_run, "launches"),
           "plain_sampler_runs": (plain_sampler.stretch_run_plain, "runs"),
           "plain_multi_runs": (plain_sampler.multi_stretch_run_plain,
                                "runs")}
    if reset:
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in fns.items()}


def phase_main_path():
    """The main path through the user's entry points, with the kernels'
    launch counts taken over exactly this phase. Returns the counts."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBResults

    with open(vp.SENTINEL_PATH) as fh:
        reference = json.load(fh)["configs"]
    geom = vp.SENTINEL
    _counts(reset=True)
    t0 = time.time()
    for ci in vp.SENTINEL_CONFIGS:
        cfg = vp.CONFIGS[ci]
        free = vp.free_indices(cfg)
        flux, unc, cov = vp.mock_data(cfg)
        meds, wids, ses = [], [], []
        for k in range(geom.k_jax):
            fit = port_fit(ci, flux, unc, cov, seed=1000 + 17 * k,
                           nburn=geom.nburn_jax, nsteps=geom.nstep_jax)
            flat = fit.chain.reshape(-1, 5)
            m, w = vp.stats(flat, free)
            meds.append(m)
            wids.append(w)
            ses.append(tau_se(fit.chain_free.double().cpu().numpy(), flat,
                              free))
            if ci == vp.SENTINEL_CONFIG and k == 0:
                main_fit = fit
        mj, wj, sjm, sjw = vp.aggregate(meds, wids, ses)
        ok, lines = vp.check_sentinel(
            {"medians": mj, "widths": wj, "se_medians": sjm,
             "se_widths": sjw}, reference[str(ci)])
        log(f"[5] {cfg['label']}: {geom.k_jax} fits x {NWALKERS} walkers x "
            f"({geom.nburn_jax} burn + {geom.nstep_jax} steps) against the "
            f"recorded fp64 oracle moments:")
        for line in lines:
            log(f"[5]   {line}")
        if not ok:
            raise AssertionError(f"{cfg['label']}: posterior off the "
                                 "recorded oracle moments")
    res = MBBResults(fit=main_fit, redshift=2.2)
    for name in ("lir", "dustmass", "peaklambda"):
        chain = getattr(res, f"compute_{name}")()
        if chain.shape != (main_fit.chain_free.shape[0] * NWALKERS,) \
                or not np.all(np.isfinite(chain)):
            raise AssertionError(f"{name} posterior is not finite")
        c = getattr(res, f"{name}_cen")()
        log(f"[5] {name}_cen (z = 2.2): {c[0]:.6g} +{c[1]:.4g} "
            f"-{c[2]:.4g}")
    log("[5] HDF5 write skipped: h5py is not needed on the card's machine; "
        "the CPU tests cover writing and cross-loading the file")
    counts = _counts()
    log(f"[5] launch counts over the main path ({time.time() - t0:.1f} s): "
        f"{counts}")
    if counts["mbb_lnprob"] < 1 or counts["mbb_stretch_run"] < 1 \
            or counts["plain_sampler_runs"] != 0:
        raise AssertionError("the main path did not run through both "
                             "kernels alone")
    return counts


def _cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` calls, by CUDA events after a
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_device_us(fn, reps, kernel):
    """Device microseconds per launch of `kernel` over `reps` calls of fn(),
    from torch.profiler's trace, or None when the trace holds no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += getattr(evt, "device_time_total", 0.0)
            count += evt.count
    return total / count if count and total > 0 else None


def _sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _host_s(fn):
    """Seconds of fn() on the host clock, every card synchronized on both
    ends."""
    _sync_all()
    t0 = time.perf_counter()
    fn()
    _sync_all()
    return time.perf_counter() - t0


def _profiled_busy_ms(fn):
    """(result of fn(), milliseconds the device was busy during it): the
    sum of the device time of every kernel and copy of one call under
    torch.profiler tracing the device alone (tracing the host's operators
    too multiplied the host's time of a call of many small launches), or
    None when the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        total += getattr(evt, "self_device_time_total", 0.0)
    return out, (total / 1e3 if total > 0 else None)


# --profile-derived: time_derived also takes each derived posterior's device
# busy time from torch.profiler, in a third call. Off by default: the trace
# multiplies the host's time of these calls of many small launches (a call
# of 1.8 s took 12 s under it on an H100's machine).
PROFILE_DERIVED = False


def time_derived(tag, obj, card, **kw):
    """Time obj.compute_lir, compute_dustmass and compute_peaklambda(**kw),
    each on its first and its second call: the host clock (synchronized)
    and CUDA events around the call (the span on the device's timeline,
    host gaps included); with PROFILE_DERIVED also the device's busy time
    inside a third call, from torch.profiler, beside that call's host time.
    Returns ({name: chain}, {name: {"first", "second": {"host_ms",
    "events_ms"}, "profiled": {"host_ms", "busy_ms"}}})."""
    import torch
    chains, times = {}, {}
    for name in ("lir", "dustmass", "peaklambda"):
        fn = getattr(obj, f"compute_{name}")
        times[name] = {}
        for call in ("first", "second"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            chains[name] = fn(**kw)
            end.record()
            torch.cuda.synchronize()
            times[name][call] = {
                "host_ms": 1e3 * (time.perf_counter() - t0),
                "events_ms": start.elapsed_time(end)}
        t = times[name]
        line = (f"[{tag}] compute_{name}: first call host "
                f"{t['first']['host_ms']:.1f} ms, CUDA events "
                f"{t['first']['events_ms']:.1f} ms; second call host "
                f"{t['second']['host_ms']:.1f} ms, CUDA events "
                f"{t['second']['events_ms']:.1f} ms")
        if PROFILE_DERIVED:
            t0 = time.perf_counter()
            _, busy = _profiled_busy_ms(lambda: fn(**kw))
            t["profiled"] = {"host_ms": 1e3 * (time.perf_counter() - t0),
                             "busy_ms": busy}
            line += ("; a third call under torch.profiler: device busy "
                     + ("not measured" if busy is None else f"{busy:.2f} ms")
                     + f" of {t['profiled']['host_ms']:.1f} ms on the host")
        log(f"{line} ({card})")
    return chains, times


def phase_time(card):
    """Kernel against plain torch on the card at the main path's shape:
    250 walkers x 5 bands, full 5-parameter model (config 2)."""
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import EnsembleSampler

    phot, shape, spec = problem(2)
    samp = FusedSampler(NWALKERS, phot, shape, spec, device=DEVICE)
    p0 = _ball(samp.free_space, NWALKERS, 6, DEVICE)
    state = samp.init_state(p0, seed=77)
    out = {}
    out["k1_ms"] = _cuda_ms(lambda: mbb_lnprob(p0, samp.ops), 200)
    out["k1_plain_ms"] = _cuda_ms(lambda: samp.ops.plain(p0), 50)
    out["k2_ms"] = _cuda_ms(lambda: samp.run_mcmc(state, 200), 5)
    plain = EnsembleSampler(NWALKERS, samp.ndim, samp.ops.plain, a=samp.a)
    out["k2_plain_ms"] = _cuda_ms(lambda: plain.run_mcmc(state, 200), 1)
    nconsts = samp.ops.consts.numel()
    out["k1_bound"] = k1_bound(samp.ops.icfg, NWALKERS, samp.ndim, nconsts)
    out["k2_bound"] = k2_bound(samp.ops.icfg, 1, NWALKERS, samp.ndim,
                               nconsts, 200, 200)
    k1_dev = _profiled_device_us(lambda: mbb_lnprob(p0, samp.ops), 50,
                                 "mbb_lnprob_kernel")
    k2_dev = _profiled_device_us(lambda: samp.run_mcmc(state, 200), 3,
                                 "mbb_stretch_kernel")
    t1 = min(_host_s(lambda: samp.run_mcmc(state, 1000)) for _ in range(3))
    t3 = min(_host_s(lambda: samp.run_mcmc(state, 3000)) for _ in range(3))
    rate = NWALKERS * 2000 / (t3 - t1)
    rate_plain = NWALKERS * 200 / (out["k2_plain_ms"] / 1e3)
    log(f"[6] K1 lnprob, 250 walkers: kernel {out['k1_ms']:.4f} ms, plain "
        f"torch {out['k1_plain_ms']:.4f} ms per call ({card})")
    log("[6] torch.profiler device time per launch: K1 "
        + ("not measured" if k1_dev is None else f"{k1_dev:.2f} us")
        + ", K2 (200 steps) "
        + ("not measured" if k2_dev is None else f"{k2_dev:.1f} us")
        + f" ({card})")
    log(f"[6] bounds (fp32 operations at {PEAK_FP32_OPS:.3g}/s or bytes at "
        f"{PEAK_BYTES:.3g} B/s, the larger): K1 {1e3 * out['k1_bound'][0]:.4g}"
        f" us ({out['k1_bound'][1]}, {lnprob_ops(samp.ops.icfg)} ops per "
        f"lnprob), K2 {1e3 * out['k2_bound'][0]:.4g} us "
        f"({out['k2_bound'][1]})")
    log(f"[6] K2 run, 250 walkers x 200 steps: kernel {out['k2_ms']:.3f} "
        f"ms, plain torch {out['k2_plain_ms']:.1f} ms ({card})")
    log(f"[6] kernel sampler: 1000 steps {t1 * 1e3:.2f} ms, 3000 steps "
        f"{t3 * 1e3:.2f} ms -> marginal {rate:,.0f} walker-steps/s "
        f"({card})")
    log(f"[6] plain torch sampler: {rate_plain:,.0f} walker-steps/s over "
        f"200 steps ({card})")
    return out


def batch_data(nsrc, seed, missing_every=0):
    """Config 2 (full 5-parameter model) mock photometry for `nsrc` sources:
    per-source noise from numpy seeds seed..seed+nsrc-1, and band 0 missing
    (NaN) in every `missing_every`-th source. Returns (flux, unc) (S, 5)."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    rows = [vp.mock_data(vp.CONFIGS[2], seed=seed + s) for s in range(nsrc)]
    flux = np.stack([r[0] for r in rows])
    unc = np.stack([r[1] for r in rows])
    if missing_every:
        flux[1::missing_every, 0] = np.nan
        unc[1::missing_every, 0] = np.nan
    return flux, unc


def batch_fitter(flux, unc, redshifts=None, **kw):
    """A port MultiFitter on `flux`/`unc` with config 2's box and priors."""
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MultiFitter
    kw.setdefault("device", DEVICE)
    mf = MultiFitter(nwalkers=NWALKERS, **kw)
    mf.set_data(vp.WAVE, flux, unc, redshifts=redshifts)
    mf.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    for (pi, mean, sig) in vp.CONFIGS[2]["priors"]:
        mf.set_gaussian_prior(pi, mean, sig)
    return mf


def _compare_multi(tag, got, want, bitwise=False):
    """K3 and plain multi runs -> max abs chain difference; raises unless
    the chains agree within K2's replay tolerances (or bitwise), the lnprob
    within K2's, and the accept counts exactly."""
    import numpy as np
    (sg, cg, lg), (sw, cw, lw) = got, want
    cg, cw = cg.cpu().numpy(), cw.cpu().numpy()
    lg, lw = lg.cpu().numpy(), lw.cpu().numpy()
    ok_c = (np.array_equal(cg, cw) if bitwise
            else np.allclose(cg, cw, rtol=K2_RTOL, atol=K2_ATOL))
    ok_l = np.allclose(lg, lw, rtol=K2_RTOL, atol=K2_LNP_ATOL)
    ok_a = np.array_equal(sg.naccept.cpu().numpy(), sw.naccept.cpu().numpy())
    ok_f = bool(np.isfinite(lg).all())
    dmax = float(np.abs(cg - cw).max())
    log(f"[{tag}] chain max |d| {dmax:.3g}"
        + (" (bitwise required)" if bitwise else "")
        + f", lnp max |d| {float(np.abs(lg - lw).max()):.3g}, accepts "
        f"{int(sg.naccept.sum())} vs {int(sw.naccept.sum())} "
        f"{'PASS' if ok_c and ok_l and ok_a and ok_f else 'FAIL'}")
    if not (ok_c and ok_l and ok_a and ok_f):
        raise AssertionError(f"[{tag}] K3 run disagrees with plain")
    return dmax


def _multi_ball(free_space, nsrc, seed):
    import torch
    return torch.stack([_ball(free_space, NWALKERS, seed + s, DEVICE)
                        for s in range(nsrc)])


def phase_k3():
    """K3 in external-uniforms mode against the plain multi run on the
    card: 5 sources x 250 walkers, 3 records x thin 2, per case."""
    import dataclasses
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    nsrc = 5
    flux, unc = batch_data(nsrc, seed=100, missing_every=3)
    _, shape, spec = problem(2)
    ul = np.zeros((nsrc, 5), bool)
    ul[0, 4] = ul[3, 3] = True
    ul[1, 0] = True            # a limit on source 1's MISSING band: weight 0
    mf = batch_fitter(flux, unc)
    mf.set_band_correlation(vp.CAL_CORR)
    whiten = mf._whiten_operand()
    cases = [
        ("uplims + missing band", dict(spec=dataclasses.replace(
            spec, uplim_bands=ul))),
        ("band correlation + missing band", dict(spec=spec, whiten=whiten)),
        ("response 5x65 + uplims", dict(
            spec=dataclasses.replace(spec, uplim_bands=ul),
            response_pack=numpy_response_pack(vp.WAVE)))]
    worst = 0.0
    for name, kw in cases:
        samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape,
                                 rng="external", device=DEVICE, **kw)
        state = samp.init_state(_multi_ball(samp.free_space, nsrc, 20),
                                seed=3)
        nrec, thin = 3, 2
        u = np.random.default_rng(11).uniform(
            0.001, 0.999, (nsrc, nrec, 6 * thin, samp.half))
        u = torch.as_tensor(u.astype(np.float32), device=DEVICE)
        got = samp.run_mcmc(state, nrec * thin, thin, uniforms=u)
        want = multi_stretch_run_plain(state, samp.ops.plain, nrec, thin,
                                       samp.a, u)
        log(f"[7] K3 {name}: {nsrc} sources x {NWALKERS} walkers, "
            f"{nrec} records x thin {thin}")
        worst = max(worst, _compare_multi("7", got, want))
    return worst


def phase_k3_philox():
    """K3 in Philox mode: twice with one seed bitwise equal; the plain
    multi run drawing the same per-source streams replays it; for one
    source it is K2 bitwise."""
    import dataclasses
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    nsrc = 5
    flux, unc = batch_data(nsrc, seed=200, missing_every=3)
    phot, shape, spec = problem(2)
    samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape, spec,
                             device=DEVICE)
    state = samp.init_state(_multi_ball(samp.free_space, nsrc, 30),
                            seed=0x5EED_1234_ABCD)
    r1 = samp.run_mcmc(state, 200, thin=10)
    r2 = samp.run_mcmc(state, 200, thin=10)
    same = (torch.equal(r1[1], r2[1]) and torch.equal(r1[2], r2[2])
            and torch.equal(r1[0].naccept, r2[0].naccept))
    log(f"[8] K3 Philox mode, same seed twice: chains bitwise "
        f"{'equal PASS' if same else 'DIFFERENT FAIL'}")
    if not same:
        raise AssertionError("K3 chains are not deterministic")
    r3 = samp.run_mcmc(dataclasses.replace(state, seed=state.seed + 1), 200,
                       thin=10)
    if torch.equal(r1[1], r3[1]) or torch.equal(r1[1][0], r1[1][1]):
        raise AssertionError("another seed or source gave the same chain")
    log("[8] another seed, and another source, give another chain PASS")
    got = samp.run_mcmc(state, 6, thin=2)
    want = multi_stretch_run_plain(state, samp.ops.plain, 3, 2, samp.a)
    _compare_multi("8", got, want, bitwise=True)

    single = FusedSampler(NWALKERS, phot, shape, spec, device=DEVICE)
    one = FusedMultiSampler(NWALKERS, vp.WAVE, phot.flux[None],
                            phot.unc[None], shape, spec, device=DEVICE)
    p0 = _ball(single.free_space, NWALKERS, 4, DEVICE)
    a = single.run_mcmc(single.init_state(p0, seed=77), 200, thin=10)
    b = one.run_mcmc(one.init_state(p0[None], seed=77), 200, thin=10)
    same = (torch.equal(a[1], b[1][0]) and torch.equal(a[2], b[2][0])
            and torch.equal(a[0].naccept, b[0].naccept[0])
            and torch.equal(a[0].position, b[0].pos[0]))
    log(f"[8] K3 with one source against K2, same seed and likelihood: "
        f"chains, lnprob and accepts bitwise "
        f"{'equal PASS' if same else 'DIFFERENT FAIL'}")
    if not same:
        raise AssertionError("K3 at S=1 differs from K2")


def cell_sampler():
    """K3's sampler and a Philox start state at the batch cell's shape:
    256 sources x 250 walkers x 5 bands, full 5-parameter model."""
    flux, unc = batch_data(NSOURCES, seed=3000)
    mf = batch_fitter(flux, unc)
    samp = mf._build_sampler(mf._effective_spec())
    state = samp.init_state(_multi_ball(samp.free_space, NSOURCES, 40),
                            seed=77)
    return samp, state


def _replay_record(samp, pos, seed, step, thin):
    """One record (`thin` single steps) of every source from positions
    `pos` at Philox step `step`, on K3 and on the plain multi run: the
    (chain, lnpchain) of each."""
    import torch
    from mbb_emcee_tpu_torch.ops.multifit_kernel import mbb_multi_stretch_run
    from mbb_emcee_tpu_torch.sampler import (
        MultiSamplerState, multi_stretch_run_plain)
    st = MultiSamplerState(
        pos=pos.contiguous(), lnp=torch.zeros(pos.shape[:2], device=DEVICE),
        naccept=torch.zeros(pos.shape[:2], dtype=torch.int32, device=DEVICE),
        nsteps=0, seed=seed, step=step)
    _, ck, lk = mbb_multi_stretch_run(st, samp.ops, thin, 1, samp.a,
                                      source0=samp.source0)
    _, cp, lp = multi_stretch_run_plain(st, samp.ops.plain, thin, 1, samp.a,
                                        source0=samp.source0)
    return (ck, lk), (cp, lp)


def _parting_margin(samp, pos, seed, step, replay, s):
    """Where source s parts in a replayed record: the walkers of the first
    half-step whose K3 and plain positions differ, each held to
    _decision_margin. Returns (t, max distance, max tolerance)."""
    import torch
    from mbb_emcee_tpu_torch.ops.philox import stretch_uniforms
    (ck, _), (cp, lp) = replay
    ck, cp, lp = ck[s], cp[s], lp[s]
    half = pos.shape[1] // 2
    parted = (ck != cp).any(-1)
    if not parted.any():
        raise AssertionError(f"source {s} does not part in its replay")
    t = int(torch.nonzero(parted.any(-1))[0])
    hb = int(not parted[t, :half].any())        # 0: half A, 1: half B
    act = slice(half * hb, half * (hb + 1))
    if t == 0:
        # the plain run's first call: both halves recomputed from pos
        prev, lnp_prev = pos[s], samp.ops.plain(pos[:, act])[s]
    else:
        prev, lnp_prev = cp[t - 1], lp[t - 1, act]
    u3 = stretch_uniforms(seed, step + t, 1, half, DEVICE,
                          source=[samp.source0 + s])[0, 3 * hb:3 * hb + 3]

    def lnp_of(prop):
        batch = pos[:, :half].clone()
        batch[s] = prop
        return samp.ops.plain(batch)[s]
    dist, tol = _decision_margin(
        f"source {s} record step {t}", samp.a, prev[act],
        cp[t, :half] if hb else prev[half:], u3, lnp_prev, lnp_of,
        (ck[t, act], cp[t, act]), torch.nonzero(parted[t, act]).flatten())
    return t, dist, tol


def _decision_margin(where, a, active, passive, u3, lnp_prev, lnp_of, sides,
                     lanes):
    """The half update of `active` against `passive` on uniform rows u3
    (z, partner, accept): each side's new position of each parting walker
    (`lanes`) must be its proposal or its previous position, and the accept
    decision must sit within rounding of its threshold: |log ratio - log u|
    (on the plain lnprob `lnp_of` of the proposals) no more than the lnprob
    replay tolerance of the two lnprob values the ratio differences.
    Returns (max distance, max tolerance); raises otherwise (a wrong
    stream, partner or stride)."""
    import torch
    half, nfree = active.shape
    z = ((a - 1.0) * u3[0] + 1.0) ** 2 / a
    j = torch.clamp((u3[1] * half).to(torch.int64), max=half - 1)
    prop = passive[j] + z[:, None] * (active - passive[j])
    lnp_prop = lnp_of(prop)
    for side in sides:
        new = side[lanes]
        if not ((new == prop[lanes]).all(-1)
                | (new == active[lanes]).all(-1)).all():
            raise AssertionError(
                f"{where}: a parting walker's position is neither its "
                "proposal nor its previous position")
    log_ratio = (nfree - 1) * torch.log(z) + lnp_prop - lnp_prev
    dist = (log_ratio - torch.log(u3[2]))[lanes].abs()
    tol = (2 * K2_LNP_ATOL + K2_RTOL * (lnp_prop.abs() + lnp_prev.abs()))[
        lanes]
    if not (dist <= tol).all():
        raise AssertionError(
            f"{where}: parts on a decision {float(dist.max()):.3g} from its "
            "threshold: not a rounding")
    return float(dist.max()), float(tol.max())


def _compare_multi_width(tag, samp, state, got, want, thin):
    """K3 against the plain multi run at a width where lnprob rounding (a
    few ulp) can tip an accept decision that sits on its threshold. Every
    source's chain must equal the plain one bitwise, with lnprob within
    K2's replay tolerance and accept counts equal, up to the record where
    it parts, if it parts; a parting source must part at such a decision
    (_parting_margin, on a single-step replay of that record). Returns the
    max abs chain difference over the sources that never part."""
    import numpy as np
    import torch
    (sg, cg, lg), (sw, cw, lw) = got, want
    rec_parted = (cg != cw).any(-1).any(-1)             # (S, nrec)
    parted = rec_parted.any(-1).cpu().numpy()
    first = torch.argmax(rec_parted.to(torch.int8), dim=1).cpu().numpy()
    cg_, cw_ = cg.cpu().numpy(), cw.cpu().numpy()
    lg_, lw_ = lg.cpu().numpy(), lw.cpu().numpy()
    ag, aw = sg.naccept.cpu().numpy(), sw.naccept.cpu().numpy()
    nrec = cg_.shape[1]
    upto = np.where(parted, first, nrec)
    ok_l = all(np.allclose(lg_[s, :upto[s]], lw_[s, :upto[s]],
                           rtol=K2_RTOL, atol=K2_LNP_ATOL)
               for s in range(cg_.shape[0]))
    ok_a = np.array_equal(ag[~parted], aw[~parted])
    ok_f = bool(np.isfinite(lg_).all())
    dmax = float(np.abs(cg_[~parted] - cw_[~parted]).max(initial=0.0))
    notes, replays = [], {}
    for s in np.nonzero(parted)[0]:
        r = int(first[s])
        pos = state.pos if r == 0 else cw[:, r - 1]
        step = state.step + r * thin
        if r not in replays:
            replays[r] = _replay_record(samp, pos, state.seed, step, thin)
        t, dist, tol = _parting_margin(samp, pos, state.seed, step,
                                       replays[r], int(s))
        notes.append(f"source {s} at step {r * thin + t}: |log ratio - "
                     f"log u| {dist:.3g} <= {tol:.3g}")
    ok = ok_l and ok_a and ok_f and dmax == 0.0
    nsrc = cg_.shape[0]
    log(f"[{tag}] {nsrc - parted.sum()}/{nsrc} sources bitwise equal over "
        f"{nrec * thin} steps (lnp within tolerance, accepts equal); "
        f"{parted.sum()} parted on an accept decision within rounding of "
        f"its threshold" + (": " + "; ".join(notes) if notes else "")
        + f" {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] K3 run disagrees with plain")
    return dmax


def phase_k3_width():
    """K3 against the plain multi run, both drawing the per-source Philox
    streams, at the shapes the batch path gives it: the batch cell (256
    sources x 250 walkers) and MBBFitter(n_ensembles=4) on config 1 (4
    sources), 200 steps thinned by 10 each."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    samp, state = cell_sampler()
    got = samp.run_mcmc(state, 200, thin=10)
    want = multi_stretch_run_plain(state, samp.ops.plain, 20, 10, samp.a)
    log(f"[8] K3 at the batch cell's width: {NSOURCES} sources x {NWALKERS} "
        f"walkers, 20 records x thin 10")
    worst = _compare_multi_width("8", samp, state, got, want, 10)

    phot, shape, spec = problem(1)
    k = 4
    samp = FusedMultiSampler(
        NWALKERS, vp.WAVE, np.broadcast_to(phot.flux, (k, 5)),
        np.broadcast_to(phot.unc, (k, 5)), shape, spec, device=DEVICE)
    state = samp.init_state(_multi_ball(samp.free_space, k, 50), seed=1234)
    got = samp.run_mcmc(state, 200, thin=10)
    want = multi_stretch_run_plain(state, samp.ops.plain, 20, 10, samp.a)
    log(f"[8] K3 at MBBFitter(n_ensembles={k})'s shape: config 1, {k} "
        f"sources x {NWALKERS} walkers, 20 records x thin 10")
    return max(worst, _compare_multi_width("8", samp, state, got, want, 10))


def _k3_counts(path, reset=False):
    """Zero the launch and run counts (reset=True) just before entry point
    `path`, or read them just after it and require exactly its 3 K3
    launches (burn, re-burn, production) and no plain multi run. Returns
    the K3 launch count."""
    if reset:
        _counts(reset=True)
        return 0
    c = _counts()
    n, plain = c["mbb_multi_stretch_run"], c["plain_multi_runs"]
    ok = n == 3 and plain == 0
    log(f"[9] {path}: {n} K3 launches, {plain} plain multi runs "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{path} did not run through K3 alone, once "
                             "per phase")
    return n


def phase_batch_path(card):
    """The batch path through the user's entry points, with K3's launch
    count taken over each entry point's run; the batch's derived posteriors
    timed per quantity and call (time_derived) with the chunks each takes.
    Returns (the counts, the derived posteriors' times)."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBFitter

    with open(vp.SENTINEL_PATH) as fh:
        reference = json.load(fh)["configs"]
    geom = vp.SENTINEL
    by_path = {}

    # (a) MBBFitter(n_ensembles=4), sentinel config 1 at its geometry
    ci, k = vp.SENTINEL_CONFIG, 4
    cfg = vp.CONFIGS[ci]
    free = vp.free_indices(cfg)
    flux, unc, cov = vp.mock_data(cfg)
    fit = MBBFitter(nwalkers=NWALKERS, seed=1000, opthin=cfg["opthin"],
                    noalpha=cfg["noalpha"], device=DEVICE, n_ensembles=k)
    fit.set_data(vp.WAVE, flux, unc, cov=cov)
    fit.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    for (pi, mean, sig) in cfg["priors"]:
        fit.set_gaussian_prior(pi, mean, sig)
    for i in range(5):
        fit.set_param_init(i, vp.TRUE[i])
    path = f"MBBFitter(n_ensembles={k})"
    _k3_counts(path, reset=True)
    fit.run(nburn=geom.nburn_jax, nsteps=geom.nstep_jax)
    by_path[path] = _k3_counts(path)
    mf = fit._mf
    if mf._backend_used != "fused":
        raise AssertionError("n_ensembles > 1 did not select K3")
    chains, chains_free = mf.chain, mf.chain_free.double().cpu().numpy()
    meds, wids, ses = [], [], []
    for e in range(k):
        flat = chains[e].reshape(-1, 5)
        m, w = vp.stats(flat, free)
        meds.append(m)
        wids.append(w)
        ses.append(tau_se(chains_free[e], flat, free))
    mj, wj, sjm, sjw = vp.aggregate(meds, wids, ses)
    ok, lines = vp.check_sentinel(
        {"medians": mj, "widths": wj, "se_medians": sjm, "se_widths": sjw},
        reference[str(ci)])
    log(f"[9] MBBFitter(n_ensembles={k}) {cfg['label']}: {k} ensembles x "
        f"{NWALKERS} walkers x ({geom.nburn_jax} burn + {geom.nstep_jax} "
        f"steps) against the recorded fp64 oracle moments; merged chain "
        f"{tuple(fit.chain_free.shape)}, cross-ensemble split-R-hat max "
        f"{np.nanmax(fit.gelman_rubin()):.4f}:")
    for line in lines:
        log(f"[9]   {line}")
    if not ok:
        raise AssertionError(f"n_ensembles={k}: posterior off the recorded "
                             "oracle moments")

    # (b) MultiFitter at the batch cell's width
    flux, unc = batch_data(NSOURCES, seed=1000, missing_every=16)
    z = np.random.default_rng(5).uniform(0.5, 4.0, NSOURCES)
    mf = batch_fitter(flux, unc, redshifts=z, seed=4321)
    path = f"MultiFitter {NSOURCES}x{NWALKERS}"
    _k3_counts(path, reset=True)
    t1 = time.time()
    mf.run(nburn=50, nsteps=250)
    t_run = time.time() - t1
    by_path[path] = _k3_counts(path)
    if mf._backend_used != "fused":
        raise AssertionError("MultiFitter did not select K3")
    shape_ok = tuple(mf.chain_free.shape) == (NSOURCES, 250, NWALKERS, 5)
    cen = {p: mf.par_cen(p) for p in mf.free_param_names}
    rhat = mf.gelman_rubin()
    # count the chunks MultiFitter._chunked_samples cuts each quantity into
    chunks, chunked = [], mf._chunked_samples

    def counting(fn, samples, inner_elems):
        def counted(part):
            chunks[-1] += 1
            return fn(part)
        chunks.append(0)
        return chunked(counted, samples, inner_elems)
    mf._chunked_samples = counting
    t2 = time.time()
    derived, derived_times = time_derived("9", mf, card)
    t_derived = time.time() - t2
    del mf._chunked_samples
    log(f"[9] chunks per call of _chunked_samples (lir, dustmass, "
        f"peaklambda; every call): {chunks}")
    derived_times["chunks"] = chunks
    finite = (shape_ok and all(np.isfinite(c).all() for c in cen.values())
              and np.isfinite(rhat).all()
              and all(np.isfinite(d).all() and d.shape == (
                  NSOURCES, 250 * NWALKERS) for d in derived.values()))
    af = mf.acceptance_fraction.mean(axis=1)
    log(f"[9] MultiFitter {NSOURCES} sources x {NWALKERS} walkers x 5 bands "
        f"(band 0 missing in {len(range(1, NSOURCES, 16))} sources), run("
        f"nburn=50, nsteps=250) {t_run:.2f} s, derived posteriors "
        f"{t_derived:.2f} s (host clock, every timed call of the three)")
    log(f"[9]   acceptance per source {af.min():.3f}..{af.max():.3f}; "
        f"split-R-hat max {rhat.max():.3f}; T median of medians "
        f"{np.median(cen['T'][:, 0]):.4g}; lir_cen[0] "
        f"{mf.lir_cen()[0, 0]:.5g}, dustmass_cen[0] "
        f"{mf.dustmass_cen()[0, 0]:.5g}, peaklambda_cen[0] "
        f"{mf.peaklambda_cen()[0, 0]:.5g} "
        f"{'PASS' if finite else 'FAIL'}")
    if not finite:
        raise AssertionError("batch summaries or posteriors not finite")
    return by_path, derived_times


def phase_time_k3(card):
    """K3 against the plain multi run on the card at the batch cell's shape:
    256 sources x 250 walkers x 5 bands, full 5-parameter model."""
    from mbb_emcee_tpu_torch.ops.multifit_kernel import mbb_multi_stretch_run
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    samp, state = cell_sampler()
    out = {}
    out["k3_ms"] = _cuda_ms(lambda: samp.run_mcmc(state, 200, thin=10), 5)
    out["k3_plain_ms"] = _cuda_ms(lambda: multi_stretch_run_plain(
        state, samp.ops.plain, 20, 10, samp.a), 1)
    out["k3_bound"] = k2_bound(
        samp.ops.icfg, NSOURCES, NWALKERS, samp.ndim,
        samp.ops.consts.numel() + samp.ops.flux.numel()
        + samp.ops.errs.numel(), 200, 20)
    k3_dev = _profiled_device_us(
        lambda: mbb_multi_stretch_run(state, samp.ops, 20, 10, samp.a), 3,
        "mbb_multi_stretch_kernel")
    t1 = min(_host_s(lambda: samp.run_mcmc(state, 1000, thin=10))
             for _ in range(3))
    t3 = min(_host_s(lambda: samp.run_mcmc(state, 3000, thin=10))
             for _ in range(3))
    walkers = NSOURCES * NWALKERS
    rate = walkers * 2000 / (t3 - t1)
    rate_plain = walkers * 200 / (out["k3_plain_ms"] / 1e3)
    log(f"[10] K3 run, {NSOURCES} sources x {NWALKERS} walkers x 200 steps: "
        f"kernel {out['k3_ms']:.3f} ms, plain torch multi run "
        f"{out['k3_plain_ms']:.1f} ms ({card})")
    log("[10] torch.profiler device time per K3 launch (200 steps): "
        + ("not measured" if k3_dev is None else f"{k3_dev:.1f} us")
        + f"; bound {1e3 * out['k3_bound'][0]:.4g} us "
        f"({out['k3_bound'][1]}) ({card})")
    log(f"[10] K3 sampler: 1000 steps {t1 * 1e3:.2f} ms, 3000 steps "
        f"{t3 * 1e3:.2f} ms (thin 10) -> marginal {rate:,.0f} aggregate "
        f"walker-steps/s, {rate / NSOURCES:,.0f} per source ({card})")
    log(f"[10] plain torch multi run: {rate_plain:,.0f} aggregate "
        f"walker-steps/s over 200 steps ({card})")

    # response mode at the batch cell's width: config 3's model on its
    # 5 x 65 pack, per-source fluxes
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    flux, unc = sweep_data(3, NSOURCES, seed=3001)
    _, shape, spec = problem(3)
    samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape, spec,
                             response_pack=port_response_pack(65)[1],
                             device=DEVICE)
    state = samp.init_state(_multi_ball(samp.free_space, NSOURCES, 40),
                            seed=77)
    out["k3_resp_ms"] = _cuda_ms(lambda: samp.run_mcmc(state, 200, thin=10),
                                 3)
    out["k3_resp_plain_ms"] = _cuda_ms(lambda: multi_stretch_run_plain(
        state, samp.ops.plain, 20, 10, samp.a), 1)
    out["k3_resp_bound"] = k2_bound(
        samp.ops.icfg, NSOURCES, NWALKERS, samp.ndim,
        samp.ops.consts.numel() + samp.ops.flux.numel()
        + samp.ops.errs.numel(), 200, 20)
    t1 = min(_host_s(lambda: samp.run_mcmc(state, 1000, thin=10))
             for _ in range(2))
    t3 = min(_host_s(lambda: samp.run_mcmc(state, 3000, thin=10))
             for _ in range(2))
    out["k3_resp_rate"] = walkers * 2000 / (t3 - t1)
    out["k3_rate"] = rate
    log(f"[10] K3 response mode, {NSOURCES} sources x {NWALKERS} walkers x "
        f"5 bands x 65 nodes x 200 steps: kernel {out['k3_resp_ms']:.3f} ms "
        f"(CUDA events), plain torch multi run "
        f"{out['k3_resp_plain_ms']:.1f} ms; bound "
        f"{1e3 * out['k3_resp_bound'][0]:.4g} us "
        f"({out['k3_resp_bound'][1]}; {lnprob_ops(samp.ops.icfg)} ops per "
        f"lnprob) ({card})")
    log(f"[10] K3 response sampler: 1000 steps {t1 * 1e3:.2f} ms, 3000 "
        f"steps {t3 * 1e3:.2f} ms (thin 10) -> marginal "
        f"{out['k3_resp_rate']:,.0f} aggregate walker-steps/s, "
        f"{out['k3_resp_rate'] / NSOURCES:,.0f} per source; point mode "
        f"{rate:,.0f} ({card})")
    if not np.isfinite(out["k3_resp_rate"]) or out["k3_resp_rate"] <= 0:
        raise AssertionError("K3 response-mode rate not measured")
    return out


# Eight built-in bands for the packs above the kernels' old fixed staging
# (65 nodes x 32 bands per array, 2080 floats).
WIDE_BANDS = ["PACS_70", "PACS_100", "PACS_160", "SPIRE_250", "SPIRE_350",
              "SPIRE_500", "SCUBA2_850", "AZTEC_1100"]


def response_case(names, nnodes, ci=3):
    """(phot, shape, spec, pack): config ci's model, box and priors on the
    built-in bands `names` at `nnodes` nodes each, with photometry at the
    bands' effective wavelengths from the true SED through the pack, 5%
    errors and noise from numpy seed 7."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.likelihood import Photometry
    from mbb_emcee_tpu_torch.models.modified_blackbody import mbb_fnu
    from mbb_emcee_tpu_torch.response import ResponseSet
    rs = ResponseSet.builtin(names, nnodes=nnodes)
    pack = rs.pack(names)
    _, shape, spec = problem(ci)
    sed = mbb_fnu(torch.tensor(vp.TRUE[None], dtype=torch.float32),
                  torch.as_tensor(pack[0]), shape)[0].double().numpy()
    f = (pack[1] * sed).sum(axis=-1)
    unc = 0.05 * f
    flux = f + unc * np.random.default_rng(7).standard_normal(f.size)
    wave = np.array([rs[n].effective_wavelength for n in names])
    return Photometry(wave, flux, unc, band_names=list(names)), shape, spec, \
        pack


def _k1_case(tag, name, phot, shape, spec, pack, rtol=K1_RTOL,
             atol=K1_ATOL):
    """K1 against the plain version on 4096 vectors, about 10% out of the
    box (which both must floor at exactly LNPROB_FLOOR); returns the max abs
    difference."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.likelihood import LNPROB_FLOOR
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        lnprob_smem_bytes, mbb_lnprob, prepare_lnprob_inputs)
    ops = prepare_lnprob_inputs(phot, shape, spec, pack, device=DEVICE)
    th, bad = thetas(ops.free_space)
    x = torch.as_tensor(th, device=DEVICE)
    got = mbb_lnprob(x, ops).double().cpu().numpy()
    want = ops.plain(x).double().cpu().numpy()
    floor_g = got <= LNPROB_FLOOR / 2
    floor_w = want <= LNPROB_FLOOR / 2
    if not np.array_equal(floor_g, floor_w) or not floor_w[bad].all():
        raise AssertionError(f"K1 {name}: out-of-box floor mismatch")
    if not np.all(got[floor_g] == np.float32(LNPROB_FLOOR)):
        raise AssertionError(f"K1 {name}: floor is not LNPROB_FLOOR")
    m = ~floor_w
    dabs = np.abs(got[m] - want[m])
    ok = np.all(dabs <= atol + rtol * np.abs(want[m]))
    nb, nn = int(ops.icfg[3]), int(ops.icfg[4])
    log(f"[{tag}] K1 {name} ({nb} x {nn} nodes, "
        f"{lnprob_smem_bytes(nb, nn)} B of shared memory "
        f"per block): {m.sum()} in box, {(~m).sum()} floored; max |d| "
        f"{dabs.max():.3g}, max rel "
        f"{(dabs / np.maximum(np.abs(want[m]), 1e-30)).max():.3g} (rtol "
        f"{rtol:g}, atol {atol:g}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 {name} disagrees with plain torch")
    return float(dabs.max())


def _k2_replay(tag, phot, shape, spec, pack):
    """K2 in external-uniforms mode against the plain replay (phase 3's
    check) on a response pack; reports whether the chains are bitwise."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import stretch_run_plain
    samp = FusedSampler(NWALKERS, phot, shape, spec, response_pack=pack,
                        rng="external", device=DEVICE)
    state = samp.init_state(_ball(samp.free_space, NWALKERS, 2, DEVICE),
                            seed=3)
    nrec, thin = 3, 2
    u = np.random.default_rng(11).uniform(
        0.001, 0.999, (nrec, 6 * thin, samp.half)).astype(np.float32)
    u = torch.as_tensor(u, device=DEVICE)
    got = samp.run_mcmc(state, nrec * thin, thin, uniforms=u)
    want = stretch_run_plain(state, samp.ops.plain, nrec, thin, samp.a, u)
    log(f"[{tag}] chains bitwise equal: "
        f"{'yes' if torch.equal(got[1], want[1]) else 'no'}")
    return _compare_runs(tag, got, want)


def phase_response_kernels():
    """K1, K2 and K3 against their plain versions on response packs: config
    3's 5 x 65, 5 x 129, and two 8-band packs above the old staging cap
    (the second above 48 KB of shared memory per block); K2 on the 5 x 65,
    5 x 129 and 8 x 1000 packs, K3 on the 5 x 129 pack. Returns the max
    abs differences (K1, K2, K3)."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    phot3, shape3, spec3 = problem(3)
    _, pack65 = port_response_pack(65)
    cases = [("config 3 builtin", phot3, pack65),
             ("builtin:129", phot3, port_response_pack(129)[1])]
    for nn in (400, 1000):
        phot, _, _, pack = response_case(WIDE_BANDS, nn)
        cases.append((f"8 bands x builtin:{nn}", phot, pack))
    k1 = max(_k1_case("11", name, phot, shape3, spec3, pack)
             for name, phot, pack in cases)
    k2 = 0.0
    for name, pack in (("5 x 65 pack (the main path's)", pack65),
                       ("5 x 129 pack", cases[1][2])):
        log(f"[11] K2 replay, config 3 on the {name}: {NWALKERS} walkers, "
            f"3 records x thin 2")
        k2 = max(k2, _k2_replay("11", phot3, shape3, spec3, pack))
    log(f"[11] K2 replay on the 8 x 1000 pack")
    k2 = max(k2, _k2_replay("11", cases[3][1], shape3, spec3, cases[3][2]))

    nsrc = 5
    rng = np.random.default_rng(300)
    flux = phot3.flux[None] * rng.uniform(0.8, 1.2, (nsrc, 1))
    unc = np.broadcast_to(phot3.unc, (nsrc, 5)).copy()
    samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape3, spec3,
                             response_pack=cases[1][2], rng="external",
                             device=DEVICE)
    state = samp.init_state(_multi_ball(samp.free_space, nsrc, 60), seed=3)
    nrec, thin = 3, 2
    u = np.random.default_rng(12).uniform(
        0.001, 0.999, (nsrc, nrec, 6 * thin, samp.half))
    u = torch.as_tensor(u.astype(np.float32), device=DEVICE)
    got = samp.run_mcmc(state, nrec * thin, thin, uniforms=u)
    want = multi_stretch_run_plain(state, samp.ops.plain, nrec, thin,
                                   samp.a, u)
    log(f"[11] K3 on the 5 x 129 pack: {nsrc} sources x {NWALKERS} walkers, "
        f"{nrec} records x thin {thin}")
    k3 = _compare_multi("11", got, want)
    return k1, k2, k3


def phase_extend():
    """run(n) against run(n1) + extend(n - n1): MBBFitter on K2 (config 1)
    and MultiFitter on K3 (8 sources, thin 2); chains, lnprob and accept
    counts bitwise. Returns the launch counts over the phase."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp

    ci = 1
    flux, unc, cov = vp.mock_data(vp.CONFIGS[ci])
    _counts(reset=True)
    whole = port_fit(ci, flux, unc, cov, seed=77, nburn=100, nsteps=400)
    part = port_fit(ci, flux, unc, cov, seed=77, nburn=100, nsteps=150)
    part.extend(250)
    same = (torch.equal(whole.chain_free, part.chain_free)
            and torch.equal(whole.lnprobability, part.lnprobability)
            and np.array_equal(whole.acceptance_fraction,
                               part.acceptance_fraction))
    log(f"[12] MBBFitter config 1: run(400) against run(150) + extend(250): "
        f"chains, lnprob and acceptance bitwise "
        f"{'equal PASS' if same else 'DIFFERENT FAIL'}")
    if not same:
        raise AssertionError("run + extend differs from the longer run on K2")

    bflux, bunc = batch_data(8, seed=500)
    runs = []
    for n1 in (400, 150):
        mf = batch_fitter(bflux, bunc, seed=99)
        mf.run(nburn=100, nsteps=n1, thin=2)
        if n1 < 400:
            mf.extend(400 - n1)
        runs.append(mf)
    same = (torch.equal(runs[0].chain_free, runs[1].chain_free)
            and torch.equal(runs[0].lnprobability, runs[1].lnprobability)
            and torch.equal(runs[0].final_state.naccept,
                            runs[1].final_state.naccept))
    counts = _counts()
    log(f"[12] MultiFitter 8 sources, thin 2: run(400) against run(150) + "
        f"extend(250): chains, lnprob and accepts bitwise "
        f"{'equal PASS' if same else 'DIFFERENT FAIL'}")
    log(f"[12] launch counts over the phase: {counts}")
    if not same:
        raise AssertionError("run + extend differs from the longer run on K3")
    if counts["mbb_stretch_run"] != 7 or counts["mbb_multi_stretch_run"] != 7 \
            or counts["plain_sampler_runs"] or counts["plain_multi_runs"]:
        raise AssertionError("the extend phase did not run on K2 and K3 "
                             "alone, once per phase")
    log("[12] checkpoint/resume: HDF5 files need h5py, which the card's "
        "machine lacks; the CPU tests hold checkpointed and resumed runs "
        "bitwise to the uninterrupted chain")
    return counts


def phase_time_response(card):
    """K1 and K2 in response mode against their plain versions at BASELINE
    config 3's shape (250 walkers x 5 bands x 65 nodes, thin model), and
    K2's marginal rate beside point mode on the same model."""
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import EnsembleSampler

    phot, shape, spec = problem(3)
    _, pack = port_response_pack(65)
    out, rates = {}, {}
    for mode, rp in (("point", None), ("response", pack)):
        samp = FusedSampler(NWALKERS, phot, shape, spec, response_pack=rp,
                            device=DEVICE)
        p0 = _ball(samp.free_space, NWALKERS, 6, DEVICE)
        state = samp.init_state(p0, seed=77)
        t1 = min(_host_s(lambda: samp.run_mcmc(state, 1000))
                 for _ in range(3))
        t3 = min(_host_s(lambda: samp.run_mcmc(state, 3000))
                 for _ in range(3))
        rates[mode] = NWALKERS * 2000 / (t3 - t1)
        log(f"[13] K2 {mode} mode, config 3: 1000 steps {t1 * 1e3:.2f} ms, "
            f"3000 steps {t3 * 1e3:.2f} ms -> marginal {rates[mode]:,.0f} "
            f"walker-steps/s ({card})")
    # the response-mode sampler of the last pass
    out["k1_resp_ms"] = _cuda_ms(lambda: mbb_lnprob(p0, samp.ops), 200)
    out["k1_resp_plain_ms"] = _cuda_ms(lambda: samp.ops.plain(p0), 50)
    out["k2_resp_ms"] = _cuda_ms(lambda: samp.run_mcmc(state, 200), 5)
    plain = EnsembleSampler(NWALKERS, samp.ndim, samp.ops.plain, a=samp.a)
    out["k2_resp_plain_ms"] = _cuda_ms(lambda: plain.run_mcmc(state, 200), 1)
    nconsts = samp.ops.consts.numel()
    out["k1_resp_bound"] = k1_bound(samp.ops.icfg, NWALKERS, samp.ndim,
                                    nconsts)
    out["k2_resp_bound"] = k2_bound(samp.ops.icfg, 1, NWALKERS, samp.ndim,
                                    nconsts, 200, 200)
    k1_dev = _profiled_device_us(lambda: mbb_lnprob(p0, samp.ops), 50,
                                 "mbb_lnprob_kernel")
    k2_dev = _profiled_device_us(lambda: samp.run_mcmc(state, 200), 3,
                                 "mbb_stretch_kernel")
    log(f"[13] bounds: K1 {1e3 * out['k1_resp_bound'][0]:.4g} us, K2 "
        f"{1e3 * out['k2_resp_bound'][0]:.4g} us (operations; "
        f"{lnprob_ops(samp.ops.icfg)} ops per lnprob) ({card})")
    log(f"[13] K1 response mode, 250 walkers x 5 x 65: kernel "
        f"{out['k1_resp_ms']:.4f} ms, plain torch "
        f"{out['k1_resp_plain_ms']:.4f} ms per call ({card})")
    log(f"[13] K2 response mode, 250 walkers x 200 steps: kernel "
        f"{out['k2_resp_ms']:.3f} ms, plain torch "
        f"{out['k2_resp_plain_ms']:.1f} ms ({card})")
    log("[13] torch.profiler device time per launch: K1 "
        + ("not measured" if k1_dev is None else f"{k1_dev:.2f} us")
        + ", K2 (200 steps) "
        + ("not measured" if k2_dev is None else f"{k2_dev:.1f} us")
        + f" ({card})")
    log(f"[13] response over point mode, K2 marginal rate: "
        f"{rates['response'] / rates['point']:.4f} ({card})")
    return out


def phase_parity(card, geom=None):
    """The <=1% contract (max(1%, 3 sigma_MC)) of the recorded fp64 oracle
    moments at their FULL geometry (or `geom`, for a rehearsal), through
    MBBFitter.run on the card, as tools/validate_tpu_parity.py's run_config
    and run_derived hold the JAX package. Returns the launch counts over
    the phase."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBResults
    from mbb_emcee_tpu_torch.constants import LSUN_W, MJY_WM2HZ, MPC_M
    from tests.reference_impl.mbb_oracle import ModifiedBlackbodyOracle

    geom = geom or vp.FULL
    data = vp.load_recorded_oracle()
    _counts(reset=True)
    t0 = time.time()
    log(f"[14] {geom.k_jax} fits x {NWALKERS} walkers x ({geom.nburn_jax} "
        f"burn + {geom.nstep_jax} steps) per config against "
        f"tests/data/hwparity_oracle.json:")
    for row in vp.HEADER_ROWS:
        log(f"[14] {row}")
    failed = []
    for ci in vp.ORACLE_CONFIGS:
        status, entry = vp.recorded_entry(ci, data)
        if status != "ok":
            raise AssertionError(f"config {ci}: recorded oracle entry is "
                                 f"{status}")
        cfg = vp.CONFIGS[ci]
        free = vp.free_indices(cfg)
        flux, unc, cov = vp.mock_data(cfg)
        meds, wids = [], []
        for k in range(geom.k_jax):
            fit = port_fit(ci, flux, unc, cov, seed=1000 + 17 * k,
                           nburn=geom.nburn_jax, nsteps=geom.nstep_jax)
            m, w = vp.stats(fit.chain.reshape(-1, 5), free)
            meds.append(m)
            wids.append(w)
        mj, wj, sjm, sjw = vp.aggregate(meds, wids)
        rows, ok = vp.compare_rows(
            cfg["label"], [vp.PARAM_NAMES[i] for i in free], mj, wj, sjm,
            sjw, *(np.asarray(entry[k]) for k in (
                "medians", "widths", "se_medians", "se_widths")))
        for row in rows:
            log(f"[14] {row}")
        if not ok:
            failed.append(cfg["label"])

    # config 4: derived posteriors of a config 2 fit at z = 2.0, thin 8
    status, entry = vp.recorded_entry("derived", data)
    if status != "ok":
        raise AssertionError(f"config 4: recorded oracle entry is {status}")
    flux, unc, _ = vp.mock_data(vp.CONFIGS[2])
    fit = port_fit(2, flux, unc, None, seed=900, nburn=geom.nburn_jax,
                   nsteps=geom.nstep_jax)
    res = MBBResults(fit=fit, redshift=vp.DERIVED_Z)
    log(f"[14] config 4: MBBResults derived posteriors of one fit, "
        f"{fit.chain_free.shape[0] * NWALKERS} samples at thin "
        f"{vp.DERIVED_THIN}:")
    chains4, derived_times = time_derived("14", res, card,
                                          thin=vp.DERIVED_THIN)
    ok4 = True
    for kind in vp.DERIVED_KINDS:
        cj = chains4[kind]
        qj = np.percentile(cj, [15.85, 50.0, 84.15])
        qo = np.asarray(entry["quantiles"][kind])
        dmed = abs(qj[1] - qo[1]) / qo[1]
        dwid = abs((qj[2] - qj[0]) - (qo[2] - qo[0])) / (qo[2] - qo[0])
        tol = max(0.01, 4.5 / np.sqrt(min(len(cj), entry["n"]) / 35.0))
        row_ok = dmed <= tol and dwid <= max(3 * tol, 0.10)
        ok4 &= row_ok
        log(f"[14] | config4 derived | {kind} | {100 * dmed:.2f}% | - | "
            f"{100 * dwid:.2f}% | - | {'PASS' if row_ok else 'FAIL'} |")
    stride = max(len(res.flatchain) // 12, 1)
    samples = res.flatchain[::stride][:12]
    prefac = (4.0 * np.pi * (res._dl_mpc() * MPC_M) ** 2 * MJY_WM2HZ
              / LSUN_W)
    lir_k = res.compute_lir(thin=1)
    z = vp.DERIVED_Z
    worst = 0.0
    for n, smp in enumerate(samples):
        want = prefac * ModifiedBlackbodyOracle(*smp).freq_integrate(
            8.0 * (1 + z), 1000.0 * (1 + z))
        worst = max(worst, abs(lir_k[n * stride] - want) / want)
    ok_el = worst <= 3e-3
    log(f"[14] | config4 derived | lir elementwise, {len(samples)} samples "
        f"against the scipy oracle | max {100 * worst:.4f}% (<= 0.3%) | - | "
        f"- | - | {'PASS' if ok_el else 'FAIL'} |")
    if not (ok4 and ok_el):
        failed.append("config4 derived")
    counts = _counts()
    log(f"[14] launch counts over the parity phase "
        f"({time.time() - t0:.1f} s): {counts}")
    if failed:
        raise AssertionError(f"parity FAIL: {', '.join(failed)}")
    if counts["mbb_lnprob"] < 1 or counts["mbb_stretch_run"] < 1 \
            or counts["plain_sampler_runs"] != 0:
        raise AssertionError("the parity fits did not run through K1 and K2 "
                             "alone")
    return counts, derived_times


def _k2_plans(ops, half):
    """(the planned layout, the G = 1, C = 1 layout) of K2 for `ops`; the
    planner's shared-memory size must be the kernel library's."""
    from mbb_emcee_tpu_torch.ops.build import build_kernels
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import smem_optin_bytes
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        plan_stretch_launch, stretch_plan)
    nb, nn = int(ops.icfg[3]), int(ops.icfg[4])
    plan = plan_stretch_launch(nb, nn, half, bool(ops.icfg[1]),
                               bool(ops.icfg[0]), smem_optin_bytes(0))
    for p in (plan, stretch_plan(1, 1, nb, nn, half)):
        lib_bytes = build_kernels().mbb_run_smem_bytes(nb, nn, half,
                                                       p.threads)
        if lib_bytes != p.smem_bytes:
            raise AssertionError(f"planner's {p.smem_bytes} B of shared "
                                 f"memory != the library's {lib_bytes} B")
    return plan, stretch_plan(1, 1, nb, nn, half)


def _k2_layout_case(name, phot, shape, spec, pack, nrec, thin, bitwise,
                    mode=None):
    """K2 on the planned layout (or PLAN_TABLE's `mode` entry) against the
    G = 1, C = 1 layout on shared external uniforms. bitwise: chains, lnprob, accepts and final positions
    equal. Otherwise (response packs, whose band sums the layouts add in
    another order) the chains must be equal up to the record where they
    part, if they part, with lnprob within K2's replay tolerance there, and
    a parting walker's accept decision must sit within lnprob rounding of
    its threshold (_decision_margin; thin must be 1). Returns (plan, max
    |d lnp| before any parting)."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        PLAN_TABLE, FusedSampler, mbb_stretch_run, stretch_plan)
    samp = FusedSampler(NWALKERS, phot, shape, spec, response_pack=pack,
                        rng="external", device=DEVICE)
    state = samp.init_state(_ball(samp.free_space, NWALKERS, 2, DEVICE),
                            seed=3)
    half = samp.half
    plan, old = _k2_plans(samp.ops, half)
    planned = plan
    if mode is not None:
        plan = stretch_plan(*PLAN_TABLE[mode], int(samp.ops.icfg[3]),
                            int(samp.ops.icfg[4]), half)
    u = np.random.default_rng(13).uniform(
        0.001, 0.999, (nrec, 6 * thin, half)).astype(np.float32)
    u = torch.as_tensor(u, device=DEVICE)
    (sg, cg, lg), (so, co, lo) = [
        mbb_stretch_run(state, samp.ops, nrec, thin, samp.a, u, plan=p)
        for p in (plan, old)]
    head = (f"[15] K2 {name}, {nrec} records x thin {thin}: plan G={plan.group}"
            f" lanes x C={plan.cluster} blocks ({plan.walkers_per_block} "
            f"walkers, {plan.threads} threads, {plan.smem_bytes} B per "
            f"block) against G=1, C=1")
    if bitwise:
        ok = (torch.equal(cg, co) and torch.equal(lg, lo)
              and torch.equal(sg.naccept, so.naccept)
              and torch.equal(sg.position, so.position))
        log(f"{head}: chains, lnprob, accepts and final state bitwise "
            f"{'equal PASS' if ok else 'DIFFERENT FAIL'}")
        if not ok:
            raise AssertionError(f"K2 {name}: the layouts differ")
        return planned, 0.0
    rec_parted = (cg != co).any(-1).any(-1)
    t = int(torch.nonzero(rec_parted)[0]) if rec_parted.any() else nrec
    dl = float((lg[:t] - lo[:t]).abs().max()) if t else 0.0
    ok_l = torch.allclose(lg[:t], lo[:t], rtol=K2_RTOL, atol=K2_LNP_ATOL)
    note = "no parting"
    if t < nrec:
        hb = int(not (cg[t, :half] != co[t, :half]).any())
        act = slice(half * hb, half * (hb + 1))
        prev = state.position if t == 0 else co[t - 1]
        lnp_prev = (samp.ops.plain(prev[act]) if t == 0
                    else lo[t - 1, act])
        lanes = torch.nonzero((cg[t, act] != co[t, act]).any(-1)).flatten()
        dist, tol = _decision_margin(
            f"K2 {name} step {t}", samp.a, prev[act],
            co[t, :half] if hb else prev[half:], u[t, 3 * hb:3 * hb + 3],
            lnp_prev, samp.ops.plain, (cg[t, act], co[t, act]), lanes)
        note = (f"parted at step {t} on {len(lanes)} walker(s), |log ratio "
                f"- log u| {dist:.3g} <= {tol:.3g}")
        ok_a = True
    else:
        ok_a = torch.equal(sg.naccept, so.naccept)
    ok = ok_l and ok_a and bool(torch.isfinite(lg).all())
    log(f"{head}: chains bitwise up to step {t}, lnp max |d| {dl:.3g} "
        f"there, accepts {int(sg.naccept.sum())} vs {int(so.naccept.sum())};"
        f" {note} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 {name}: the layouts disagree")
    return planned, dl


def phase_k2_layouts():
    """K2 on a grouped cluster layout against the G = 1, C = 1 layout,
    external uniforms: point mode (configs 1, 2 and 6) on PLAN_TABLE's
    "point" layout (config 2's plan; configs 1 and 6 fix alpha and are
    planned on G = 1, C = 1) bitwise over 100 steps; config 3's 5 x 65 pack
    and the 8 x 1000 pack on their planned layouts over 20 single-step
    records under _k2_layout_case's parting rule. Returns (the planned
    layout by case, max |d lnp|)."""
    phot3, shape3, spec3 = problem(3)
    _, pack65 = port_response_pack(65)
    wide, _, _, pack1000 = response_case(WIDE_BANDS, 1000)
    plans, worst = {}, 0.0
    for ci in (1, 2, 6):
        plans[f"config {ci}"], _ = _k2_layout_case(
            f"config {ci} point mode", *problem(ci), None, 20, 5, True,
            mode="point")
    for name, phot, pack in (("config 3 5 x 65", phot3, pack65),
                             ("8 x 1000", wide, pack1000)):
        plans[name], dl = _k2_layout_case(name, phot, shape3, spec3, pack,
                                          20, 1, False)
        worst = max(worst, dl)
    log("[15] planned layouts: " + ", ".join(
        f"{k} G={p.group} x C={p.cluster}" for k, p in plans.items()))
    for name in ("config 2", "config 3 5 x 65"):
        p = plans[name]
        if p.group < 2 or p.cluster < 2:
            raise AssertionError(f"{name}: K2 not planned as a cluster of "
                                 f"grouped lanes ({p})")
    return plans, worst


SWEEP_GROUPS = (1, 8, 16, 32)
SWEEP_CLUSTERS = (1, 2, 4, 8)


SWEEP_CASES = (("point", 2), ("point_noalpha_thick", 1),
               ("point_noalpha_thin", 0), ("response", 3))


def phase_plan_sweep(card):
    """K2's device time per 200-step Philox launch on every layout G x C
    (SWEEP_GROUPS x SWEEP_CLUSTERS) in each of PLAN_TABLE's modes: point
    mode with the merge solve (config 2), without it (configs 1 and 0:
    thick and thin), and response mode (config 3's 5 x 65 pack); each timed
    in turns with the G = 1, C = 1 layout (old, new, new, old), by CUDA
    events over back-to-back launches (each launch is milliseconds long, so
    the host's launch gaps hide behind the device's work; torch.profiler
    drops its events after some hundred sessions in one process). In point
    mode every layout's chains must equal the G = 1, C = 1 chains bitwise. Returns {case: {"plan", "us", "old_us", "rows"}}
    for the planned layout."""
    import dataclasses
    import torch
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        FusedSampler, max_threads, mbb_stretch_run, stretch_plan)
    _, pack65 = port_response_pack(65)
    out = {}
    for mode, ci in SWEEP_CASES:
        pack, reps = (pack65, 2) if mode == "response" else (None, 3)
        phot, shape, spec = problem(ci)
        samp = FusedSampler(NWALKERS, phot, shape, spec, response_pack=pack,
                            device=DEVICE)
        state = samp.init_state(_ball(samp.free_space, NWALKERS, 6, DEVICE),
                                seed=77)
        plan, old = _k2_plans(samp.ops, samp.half)
        nb, nn = int(samp.ops.icfg[3]), int(samp.ops.icfg[4])

        def run(p):
            return mbb_stretch_run(state, samp.ops, 200, 1, samp.a, plan=p)

        def dev(p):
            return 1e3 * _cuda_ms(lambda: run(p), reps)
        ref = run(old)
        rows = []
        log(f"[16] K2 plan sweep, {mode} mode (config {ci}, {NWALKERS} "
            f"walkers x 200 steps), us per launch by CUDA events in turns "
            f"(old, new, new, old) ({card}):")
        log("[16] | G | C | walkers/block | threads | smem B | new us | "
            "old us | new/old | chains vs G=1,C=1 |")
        for g in SWEEP_GROUPS:
            for c in SWEEP_CLUSTERS:
                p = stretch_plan(g, c, nb, nn, samp.half)
                if p.threads > max_threads(g):
                    log(f"[16] | {g} | {c} | {p.walkers_per_block} | "
                        f"{p.threads} | - | above the kernel's "
                        f"{max_threads(g)} threads |")
                    continue
                got = run(p)
                same = (torch.equal(got[1], ref[1])
                        and torch.equal(got[2], ref[2]))
                if mode != "response" and not same:
                    raise AssertionError(f"K2 layout {p} differs from G=1, "
                                         "C=1 in point mode")
                t = [dev(old), dev(p), dev(p), dev(old)]
                new_us, old_us = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                rows.append({"group": g, "cluster": c, "new_us": t[1:3],
                             "old_us": [t[0], t[3]]})
                log(f"[16] | {g} | {c} | {p.walkers_per_block} | "
                    f"{p.threads} | {p.smem_bytes} | {t[1]:.1f}, {t[2]:.1f}"
                    f" | {t[0]:.1f}, {t[3]:.1f} | {new_us / old_us:.4f} | "
                    f"{'bitwise' if same else 'parted'} |")
        best = min(rows, key=lambda r: sum(r["new_us"]))
        mine = next(r for r in rows if (r["group"], r["cluster"])
                    == (plan.group, plan.cluster))
        log(f"[16] {mode} mode: fastest G={best['group']}, "
            f"C={best['cluster']} ({sum(best['new_us']) / 2:.1f} us); "
            f"planned G={plan.group}, C={plan.cluster} "
            f"({sum(mine['new_us']) / 2:.1f} us against "
            f"{sum(mine['old_us']) / 2:.1f} us on G=1, C=1) ({card})")
        out[mode] = {"plan": dataclasses.asdict(plan),
                     "us": sum(mine["new_us"]) / 2,
                     "old_us": sum(mine["old_us"]) / 2, "rows": rows}
    return out


def _k3_layouts(nb, nn, half, nsrc, sm_count):
    """K3's layouts for `nsrc` sources of 2 * half walkers: G in
    MULTI_GROUPS in one block, and G in MULTI_CLUSTER_GROUPS x C in
    SWEEP_CLUSTERS[1:] where S x C fits the card's SMs; those within the
    kernel's threads. The planner's shared-memory size must be the
    library's."""
    from mbb_emcee_tpu_torch.ops.build import build_kernels
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        MULTI_CLUSTER_GROUPS, MULTI_GROUPS, MULTI_LAYOUTS)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import stretch_plan
    out = [stretch_plan(g, 1, nb, nn, half) for g in MULTI_GROUPS]
    out += [stretch_plan(g, c, nb, nn, half) for g in MULTI_CLUSTER_GROUPS
            for c in SWEEP_CLUSTERS[1:] if nsrc * c <= sm_count]
    out = [p for p in out
           if p.threads <= MULTI_LAYOUTS[(p.group, p.cluster > 1)]]
    for p in out:
        lib_bytes = build_kernels().mbb_run_smem_bytes(nb, nn, half,
                                                       p.threads)
        if lib_bytes != p.smem_bytes:
            raise AssertionError(f"planner's {p.smem_bytes} B of shared "
                                 f"memory != the library's {lib_bytes} B")
    return out


def _layout(p):
    return f"G={p.group} x C={p.cluster}"


def _k3_parting(where, samp, state, u, got, want):
    """Two K3-shaped runs of single-step records (thin 1) on external
    uniforms u (S, nrec, 6, half), `got` against `want` (another layout,
    or the plain multi run): every source bitwise up to the record where
    it parts, if it parts, with lnprob within K2's replay tolerance there
    and accepts equal if it never parts; a parting walker's accept decision
    must sit within lnprob rounding of its threshold (_decision_margin, on
    the plain lnprob). Returns (sources parted, max |d lnp| before any
    parting, notes)."""
    import torch
    (sg, cg, lg), (sw, cw, lw) = got, want
    half = state.pos.shape[1] // 2
    nrec = cg.shape[1]
    rec_parted = (cg != cw).any(-1).any(-1)              # (S, nrec)
    parted, dl, notes = 0, 0.0, []
    for s in range(cg.shape[0]):
        hit = torch.nonzero(rec_parted[s])
        t = int(hit[0]) if len(hit) else nrec
        if t:
            dl = max(dl, float((lg[s, :t] - lw[s, :t]).abs().max()))
            if not torch.allclose(lg[s, :t], lw[s, :t], rtol=K2_RTOL,
                                  atol=K2_LNP_ATOL):
                raise AssertionError(f"{where}: source {s} lnprob off before"
                                     " any parting")
        if t == nrec:
            if not torch.equal(sg.naccept[s], sw.naccept[s]):
                raise AssertionError(f"{where}: source {s} accepts differ")
            continue
        parted += 1
        hb = int(not (cg[s, t, :half] != cw[s, t, :half]).any())
        act = slice(half * hb, half * (hb + 1))
        prev = state.pos[s] if t == 0 else cw[s, t - 1]
        lnp_prev = (samp.ops.plain(state.pos[:, act])[s] if t == 0
                    else lw[s, t - 1, act])

        def lnp_of(prop, s=s):
            batch = state.pos[:, :half].clone()
            batch[s] = prop
            return samp.ops.plain(batch)[s]
        lanes = torch.nonzero((cg[s, t, act] != cw[s, t, act]).any(-1))
        dist, tol = _decision_margin(
            f"{where} source {s} step {t}", samp.a, prev[act],
            cw[s, t, :half] if hb else prev[half:],
            u[s, t, 3 * hb:3 * hb + 3], lnp_prev, lnp_of,
            (cg[s, t, act], cw[s, t, act]), lanes.flatten())
        notes.append(f"source {s} step {t}: {dist:.3g} <= {tol:.3g}")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{where}: lnprob not finite")
    return parted, dl, notes


def k3_cases():
    """Phase 17's likelihood cases: (name, bitwise, builder), where
    builder(S) gives FusedMultiSampler keyword arguments for S sources:
    configs 1 and 2 with per-source upper limits and a missing band,
    config 6's band correlation (whitening; upper limits do not compose
    with it) with a missing band, all in point mode (bitwise across
    layouts); config 3's 5 x 65 and 5 x 129 packs with per-source fluxes
    (response mode: the band sums' order differs across layouts)."""
    import dataclasses
    import numpy as np
    from tools import validate_tpu_parity as vp

    def point(ci, correlated):
        def make(nsrc):
            flux, unc = sweep_data(ci, nsrc, seed=100 + ci, missing_every=3)
            _, shape, spec = problem(ci)
            kw = dict(flux=flux, unc=unc, shape=shape)
            if correlated:
                mf = batch_fitter(flux, unc)
                mf.set_band_correlation(vp.CAL_CORR)
                kw.update(spec=dataclasses.replace(spec, uplim_bands=None),
                          whiten=mf._whiten_operand())
            else:
                ul = np.zeros((nsrc, 5), bool)
                ul[::3, 4] = True
                ul[1::5, 3] = True
                ul[1::3, 0] = True      # a limit on a missing band
                kw.update(spec=dataclasses.replace(spec, uplim_bands=ul))
            return kw
        return make

    def response(nn):
        def make(nsrc):
            flux, unc = sweep_data(3, nsrc, seed=300)
            _, shape, spec = problem(3)
            return dict(flux=flux, unc=unc, shape=shape, spec=spec,
                        response_pack=port_response_pack(nn)[1])
        return make
    return [("config 1 uplims + missing band", True, point(1, False)),
            ("config 2 uplims + missing band", True, point(2, False)),
            ("config 6 band correlation + missing band", True,
             point(6, True)),
            ("config 3 5 x 65", False, response(65)),
            ("config 3 5 x 129", False, response(129))]


def sweep_data(ci, nsrc, seed, missing_every=0):
    """Config ci's mock photometry for `nsrc` sources: one noise draw from
    numpy seed `seed`, each source's fluxes scaled by a factor in
    [0.8, 1.2] from the same seed, band 0 missing (NaN) in every
    `missing_every`-th source. Returns (flux, unc) (S, 5)."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    f, unc, _ = vp.mock_data(vp.CONFIGS[ci], seed=seed)
    scale = np.random.default_rng(seed).uniform(0.8, 1.2, (nsrc, 1))
    flux, unc = f[None] * scale, unc[None] * scale
    if missing_every:
        flux[1::missing_every, 0] = np.nan
        unc[1::missing_every, 0] = np.nan
    return flux, unc


K3_CHECK_SOURCES = (1, 4, 256)


def phase_k3_layouts():
    """K3 on every layout the planner may pick (_k3_layouts) against the
    G = 1, C = 1 layout on shared external uniforms, at S in
    K3_CHECK_SOURCES, per k3_cases case: point mode bitwise (chains,
    lnprob, accepts, final state); response mode under _k3_parting's rule.
    The planned layout of each case against the plain multi run under the
    same rule. Then K3 at one source on every layout against K2 on its
    planned layout, Philox mode: bitwise. Returns (the planned layout by
    case and S, max |d lnp| before any parting)."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        FusedMultiSampler, device_sm_count, mbb_multi_stretch_run,
        plan_multi_on_card)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import (
        FusedSampler, stretch_plan)
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    sms = device_sm_count(0)
    plans, worst = {}, 0.0
    for name, bitwise, make in k3_cases():
        nrec, thin = 12, 1
        for nsrc in K3_CHECK_SOURCES:
            samp = FusedMultiSampler(NWALKERS, vp.WAVE, rng="external",
                                     device=DEVICE, **make(nsrc))
            state = samp.init_state(
                _multi_ball(samp.free_space, nsrc, 70), seed=3)
            half = samp.half
            nb, nn = int(samp.ops.icfg[3]), int(samp.ops.icfg[4])
            u = np.random.default_rng(17).uniform(
                0.001, 0.999, (nsrc, nrec, 6 * thin, half))
            u = torch.as_tensor(u.astype(np.float32), device=DEVICE)

            def run(p):
                return mbb_multi_stretch_run(state, samp.ops, nrec, thin,
                                             samp.a, u, plan=p)
            ref = run(stretch_plan(1, 1, nb, nn, half))
            planned = plan_multi_on_card(
                nb, nn, half, nsrc, bool(samp.ops.icfg[1]),
                bool(samp.ops.icfg[0]), DEVICE)
            plans[f"{name}, S={nsrc}"] = planned
            rows = []
            for p in _k3_layouts(nb, nn, half, nsrc, sms):
                got = run(p)
                if bitwise:
                    same = all(torch.equal(x, y) for x, y in (
                        (got[1], ref[1]), (got[2], ref[2]),
                        (got[0].naccept, ref[0].naccept),
                        (got[0].pos, ref[0].pos)))
                    rows.append(f"{_layout(p)} "
                                f"{'bitwise' if same else 'DIFFERENT'}")
                    if not same:
                        log(f"[17] K3 {name}, S={nsrc}: " + "; ".join(rows)
                            + " FAIL")
                        raise AssertionError(f"K3 {name}: {p} differs from "
                                             "G=1, C=1 in point mode")
                else:
                    n, dl, _ = _k3_parting(f"K3 {name} {_layout(p)}", samp,
                                           state, u, got, ref)
                    worst = max(worst, dl)
                    rows.append(f"{_layout(p)} {nsrc - n}/{nsrc} bitwise")
            log(f"[17] K3 {name}, {nsrc} source(s) x {NWALKERS} walkers, "
                f"{nrec} records x thin {thin}, against G=1, C=1: "
                + "; ".join(rows) + " PASS")
            # the planned layout (the wrapper's own choice) against plain
            got = mbb_multi_stretch_run(state, samp.ops, nrec, thin, samp.a,
                                        u)
            want = multi_stretch_run_plain(state, samp.ops.plain, nrec, thin,
                                           samp.a, u)
            n, dl, notes = _k3_parting(f"K3 {name} planned", samp, state, u,
                                       got, want)
            worst = max(worst, dl)
            log(f"[17] K3 {name}, S={nsrc}: planned {_layout(planned)} "
                f"against the plain multi run: {nsrc - n}/{nsrc} bitwise, "
                f"lnp max |d| {dl:.3g} before any parting"
                + (" (" + "; ".join(notes) + ")" if notes else "")
                + " PASS")

    # one source on every layout against K2, Philox mode
    for ci in (1, 2):
        phot, shape, spec = problem(ci)
        single = FusedSampler(NWALKERS, phot, shape, spec, device=DEVICE)
        one = FusedMultiSampler(NWALKERS, vp.WAVE, phot.flux[None],
                                phot.unc[None], shape, spec, device=DEVICE)
        p0 = _ball(single.free_space, NWALKERS, 4, DEVICE)
        a = single.run_mcmc(single.init_state(p0, seed=77), 200, thin=10)
        st = one.init_state(p0[None], seed=77)
        rows = []
        for p in _k3_layouts(5, 1, one.half, 1, sms):
            b = mbb_multi_stretch_run(st, one.ops, 20, 10, one.a, plan=p)
            same = (torch.equal(a[1], b[1][0]) and torch.equal(a[2], b[2][0])
                    and torch.equal(a[0].naccept, b[0].naccept[0])
                    and torch.equal(a[0].position, b[0].pos[0]))
            rows.append(f"{_layout(p)} {'bitwise' if same else 'DIFFERENT'}")
            if not same:
                log(f"[17] config {ci}: " + "; ".join(rows) + " FAIL")
                raise AssertionError(f"K3 at S=1 on {p} differs from K2")
        log(f"[17] K3 at one source against K2 (config {ci}, Philox, 200 "
            f"steps): " + "; ".join(rows) + " PASS")
    return plans, worst



K3_SWEEP_SOURCES = (4, 16, 32, 64, 256, 1024)


def phase_k3_sweep(card):
    """K3's device time per 200-step Philox launch (20 records x thin 10)
    on every layout the planner may pick (_k3_layouts) at S in
    K3_SWEEP_SOURCES, in each of MULTI_PLAN_TABLE's modes (SWEEP_CASES'
    configs; response mode on config 3's 5 x 65 pack), each timed in turns
    with G = 1, C = 1 (old, new, new, old) by CUDA events over back-to-back
    launches; few repetitions (one at 1024 sources, which places the
    crossover to one thread per walker). Each row also shows how many
    sources of its layout the card runs at once (card_resident, the
    planner's one-wave test: for a cluster, with a block per SM). In point mode every layout's chains must
    equal G = 1, C = 1's bitwise. Returns {"mode S": {"plan", "us",
    "old_us", "bound_us", "rows"}} for the planned layout (the bound of
    k2_bound for the cell's S sources)."""
    import dataclasses
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.ops.multifit_kernel import (
        FusedMultiSampler, card_resident, device_sm_count,
        mbb_multi_stretch_run, plan_multi_on_card)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import stretch_plan
    sms = device_sm_count(0)
    _, pack65 = port_response_pack(65)
    out = {}
    for mode, ci in SWEEP_CASES:
        resp = mode == "response"
        for nsrc in K3_SWEEP_SOURCES:
            reps = 1 if nsrc > 2 * sms else 2
            flux, unc = sweep_data(ci, nsrc, seed=400 + ci)
            _, shape, spec = problem(ci)
            samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape,
                                     spec, response_pack=pack65 if resp
                                     else None, device=DEVICE)
            p0 = _ball(samp.free_space, NWALKERS, 6, DEVICE)
            state = samp.init_state(
                torch.stack([p0.roll(s, 0) for s in range(nsrc)]), seed=77)
            half = samp.half
            nb, nn = int(samp.ops.icfg[3]), int(samp.ops.icfg[4])
            plan = plan_multi_on_card(nb, nn, half, nsrc,
                                      bool(samp.ops.icfg[1]),
                                      bool(samp.ops.icfg[0]), DEVICE)
            resident = card_resident(0, nb, nn, half)
            old = stretch_plan(1, 1, nb, nn, half)
            bnd = k2_bound(samp.ops.icfg, nsrc, NWALKERS, samp.ndim,
                           samp.ops.consts.numel() + samp.ops.flux.numel()
                           + samp.ops.errs.numel(), 200, 20)

            def run(p):
                return mbb_multi_stretch_run(state, samp.ops, 20, 10, samp.a,
                                             plan=p)

            def dev(p):
                return 1e3 * _cuda_ms(lambda: run(p), reps)
            ref = run(old)
            rows = []
            log(f"[18] K3 sweep, {mode} mode (config {ci}), {nsrc} sources "
                f"x {NWALKERS} walkers x 200 steps, us per launch by CUDA "
                f"events in turns (old, new, new, old) ({card}):")
            log("[18] | G | C | walkers/block | threads | smem B | sources "
                "at once | new us | old us | new/old | chains vs G=1,C=1 |")
            for p in _k3_layouts(nb, nn, half, nsrc, sms):
                got = run(p)
                same = (torch.equal(got[1], ref[1])
                        and torch.equal(got[2], ref[2]))
                if not resp and not same:
                    raise AssertionError(f"K3 layout {p} differs from G=1, "
                                         "C=1 in point mode")
                del got
                t = [dev(old), dev(p), dev(p), dev(old)]
                new_us, old_us = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                res = resident(p)
                rows.append({"group": p.group, "cluster": p.cluster,
                             "resident": res, "new_us": t[1:3],
                             "old_us": [t[0], t[3]]})
                log(f"[18] | {p.group} | {p.cluster} | "
                    f"{p.walkers_per_block} | {p.threads} | {p.smem_bytes} | "
                    f"{res} | "
                    f"{t[1]:.1f}, {t[2]:.1f} | {t[0]:.1f}, {t[3]:.1f} | "
                    f"{new_us / old_us:.4f} | "
                    f"{'bitwise' if same else 'parted'} |")
            best = min(rows, key=lambda r: sum(r["new_us"]))
            mine = next(r for r in rows if (r["group"], r["cluster"])
                        == (plan.group, plan.cluster))
            log(f"[18] {mode} mode, S={nsrc}: fastest G={best['group']}, "
                f"C={best['cluster']} ({sum(best['new_us']) / 2:.1f} us); "
                f"planned {_layout(plan)} ({sum(mine['new_us']) / 2:.1f} us "
                f"against {sum(mine['old_us']) / 2:.1f} us on G=1, C=1); "
                f"bound {1e3 * bnd[0]:.4g} us ({bnd[1]}) ({card})")
            out[f"{mode} {nsrc}"] = {
                "plan": dataclasses.asdict(plan),
                "us": sum(mine["new_us"]) / 2,
                "old_us": sum(mine["old_us"]) / 2, "bound_us": 1e3 * bnd[0],
                "rows": rows}
            del ref, samp, state
    return out


K1_SWEEP_N = (250, 4096, 62500, 1048576)
K1_CHECK_N = (1, 31, 33, 250, 4096)


K1_LOOP_BLOCKS_PER_SM = 8


def _k1_layouts(ops, n, threads=None):
    """(K1's layouts for n vectors of the likelihood in `ops`, the layout
    they are held against): G in LNPROB_GROUPS in the planner's block
    (fit_threads; or in blocks of every size in `threads`, each shrunk to
    the card's shared memory) with a block per tile; where that is more
    blocks than K1_LOOP_BLOCKS_PER_SM per SM, also on that many blocks
    looping over the tiles (a resident wave that stages once per block);
    and one thread per vector in blocks of 128 with a block per tile, the
    kernel's only layout before it had a planner. The planner's
    shared-memory size must be the library's."""
    from mbb_emcee_tpu_torch.ops.build import build_kernels
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        LNPROB_BLOCK_THREADS, LNPROB_GROUPS, device_sm_count, fit_threads,
        lnprob_plan, smem_optin_bytes)
    nb, nn = int(ops.icfg[3]), int(ops.icfg[4])
    wave = K1_LOOP_BLOCKS_PER_SM * device_sm_count(0)
    out = []
    for t in threads or (LNPROB_BLOCK_THREADS,):
        t = fit_threads(nb, nn, smem_optin_bytes(0), t)
        for g in LNPROB_GROUPS:
            for p in (lnprob_plan(g, t, n, nb, nn),
                      lnprob_plan(g, t, n, nb, nn, wave)):
                if p not in out:
                    out.append(p)
    old = lnprob_plan(1, 128, n, nb, nn)
    for p in out + [old]:
        lib_bytes = build_kernels().mbb_lnprob_smem_bytes(nb, nn, p.threads)
        if lib_bytes != p.smem_bytes:
            raise AssertionError(f"planner's {p.smem_bytes} B of shared "
                                 f"memory != the library's {lib_bytes} B")
    return out, old


def _k1_name(p):
    return f"G={p.group} x {p.threads} threads x {p.blocks} blocks"


def _k1_planned(ops, n):
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import plan_lnprob_on_card
    return plan_lnprob_on_card(int(ops.icfg[3]), int(ops.icfg[4]), n,
                               bool(ops.icfg[1]), bool(ops.icfg[0]), 0)


def _k1_layout_case(name, ops, x, bitwise, plain=True, plans=None,
                    ref_scale=1):
    """K1 on `plans` (every layout of _k1_layouts and the planned one by
    default) for the vectors x against one thread per vector in blocks of
    128: bitwise, or (response packs, whose band sums the lanes add in
    another order) within `ref_scale` times K1's tolerance with the floored
    vectors the same and exactly at the floor; and, with `plain`, each
    against the plain version within K1's tolerance. Returns the max abs
    difference from the plain version (from the old layout without it)."""
    import torch
    from mbb_emcee_tpu_torch.likelihood import LNPROB_FLOOR
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    n = x.shape[0]
    layouts, old = _k1_layouts(ops, n)
    planned = _k1_planned(ops, n)
    if plans is None:
        plans = layouts + ([] if planned in layouts else [planned])
    ref = mbb_lnprob(x, ops, plan=old)
    want = ops.plain(x) if plain else ref
    floor = want <= LNPROB_FLOOR / 2
    worst, rows = 0.0, []
    for p in plans:
        got = mbb_lnprob(x, ops, plan=p)
        if bitwise:
            ok = torch.equal(got, ref)
        else:
            ok = (torch.equal(got <= LNPROB_FLOOR / 2, ref <= LNPROB_FLOOR
                              / 2)
                  and torch.allclose(got, ref, rtol=ref_scale * K1_RTOL,
                                     atol=ref_scale * K1_ATOL))
        ok = ok and torch.equal(got <= LNPROB_FLOOR / 2, floor) \
            and bool((got[floor] == LNPROB_FLOOR).all()) \
            and torch.allclose(got[~floor], want[~floor], rtol=K1_RTOL,
                               atol=K1_ATOL)
        d = float((got[~floor] - want[~floor]).abs().max()) \
            if (~floor).any() else 0.0
        worst = max(worst, d)
        rows.append(f"{_k1_name(p)}"
                    + (" (planned)" if p == planned else "")
                    + f" {'ok' if ok else 'DIFFERENT'}")
        if not ok:
            log(f"[19] K1 {name}, n={n}: " + "; ".join(rows) + " FAIL")
            raise AssertionError(f"K1 {name}: {p} disagrees with one thread "
                                 "per vector or with the plain version")
    log(f"[19] K1 {name}, n={n} ({int(floor.sum())} floored): "
        + ("bitwise" if bitwise else f"within rtol {ref_scale * K1_RTOL:g}")
        + " against G=1 x 128 threads"
        + (f", max |d| {worst:.3g} against plain" if plain else "")
        + ": " + "; ".join(rows) + " PASS")
    return worst


def sweep_ops(mode, ci):
    """K1's operands of sweep case (mode, config ci): point mode, or config
    3 on its 5 x 65 pack."""
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import prepare_lnprob_inputs
    pack = port_response_pack(65)[1] if mode == "response" else None
    return prepare_lnprob_inputs(*problem(ci), pack, device=DEVICE)


def phase_response_cov():
    """Response mode with correlated band errors, which no other phase
    runs: config 3's model on its 5 x 65 pack with config 5's band
    covariance. K1 on every layout against the plain version; K2's
    external-uniforms replay against its plain run; K3 (5 sources, that
    band correlation as per-source whitening) against the plain multi run.
    Returns the max abs differences (K1, K2, K3)."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.likelihood import Photometry
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import prepare_lnprob_inputs
    from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
    from mbb_emcee_tpu_torch.sampler import multi_stretch_run_plain

    phot3, shape3, spec3 = problem(3)
    _, _, cov = vp.mock_data(vp.CONFIGS[5])
    phot = Photometry(phot3.wave, phot3.flux, phot3.unc, cov=cov)
    _, pack65 = port_response_pack(65)
    ops = prepare_lnprob_inputs(phot, shape3, spec3, pack65, device=DEVICE)
    if not ops.icfg[2] or ops.icfg[4] != 65:
        raise AssertionError("not a response-mode likelihood with a "
                             "covariance")
    x = torch.as_tensor(thetas(ops.free_space)[0], device=DEVICE)
    k1 = max(_k1_layout_case("config 3 5 x 65 + config 5 covariance", ops,
                             x[:n].contiguous(), False) for n in (250, 4096))
    log(f"[19] K2 replay, config 3 on the 5 x 65 pack with config 5's "
        f"covariance: {NWALKERS} walkers, 3 records x thin 2")
    k2 = _k2_replay("19", phot, shape3, spec3, pack65)

    nsrc = 5
    flux, unc = sweep_data(3, nsrc, seed=300)
    mf = batch_fitter(flux, unc)
    mf.set_band_correlation(vp.CAL_CORR)
    samp = FusedMultiSampler(NWALKERS, vp.WAVE, flux, unc, shape3, spec3,
                             response_pack=pack65,
                             whiten=mf._whiten_operand(), rng="external",
                             device=DEVICE)
    state = samp.init_state(_multi_ball(samp.free_space, nsrc, 60), seed=3)
    nrec, thin = 3, 2
    u = np.random.default_rng(12).uniform(
        0.001, 0.999, (nsrc, nrec, 6 * thin, samp.half))
    u = torch.as_tensor(u.astype(np.float32), device=DEVICE)
    got = samp.run_mcmc(state, nrec * thin, thin, uniforms=u)
    want = multi_stretch_run_plain(state, samp.ops.plain, nrec, thin,
                                   samp.a, u)
    log(f"[19] K3 on the 5 x 65 pack with the band correlation: {nsrc} "
        f"sources x {NWALKERS} walkers, {nrec} records x thin {thin}")
    return k1, k2, _compare_multi("19", got, want)


def phase_k1_layouts():
    """K1 on every layout (_k1_layouts) and on its planned one against one
    thread per vector in blocks of 128 and against the plain version, at
    K1_CHECK_N vectors (partly filled groups, warps and blocks included):
    point mode (configs 0, 1, 2, 5, 6) bitwise; the 5 x 65, 5 x 129,
    8 x 400 and 8 x 1000 packs within K1's tolerance of the plain version,
    and of one thread per vector too, but for the 8-band packs: there one
    thread's serial sum of 400 or 1000 terms is itself up to a whole
    tolerance from the plain version (the lanes' shorter sums are nearer),
    so two layouts, each within the tolerance of plain, are held to twice
    it of each other. The planned layout at
    every batch size of the sweep in each of its modes, against one thread
    per vector. Then phase_response_cov. Returns (the planned layout by
    case and n, max abs difference from plain, phase_response_cov's
    differences)."""
    import torch
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import prepare_lnprob_inputs
    phot3, shape3, spec3 = problem(3)
    cases = [(f"config {ci}", True, 1, prepare_lnprob_inputs(
        *problem(ci), None, device=DEVICE)) for ci in (0, 1, 2, 5, 6)]
    cases += [(f"config 3 5 x {nn}", False, 1, prepare_lnprob_inputs(
        phot3, shape3, spec3, port_response_pack(nn)[1], device=DEVICE))
        for nn in (65, 129)]
    for nn in (400, 1000):
        phot, _, _, pack = response_case(WIDE_BANDS, nn)
        cases.append((f"8 x {nn}", False, 2, prepare_lnprob_inputs(
            phot, shape3, spec3, pack, device=DEVICE)))
    plans, worst = {}, 0.0
    for name, bitwise, scale, ops in cases:
        x = torch.as_tensor(thetas(ops.free_space)[0], device=DEVICE)
        for n in K1_CHECK_N:
            worst = max(worst, _k1_layout_case(name, ops, x[:n].contiguous(),
                                               bitwise, ref_scale=scale))
            plans[f"{name}, n={n}"] = _k1_planned(ops, n)
    for mode, ci in SWEEP_CASES:
        ops = sweep_ops(mode, ci)
        x = torch.as_tensor(thetas(ops.free_space, n=K1_SWEEP_N[-1])[0],
                            device=DEVICE)
        for n in K1_SWEEP_N:
            p = _k1_planned(ops, n)
            _k1_layout_case(f"sweep case {mode} (config {ci})", ops,
                            x[:n].contiguous(), mode != "response",
                            plain=False, plans=[p])
            plans[f"{mode}, n={n}"] = p
    log("[19] planned layouts: " + ", ".join(
        f"{k}: {_k1_name(p)}" for k, p in plans.items()
        if k.split(",")[0] in dict(SWEEP_CASES)))
    return plans, worst, phase_response_cov()


def _graph_us(fn, reps):
    """Microseconds of device time per call of fn() over `reps` calls
    captured into one CUDA graph and replayed (after a warm-up replay)
    between two CUDA events: back-to-back launches with no host in between,
    so a kernel of a few microseconds is timed by the device and not by the
    host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return 1e3 * start.elapsed_time(end) / reps
    return timed


def k1_probe(card, sizes=K1_SWEEP_N):
    """K1 as a caller meets it, through mbb_lnprob(x, ops) alone: the
    kernel's device time per launch (_graph_us, the sweep's clock; a
    package whose launch cannot be captured into a CUDA graph is timed by
    torch.profiler) at each of `sizes`
    vectors in each sweep case, and at 250 vectors the host's time per
    mbb_lnprob call (a loop of calls, synchronized at its end) and per
    MBBFitter.__call__ (which also copies the vector in and the value out),
    in point mode (config 2) and response mode (config 3, 5 x 65). Returns
    {"device_us": {"mode n": us}, "host_us": {...}}."""
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBFitter
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    out = {"device_us": {}, "host_us": {}}
    for mode, ci in SWEEP_CASES:
        ops = sweep_ops(mode, ci)
        xs = torch.as_tensor(thetas(ops.free_space, n=max(sizes))[0],
                             device=DEVICE)
        for n in sizes:
            x = xs[:n].contiguous()
            reps = 5 if n > 100000 else 100
            try:
                timed = _graph_us(lambda: mbb_lnprob(x, ops), reps)
                us, clock = min(timed(), timed()), "CUDA graph and events"
            except RuntimeError as err:
                log(f"[probe] graph capture failed ({str(err)[:80]})")
                torch.cuda.synchronize()
                us = _profiled_device_us(lambda: mbb_lnprob(x, ops), reps,
                                         "mbb_lnprob_kernel")
                clock = "torch.profiler"
            out["device_us"][f"{mode} {n}"] = us
            log(f"[probe] K1 {mode} mode (config {ci}), n={n}: "
                + ("not measured" if us is None else f"{us:.2f} us")
                + f" device time per launch ({clock}) ({card})")
        if mode in ("point", "response"):
            x = xs[:NWALKERS].contiguous()
            calls = 2000
            mbb_lnprob(x, ops)

            def loop():
                for _ in range(calls):
                    mbb_lnprob(x, ops)
            host = min(_host_s(loop) for _ in range(3)) / calls * 1e6
            out["host_us"][f"mbb_lnprob {mode}"] = host
            log(f"[probe] host time per mbb_lnprob call, {mode} mode, "
                f"{NWALKERS} vectors: {host:.2f} us over {calls} calls "
                f"({card})")
    # what every such call pays whatever the wrapper does: the output's
    # allocation and the current stream's handle
    calls = 2000
    for what, fn in (
            ("torch.empty(250) on the card",
             lambda: torch.empty(NWALKERS, dtype=torch.float32,
                                 device=DEVICE)),
            ("torch.cuda.current_stream().cuda_stream",
             lambda: torch.cuda.current_stream().cuda_stream)):
        def loop():
            for _ in range(calls):
                fn()
        host = min(_host_s(loop) for _ in range(3)) / calls * 1e6
        out["host_us"][what] = host
        log(f"[probe] host time per {what}: {host:.2f} us over {calls} "
            f"calls ({card})")
    for mode, ci in (("point", 2), ("response", 3)):
        cfg = vp.CONFIGS[ci]
        flux, unc, cov = vp.mock_data(cfg)
        fit = MBBFitter(nwalkers=NWALKERS, opthin=cfg["opthin"],
                        noalpha=cfg["noalpha"], device=DEVICE,
                        responses=port_response_pack()[0]
                        if cfg["response"] else None)
        fit.set_data(vp.WAVE, flux, unc, cov=cov,
                     band_names=vp.BANDS if cfg["response"] else None)
        fit(vp.TRUE)
        calls = 500

        def loop():
            for _ in range(calls):
                fit(vp.TRUE)
        host = min(_host_s(loop) for _ in range(3)) / calls * 1e6
        out["host_us"][f"MBBFitter.__call__ {mode}"] = host
        log(f"[probe] host time per MBBFitter.__call__, {mode} mode "
            f"(config {ci}): {host:.2f} us over {calls} calls ({card})")
    return out


def phase_k1_sweep(card, threads=None, sizes=K1_SWEEP_N):
    """K1's device time per launch on every layout (_k1_layouts) at
    `sizes` vectors in each of LNPROB_PLAN_TABLE's modes (SWEEP_CASES'
    configs; response mode on config 3's 5 x 65 pack), each timed in turns
    with one thread per vector in blocks of 128 (old, new, new, old) by
    CUDA events around a CUDA graph of back-to-back launches (_graph_us),
    beside K1's bound at that batch size. In point mode every layout must
    equal the old one bitwise. Then k1_probe. Returns ({"mode n": {"plan",
    "us", "old_us", "bound_us", "rows"}} for the planned layout, k1_probe's
    result)."""
    import dataclasses
    import torch
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    out = {}
    for mode, ci in SWEEP_CASES:
        ops = sweep_ops(mode, ci)
        xs = torch.as_tensor(thetas(ops.free_space, n=max(sizes))[0],
                             device=DEVICE)
        for n in sizes:
            x = xs[:n].contiguous()
            layouts, old = _k1_layouts(ops, n, threads)
            planned = _k1_planned(ops, n)
            bnd = k1_bound(ops.icfg, n, ops.nfree, ops.consts.numel())
            ref = mbb_lnprob(x, ops, plan=old)
            est = _cuda_ms(lambda: mbb_lnprob(x, ops, plan=old), 3)
            reps = int(min(max(8.0 / max(est, 1e-3), 4), 200))
            t_old = _graph_us(lambda: mbb_lnprob(x, ops, plan=old), reps)
            rows = []
            log(f"[20] K1 sweep, {mode} mode (config {ci}), n={n}: us per "
                f"launch by CUDA events over a graph of {reps} launches, in "
                f"turns (old, new, new, old); bound {1e3 * bnd[0]:.4g} us "
                f"({bnd[1]}) ({card}):")
            log("[20] | G | threads | blocks | smem B | new us | old us | "
                "new/old | bound/new | vs G=1 x 128 |")
            for p in layouts:
                got = mbb_lnprob(x, ops, plan=p)
                same = torch.equal(got, ref)
                if mode != "response" and not same:
                    raise AssertionError(f"K1 layout {p} differs from one "
                                         "thread per vector in point mode")
                t_new = _graph_us(lambda: mbb_lnprob(x, ops, plan=p), reps)
                t = [t_old(), t_new(), t_new(), t_old()]
                new_us, old_us = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                rows.append({"group": p.group, "threads": p.threads,
                             "blocks": p.blocks, "new_us": t[1:3],
                             "old_us": [t[0], t[3]]})
                log(f"[20] | {p.group} | {p.threads} | {p.blocks} | "
                    f"{p.smem_bytes} | {t[1]:.2f}, {t[2]:.2f} | {t[0]:.2f}, "
                    f"{t[3]:.2f} | {new_us / old_us:.4f} | "
                    f"{1e3 * bnd[0] / new_us:.4f} | "
                    f"{'bitwise' if same else 'within tolerance'}"
                    f"{' (planned)' if p == planned else ''} |")
                del t_new, got
            best = min(rows, key=lambda r: sum(r["new_us"]))
            mine = [r for r in rows if (r["group"], r["threads"],
                                        r["blocks"]) == (
                planned.group, planned.threads, planned.blocks)]
            if not mine:
                raise AssertionError(f"the planned layout {planned} is not "
                                     "in the sweep")
            us = sum(mine[0]["new_us"]) / 2
            old_us = sum(mine[0]["old_us"]) / 2
            log(f"[20] {mode} mode, n={n}: fastest G={best['group']} x "
                f"{best['threads']} threads ({sum(best['new_us']) / 2:.2f} "
                f"us); planned {_k1_name(planned)} ({us:.2f} us against "
                f"{old_us:.2f} us on G=1 x 128 threads, "
                f"{100 * 1e3 * bnd[0] / us:.3g}% of the bound's rate) "
                f"({card})")
            out[f"{mode} {n}"] = {
                "plan": dataclasses.asdict(planned), "us": us,
                "old_us": old_us, "bound_us": 1e3 * bnd[0],
                "share_of_bound": 1e3 * bnd[0] / us, "rows": rows}
            del t_old, ref
    return out, k1_probe(card)


def _timed(fn):
    """(fn(), host seconds), the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _path_counts(path, kernel, want):
    """Read the counts just after entry point `path` (zeroed just before
    it) and require `want` launches of `kernel` and no plain sampler run.
    Returns the launch count."""
    c = _counts()
    n = c[kernel]
    plain = c["plain_sampler_runs"] + c["plain_multi_runs"]
    ok = n == want and plain == 0
    log(f"[21] {path}: {n} {kernel} launches (want {want}), {plain} plain "
        f"sampler runs {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{path} did not run through {kernel} alone")
    return n


def _recording_k1():
    """A context in which every mbb_lnprob call made through the module's
    attribute is recorded as (x, ops, output copy) in the list it yields.
    The wrapper counts its launches on the module's name, which is the
    recorder meanwhile: the recorder starts from the wrapper's count and
    hands it back, so the counts are the wrapper's own."""
    import contextlib
    from mbb_emcee_tpu_torch.ops import lnprob_kernel

    @contextlib.contextmanager
    def ctx():
        orig, seen = lnprob_kernel.mbb_lnprob, []

        def rec(x, ops, *args, **kwargs):
            out = orig(x, ops, *args, **kwargs)
            seen.append((x, ops, out.clone()))
            return out
        rec.launches = orig.launches
        lnprob_kernel.mbb_lnprob = rec
        try:
            yield seen
        finally:
            lnprob_kernel.mbb_lnprob = orig
            orig.launches = rec.launches
    return ctx()


def _map_modes(ci, card, times, by_path):
    """fit_map on the card and on the CPU (same seed, same starts), the
    modes held together; then map_importance's 2048 draws through K1, whose
    output on them is held against the plain version as phase 19 holds
    it."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.likelihood import LNPROB_FLOOR
    cfg = vp.CONFIGS[ci]
    label = cfg["label"]
    flux, unc, cov = vp.mock_data(cfg)
    fits, r = {}, {}
    for dev in (DEVICE, "cpu"):
        fits[dev] = port_fitter(ci, flux, unc, cov, seed=31, device=dev)
        r[dev], times[f"fit_map {label} {dev}"] = _timed(fits[dev].fit_map)
    g, c = r[DEVICE], r["cpu"]
    dx = float(np.max(np.abs(g.x - c.x) / np.maximum(c.sigma, 1e-12)))
    ok = dx < 1e-2 and abs(g.lnprob - c.lnprob) < 1e-3 \
        and g.interior == c.interior and np.all(np.isfinite(g.sigma))
    log(f"[21] {label}: fit_map (8 starts, 150 Adam + 12 Newton steps) on "
        f"the card {times[f'fit_map {label} {DEVICE}']:.2f} s, on the CPU "
        f"{times[f'fit_map {label} cpu']:.2f} s (host clock); mode "
        f"{np.array2string(g.x, precision=5)}, |dx| max {dx:.2e} Laplace "
        f"sigma (tol 1e-2), dlnp {g.lnprob - c.lnprob:.2e} (tol 1e-3), "
        f"interior {g.interior} {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"{label}: the card's MAP mode is not the "
                             "CPU's")
    path = f"map_importance {label}"
    _counts(reset=True)
    with _recording_k1() as seen:
        (x, logw, ess), t = _timed(
            lambda: fits[DEVICE].map_importance(2048))
    by_path[path] = _path_counts(path, "mbb_lnprob", 1)
    times[path] = t
    xk, ops, got = seen[0]
    want = ops.plain(xk)
    floor = want <= LNPROB_FLOOR / 2
    k1_ok = (xk.shape == (2048, g.x.size)
             and torch.equal(got <= LNPROB_FLOOR / 2, floor)
             and bool((got[floor] == LNPROB_FLOOR).all())
             and torch.allclose(got[~floor], want[~floor], rtol=K1_RTOL,
                                atol=K1_ATOL))
    dk1 = float((got[~floor] - want[~floor]).abs().max()) \
        if (~floor).any() else 0.0
    cen = fits[DEVICE].map_par_cen("T")
    ok = k1_ok and x.shape == (2048, g.x.size) and np.isfinite(cen[0]) \
        and 0.0 <= ess <= 2048.0
    log(f"[21] {path}: 2048 Laplace draws through K1 in {1e3 * t:.1f} ms "
        f"(host clock), ess {ess:.1f}, T {cen[0]:.4g} +{cen[1]:.3g} "
        f"-{cen[2]:.3g}; K1 on those draws against the plain version: "
        f"{int(floor.sum())} floored, max |d| {dk1:.3g} (rtol {K1_RTOL:g}, "
        f"atol {K1_ATOL:g}) {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"{path}: bad importance sample")


# Burn-in of the MAP-seeded sentinel fits. The protocol re-centers the
# ensemble on its best burn-in sample in a ball of 0.1x the default scatter
# after the first burn, so the MAP ball's spread does not survive into the
# re-burn: at nburn=50 config 6's widths came out 8-18% narrow (CPU
# rehearsal, 250 walkers x 250 steps, 2 fits), at 200 within 5%.
MAP_SEEDED_BURN = 200


def _map_seeded_sentinel(ci, card, times, by_path):
    """SENTINEL.k_jax x (fit_map, run(init="map", MAP_SEEDED_BURN, 250)) of
    sentinel config `ci` on K2, held against its recorded fp64 oracle
    moments as phase 5 holds its fits."""
    from tools import validate_tpu_parity as vp
    with open(vp.SENTINEL_PATH) as fh:
        reference = json.load(fh)["configs"][str(ci)]
    cfg = vp.CONFIGS[ci]
    label = cfg["label"]
    free = vp.free_indices(cfg)
    flux, unc, cov = vp.mock_data(cfg)
    meds, wids, ses = [], [], []
    for j in range(vp.SENTINEL.k_jax):
        fit = port_fitter(ci, flux, unc, cov, seed=2000 + 17 * j)
        _, t_map = _timed(fit.fit_map)
        path = f"run(init='map') {label} #{j}"
        _counts(reset=True)
        _, t = _timed(lambda: fit.run(nburn=MAP_SEEDED_BURN, nsteps=250,
                                      init="map"))
        by_path[path] = _path_counts(path, "mbb_stretch_run", 3)
        times[f"fit_map {label} #{j}"], times[path] = t_map, t
        flat = fit.chain.reshape(-1, 5)
        m, w = vp.stats(flat, free)
        meds.append(m)
        wids.append(w)
        ses.append(tau_se(fit.chain_free.double().cpu().numpy(), flat, free))
        log(f"[21] {label} #{j}: fit_map {t_map:.2f} s, run(init='map', "
            f"nburn={MAP_SEEDED_BURN}, nsteps=250) {t:.2f} s (host clock, "
            f"{card})")
    mj, wj, sjm, sjw = vp.aggregate(meds, wids, ses)
    ok, lines = vp.check_sentinel(
        {"medians": mj, "widths": wj, "se_medians": sjm, "se_widths": sjw},
        reference)
    log(f"[21] {label}: MAP-seeded fits x {NWALKERS} walkers against the "
        f"recorded fp64 oracle moments:")
    for line in lines:
        log(f"[21]   {line}")
    if not ok:
        raise AssertionError(f"{label}: MAP-seeded posterior off the "
                             "recorded oracle moments")
    return fit


def _timed_twice(tag, fn, card, times):
    """fn() on its first and its second call, host clock with the card
    synchronized. Returns the second call's result."""
    for call in ("first", "second"):
        out, t = _timed(fn)
        times[f"{tag} {call}"] = t
    log(f"[21] {tag}: first call {times[f'{tag} first']:.2f} s, second call "
        f"{times[f'{tag} second']:.2f} s (host clock, {card})")
    return out


def phase_map_checks(card):
    """MAP triage and model checking on the card through the user's entry
    points (see the module docstring, phase 21). Returns (launches by
    kernel and path, seconds by step)."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBResults

    times = {}
    k1, k2, k3 = {}, {}, {}
    t0 = time.time()
    for ci in (2, 3):
        _map_modes(ci, card, times, k1)
    fit1 = None
    for ci in vp.SENTINEL_CONFIGS:
        fit = _map_seeded_sentinel(ci, card, times, k2)
        fit1 = fit if ci == vp.SENTINEL_CONFIG else fit1

    # the batch cell: 256 sources x 250 walkers x 5 bands
    flux, unc = batch_data(NSOURCES, seed=3000, missing_every=16)
    mf = batch_fitter(flux, unc, seed=4321)
    _, times["run_map"] = _timed(mf.run_map)
    ess, times["map_importance batch"] = _timed(mf.map_importance)
    cen = mf.map_cen("T")
    ok = (np.all(np.isfinite(mf.map_lnprob)) and np.all(np.isfinite(cen))
          and ess.shape == (NSOURCES,) and np.all(np.isfinite(ess)))
    log(f"[21] MultiFitter {NSOURCES} sources: run_map (8 starts each, "
        f"{8 * NSOURCES} optimizer rows) {times['run_map']:.2f} s, "
        f"map_importance (512 draws per source, plain torch) "
        f"{times['map_importance batch']:.2f} s (host clock); "
        f"{int(mf.map_interior.sum())} interior modes, median ess "
        f"{np.median(ess):.1f} {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("run_map / map_importance not finite")
    path = f"MultiFitter.run(init='map') {NSOURCES}x{NWALKERS}"
    _counts(reset=True)
    _, times[path] = _timed(lambda: mf.run(nburn=50, nsteps=250, init="map"))
    k3[path] = _path_counts(path, "mbb_multi_stretch_run", 3)
    af = mf.acceptance_fraction.mean(axis=1)
    log(f"[21] {path}: {times[path]:.2f} s (host clock), acceptance per "
        f"source {af.min():.3f}..{af.max():.3f} ({card})")
    n = NSOURCES * 250 * NWALKERS
    ppc = _timed_twice(f"posterior_predictive {NSOURCES} x "
                       f"{250 * NWALKERS}", mf.posterior_predictive, card,
                       times)
    loo = _timed_twice(f"compute_loo {NSOURCES} x {250 * NWALKERS}",
                       mf.compute_loo, card, times)
    ok = (ppc.chi2_obs.shape == (NSOURCES, 250 * NWALKERS)
          and np.all(np.isfinite(ppc.p_value))
          and np.all(np.isfinite(loo.elpd_loo))
          and np.all(loo.n_points == 5 - (np.arange(NSOURCES) % 16 == 1)))
    log(f"[21] {n:,} samples: PPC median p {np.median(ppc.p_value):.3f}, "
        f"{int((ppc.p_value < 0.01).sum())} sources with p < 0.01, mean "
        f"chi2_rep {ppc.chi2_rep.mean():.3f} (ndata 4-5); total elpd_loo "
        f"{np.sum(loo.elpd_loo):.2f}, {int((loo.n_bad_k > 0).sum())} "
        f"sources with k-hat > 0.7 {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("batch PPC / LOO not finite or misshapen")

    # exact leave-one-band-out refits at config 1, against PSIS-LOO
    res = MBBResults(fit=fit1)
    psis = res.compute_loo()
    path = "compute_loo_exact config1 thick4"
    _counts(reset=True)
    exact, times[path] = _timed(fit1.compute_loo_exact)
    k3[path] = _path_counts(path, "mbb_multi_stretch_run", 3)
    good = psis.pareto_k <= 0.7
    diff = np.abs(exact.pointwise_loo - psis.pointwise_loo)
    ok = (np.all(np.isfinite(exact.pointwise_loo))
          and np.all(np.isfinite(exact.se_mc))
          and np.array_equal(exact.point_index, psis.point_index)
          and np.all(diff[good] < 0.3))
    log(f"[21] {path}: {exact.pointwise_loo.size} refits x "
        f"{exact.nsamples} samples in {times[path]:.2f} s (host clock); "
        f"exact {np.array2string(exact.pointwise_loo, precision=3)}, PSIS "
        f"{np.array2string(psis.pointwise_loo, precision=3)}, k-hat "
        f"{np.array2string(psis.pareto_k, precision=2)}; |exact - PSIS| <= "
        f"0.3 where k-hat <= 0.7 {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("exact LOO refits disagree with PSIS-LOO")
    log(f"[21] phase 21: {time.time() - t0:.1f} s")
    return {"mbb_lnprob": k1, "mbb_stretch_run": k2,
            "mbb_multi_stretch_run": k3}, times


# Phase 22's depths. run_pt runs at its defaults (12 rungs, beta_min="auto",
# 300 burn + 1000 steps); run_hmc is cut from its defaults (500 warmup +
# 1000 steps x 16 leapfrog steps) and the defaults' time is worked out from
# the measured time per gradient: plain torch there takes ~14 ms per
# gradient on an H100 (~910 kernels per leapfrog step), so 200 + 400 x 8
# took 68 s and the batch tier's 100 + 200 x 8 37 s a call. The single fit
# is cut to half (its posterior check needs the 8-step trajectories: at 4
# steps and 100 + 200 alpha's median sat outside 3 sigma_MC in a CPU
# rehearsal), the batch tier, which has no posterior check, to a quarter.
HMC_DEPTH = {"nwarmup": 100, "nsteps": 200, "n_leapfrog": 8}
HMC_PROFILE_DEPTH = {"nwarmup": 2, "nsteps": 4, "n_leapfrog": 8}
# The CPU's run_pt for the evidence check: the card's call with a shorter
# production (the CPU took 39.5 s for the whole default call on the card's
# host). The stepping-stone estimate moves with the production's length (at
# config 2, 200 records gave 3.5 nats more than 1000 in a CPU rehearsal at
# 250 walkers, on the same draws) and its naive error ignores the
# autocorrelation (0.0106 against 0.70 from batch means), so the check holds
# the CPU's first PT_CPU_NSTEPS records against the card's, each estimate's
# error from batch means of its own records (PT_BATCHES batches).
PT_CPU_NSTEPS = 200
PT_BATCHES = 10
# The batch tiers at 16 of the batch cell's sources (full width), once whole
# and once in production segments of TIER_SEGMENT records.
TIER_SOURCES = 16
TIER_SEGMENT = 50
PT_BATCH = {"nrungs": 12, "nburn": 100, "nsteps": 200}
# (HMC_BATCH is cut from 50 + 100 x 4 leapfrog steps to make room for phase
# 25: its checks, whole against segmented bitwise and finite results, do
# not depend on the depth)
HMC_BATCH = {"nwarmup": 25, "nsteps": 100, "n_leapfrog": 2}
# An accept or swap decision whose log-uniform sits this close to its
# threshold may fall either way between K1 and the plain likelihood.
PT_MARGIN = 1e-4


def _recording_pt_steps():
    """A context in which every tempered step the run loops make through
    tempering.pt_step_from_uniforms is recorded as (state before the step,
    betas) in the list it yields (the states are not modified in place, so
    no copy is needed)."""
    import contextlib
    from mbb_emcee_tpu_torch import tempering

    @contextlib.contextmanager
    def ctx():
        orig, seen = tempering.pt_step_from_uniforms, []

        def rec(state, lnprob_batch, betas, *args, **kwargs):
            seen.append((state, betas))
            return orig(state, lnprob_batch, betas, *args, **kwargs)
        tempering.pt_step_from_uniforms = rec
        try:
            yield seen
        finally:
            tempering.pt_step_from_uniforms = orig
    return ctx()


def _pt_decisions(state, lnprob, betas, a):
    """The accept decisions of one tempered step from `state` on its own
    draws, each with its margin log(u) - threshold: [(accepts, margins)]
    for half A, half B and the swaps of the step's parity, in the order the
    step takes them."""
    import torch
    from mbb_emcee_tpu_torch import tempering
    from mbb_emcee_tpu_torch.likelihood import SUPPORT_FLOOR
    from mbb_emcee_tpu_torch.ops.philox import pt_uniforms
    K, W, d = state.pos.shape
    half = W // 2
    u, us = pt_uniforms(state.seed, state.step, 1, K, W, state.pos.device)
    u, us = u[0], us[0]
    pos, lnp = state.pos, state.lnp.clone()
    groups, new = [], []
    for act in (slice(0, half), slice(half, W)):
        u3 = u[..., act]
        passive = pos[:, half:] if act.start == 0 else new[0]
        active, lnp_a = pos[:, act], lnp[:, act]
        z = ((a - 1.0) * u3[0] + 1.0) ** 2 / a
        j = torch.clamp((u3[1] * half).to(torch.int64), max=half - 1)
        partners = torch.take_along_dim(passive, j[..., None], dim=-2)
        prop = partners + z[..., None] * (active - partners)
        lp = lnprob(prop.reshape(-1, d)).reshape(K, half)
        ratio = (d - 1) * torch.log(z) + betas[:, None] * (lp - lnp_a)
        ok = (torch.log(u3[2]) < ratio) & (lp > SUPPORT_FLOOR)
        marg = torch.where(lp > SUPPORT_FLOOR, torch.log(u3[2]) - ratio,
                           torch.full_like(ratio, torch.inf))
        groups.append((ok.reshape(-1), marg.reshape(-1)))
        new.append(torch.where(ok[..., None], prop, active))
        lnp[:, act] = torch.where(ok, lp, lnp_a)
    _, _, ok_s, pair_on = tempering._swap(torch.cat(new, dim=1), lnp, betas,
                                          us, state.nsteps)
    thr = (betas[:-1] - betas[1:])[:, None] * (lnp[1:] - lnp[:-1])
    groups.append((ok_s[pair_on].reshape(-1),
                   (torch.log(us) - thr)[pair_on].reshape(-1)))
    return groups


def _pt_replay(tag, got, want, chains, lnprob_k1, lnprob_plain, a):
    """Compare two tempered runs' recorded steps (phase 22): positions
    bitwise up to the first step where they part (the cold chains' last
    record stands for the state after the last step), lnprob within K1's
    tolerance meanwhile. Where they part, the first group of decisions
    (half A, half B, swaps) taken differently must have every such decision
    within PT_MARGIN of its threshold on both sides. Returns (parting step
    or None, steps compared, the largest such margin)."""
    import torch
    n = min(len(got), len(want))
    part = None
    for i in range(1, n):
        sg, sw = got[i][0], want[i][0]
        if not torch.equal(sg.pos, sw.pos):
            part = i - 1
            break
        if not torch.allclose(sg.lnp, sw.lnp, rtol=K1_RTOL, atol=K1_ATOL):
            raise AssertionError(f"[{tag}] lnprob of the K1 and plain runs "
                                 f"part at step {i} with equal positions")
    if part is None and not torch.equal(*chains):
        part = n - 1
    if part is None:
        if len(got) != len(want):
            raise AssertionError(f"[{tag}] the runs took {len(got)} and "
                                 f"{len(want)} steps")
        log(f"[22] {tag}: K1 run and plain replay bitwise over all {n} "
            "tempered steps PASS")
        return None, n, 0.0
    (sg, bg), (sw, bw) = got[part], want[part]
    worst, nd = float("inf"), 0
    for (ag, mg), (aw, mw) in zip(_pt_decisions(sg, lnprob_k1, bg, a),
                                  _pt_decisions(sw, lnprob_plain, bw, a)):
        diff = ag != aw
        if diff.any():
            nd = int(diff.sum())
            worst = float(torch.maximum(mg[diff].abs(),
                                        mw[diff].abs()).max())
            break
    ok = worst < PT_MARGIN
    log(f"[22] {tag}: K1 run and plain replay bitwise for {part} of {n} "
        f"tempered steps; at step {part} {nd} decision(s) fell differently, "
        f"each within {worst:.3g} of its threshold (limit {PT_MARGIN:g}) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] K1 and plain runs part on a "
                             "decision away from its threshold")
    return part, n, worst


def _ss_batch_means(steps, nprod, nrec):
    """(lnZ, its batch-means standard error) from the stepping-stone sums of
    the first nrec - 1 records of a recorded tempered run's production of
    nprod records (each step's recorded state is the record of the step
    before; the last record has none): lnZ over those records, and the
    spread of PT_BATCHES batches' lnZ over sqrt(PT_BATCHES)."""
    import numpy as np
    from mbb_emcee_tpu_torch.tempering import SSStats
    first = len(steps) - nprod + 1
    recs = steps[first:first + nrec - 1]
    b = recs[0][1].double().cpu().numpy()
    lnp = np.stack([st.lnp.double().cpu().numpy() for st, _ in recs])
    v = (b[:-1] - b[1:])[None, :, None] * lnp[:, 1:, :]     # (R, K-1, W)

    def logz(blk):
        m = blk.max(axis=(0, 2))
        e = np.exp(blk - m[None, :, None])
        return SSStats(m, e.sum(axis=(0, 2)), (e * e).sum(axis=(0, 2)),
                       float(e.shape[0] * e.shape[2])).logz()[0]

    parts = [logz(blk) for blk in np.array_split(v, PT_BATCHES)]
    return float(logz(v)), float(np.std(parts, ddof=1)
                                 / np.sqrt(PT_BATCHES))


def _posterior_vs(tag, fit, ref, rel, free, phase=22,
                  ref_tag="K2 run(200, 1000)"):
    """Medians and 68% widths of `fit` against the K2 fit `ref` (`ref_tag`),
    each within max(rel, 3 sigma_MC) (sigma_MC of both runs, from their
    measured autocorrelation times); the lines carry the phase number
    `phase`."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    rows, ok_all = [], True
    stats = []
    for f in (fit, ref):
        flat = f.chain.reshape(-1, 5)
        m, w = vp.stats(flat, free)
        sm, sw = tau_se(f.chain_free.double().cpu().numpy(), flat, free)
        stats.append((m, w, sm, sw))
    (m1, w1, s1m, s1w), (m2, w2, s2m, s2w) = stats
    for k, pi in enumerate(free):
        tm = max(rel * abs(m2[k]), 3 * np.hypot(s1m[k], s2m[k]))
        tw = max(rel * w2[k], 3 * np.hypot(s1w[k], s2w[k]))
        ok = abs(m1[k] - m2[k]) <= tm and abs(w1[k] - w2[k]) <= tw
        ok_all &= ok
        rows.append(f"p{pi} median {m1[k]:.5g} vs {m2[k]:.5g} (tol {tm:.3g}), "
                    f"width {w1[k]:.4g} vs {w2[k]:.4g} (tol {tw:.3g}) "
                    f"{'PASS' if ok else 'FAIL'}")
    log(f"[{phase}] {tag} against {ref_tag}, max({100 * rel:g}%, "
        "3 sigma_MC):")
    for r in rows:
        log(f"[{phase}]   {r}")
    if not ok_all:
        raise AssertionError(f"{tag}: posterior off the K2 fit's")


def _profiled_launches(fn):
    """(device kernels, host cudaLaunchKernel calls) of one call of fn()
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = host = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
        elif e.key.startswith("cudaLaunchKernel"):
            host += e.count
    return kernels, host


def _tier_segments(tag, run, flushes):
    """run(checkpoint, interval) whole and in production segments of
    TIER_SEGMENT records through the checkpoint= path, the flush replaced by
    a recorder (the card's machine has no h5py). Returns (whole, segmented,
    seconds of each)."""
    from mbb_emcee_tpu_torch import checkpoint
    whole, t_whole = _timed(lambda: run(None, 100))
    orig = checkpoint.save_tier_checkpoint
    seen = []
    checkpoint.save_tier_checkpoint = lambda path, tier, *a, **k: \
        seen.append(tier)
    try:
        seg, t_seg = _timed(lambda: run(
            os.path.join(REPO, "build", "phase22-never-written.h5"),
            TIER_SEGMENT))
    finally:
        checkpoint.save_tier_checkpoint = orig
    import torch
    same = (torch.equal(whole.chain_free, seg.chain_free)
            and torch.equal(whole.lnprobability, seg.lnprobability))
    ok = same and len(seen) == flushes
    log(f"[22] {tag}: whole {t_whole:.2f} s, in {len(seen)} production "
        f"segments of {TIER_SEGMENT} records (want {flushes}) {t_seg:.2f} s "
        f"(host clock); chains bitwise "
        f"{'equal PASS' if ok else 'DIFFERENT FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: segmented production is not the "
                             "whole run")
    return whole, t_whole, t_seg


def phase_tiers(card):
    """HMC and parallel tempering through the user's entry points (see the
    module docstring, phase 22). Returns (K1 launches of run_pt, seconds
    and counts by step)."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import tempering
    from mbb_emcee_tpu_torch.fitter import philox_key

    t0 = time.time()
    out = {}
    cfg = vp.CONFIGS[2]
    free = vp.free_indices(cfg)
    flux, unc, cov = vp.mock_data(cfg)
    ref = port_fitter(2, flux, unc, cov, seed=2201)
    _, out["K2 run(200, 1000)"] = _timed(lambda: ref.run(nburn=200,
                                                         nsteps=1000))

    # -- single-fit PT at its defaults on K1, and its plain replay
    fit = port_fitter(2, flux, unc, cov, seed=2202)
    _counts(reset=True)
    with _recording_pt_steps() as got:
        _, t_pt = _timed(fit.run_pt)
    c = _counts()
    res = fit.pt_result
    K = res.betas.size
    nburn2 = max(300 // 2, 50)
    steps = 300 + nburn2 + 1000
    want = 2 * steps + (1 if K == 12 else 2)
    plain = c["plain_sampler_runs"] + c["plain_multi_runs"]
    ok = c["mbb_lnprob"] == want and plain == 0 and len(got) == steps
    log(f"[22] run_pt() at its defaults: {K} rungs x {NWALKERS} walkers, "
        f"{steps} tempered steps in {t_pt:.2f} s (host clock); "
        f"{c['mbb_lnprob']} K1 launches of {K * NWALKERS // 2} vectors "
        f"each (want 2 per step + {want - 2 * steps} init = {want}), "
        f"{plain} plain runs {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("run_pt did not run through K1 alone")
    out["run_pt"], out["run_pt K1 launches"] = t_pt, c["mbb_lnprob"]
    out["run_pt rungs"] = K
    lnprob_plain, _, x0 = fit._tier_setup("", None, None, plain=True)
    from mbb_emcee_tpu_torch.ops import lnprob_kernel
    ops = lnprob_kernel.prepare_lnprob_inputs(
        fit.phot, fit.shape, fit._effective_spec(), device=DEVICE)
    _counts(reset=True)
    with _recording_pt_steps() as plain_steps:
        rp, t_plain = _timed(lambda: tempering.pt_sample(
            lnprob_plain, x0, philox_key(fit.seed), nburn=300, nsteps=1000,
            a=fit.a))
    if _counts()["mbb_lnprob"] != 0:
        raise AssertionError("the plain replay launched K1")
    out["run_pt plain replay"] = t_plain
    part, n, margin = _pt_replay(
        "run_pt", got, plain_steps, (fit.chain_free[-1], rp.chain[-1]),
        lambda x: lnprob_kernel.mbb_lnprob(x.contiguous(), ops),
        lnprob_plain, fit.a)
    out["run_pt parting step"] = part
    lz_rec, se = _ss_batch_means(got, 1000, 1000)
    lz_pre, se_pre = _ss_batch_means(got, 1000, PT_CPU_NSTEPS)
    del got, plain_steps
    _posterior_vs("run_pt cold chain", fit, ref, 0.01, free)
    cpu = port_fitter(2, flux, unc, cov, seed=2202, device="cpu")
    with _recording_pt_steps() as cpu_steps:
        _, t_cpu = _timed(lambda: cpu.run_pt(nsteps=PT_CPU_NSTEPS))
    lc_rec, se_cpu = _ss_batch_means(cpu_steps, PT_CPU_NSTEPS, PT_CPU_NSTEPS)
    del cpu_steps
    (lz, dz), (lc, dc) = fit.logz_pt, cpu.logz_pt
    tol = 3 * np.hypot(se_pre, se_cpu)
    ok = (abs(lz_pre - lc_rec) <= tol and abs(lz_rec - lz) < 3 * se
          and abs(lc_rec - lc) < 3 * se_cpu and np.isfinite(fit.logz_ti[0]))
    log(f"[22] logz_pt {lz:.4f} on the card (naive error {dz:.4f}, batch "
        f"means {se:.4f}; {lz_rec:.4f} from records 1-999), {lc:.4f} on the "
        f"CPU (run_pt(nsteps={PT_CPU_NSTEPS}), {t_cpu:.1f} s; naive "
        f"{dc:.4f}, batch means {se_cpu:.4f}); records 1-"
        f"{PT_CPU_NSTEPS - 1}: card {lz_pre:.4f}, CPU {lc_rec:.4f}, |d| "
        f"{abs(lz_pre - lc_rec):.4f} <= 3 x combined batch-means error "
        f"{tol:.4f}; logz_ti {fit.logz_ti[0]:.3f}, replay logz "
        f"{rp.logz:.4f} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("run_pt's evidence on the card is not the "
                             "CPU's")
    out["logz_pt"] = {"card": [lz, dz, se], "cpu": [lc, dc, se_cpu],
                      "card first records": [lz_pre, se_pre],
                      "cpu records": [lc_rec, se_cpu]}

    # -- single-fit HMC (plain likelihood under torch.autograd)
    hfit = port_fitter(2, flux, unc, cov, seed=2203)
    _counts(reset=True)
    _, t_hmc = _timed(lambda: hfit.run_hmc(**HMC_DEPTH))
    c = _counts()
    grads = 1 + (HMC_DEPTH["nwarmup"] + HMC_DEPTH["nsteps"]) \
        * HMC_DEPTH["n_leapfrog"]
    us_grad = 1e6 * t_hmc / grads
    log(f"[22] run_hmc({HMC_DEPTH}): {t_hmc:.2f} s (host clock), "
        f"{grads} gradient evaluations, {us_grad:.0f} us each; acceptance "
        f"{hfit.acceptance_fraction.mean():.3f}, step size "
        f"{hfit.hmc_result.step_size:.4g}; K1 launches {c['mbb_lnprob']} "
        f"({card})")
    _posterior_vs("run_hmc", hfit, ref, 0.02, free)
    prof = port_fitter(2, flux, unc, cov, seed=2204)
    kernels, host = _profiled_launches(
        lambda: prof.run_hmc(**HMC_PROFILE_DEPTH))
    leap = (HMC_PROFILE_DEPTH["nwarmup"] + HMC_PROFILE_DEPTH["nsteps"]) \
        * HMC_PROFILE_DEPTH["n_leapfrog"]
    default_grads = 1 + (500 + 1000) * 16
    log(f"[22] run_hmc({HMC_PROFILE_DEPTH}) under torch.profiler: "
        f"{kernels} device kernels, {host} cudaLaunchKernel calls, "
        f"{kernels / leap:.1f} kernels per leapfrog step ({leap} steps, "
        f"{leap + 1} gradients); run_hmc() at its defaults ({default_grads} "
        f"gradients) would take ~{default_grads * us_grad / 1e6:.0f} s at "
        f"the measured {us_grad:.0f} us per gradient ({card})")
    out.update({"run_hmc": t_hmc, "run_hmc us per gradient": us_grad,
                "run_hmc kernels per leapfrog step": kernels / leap,
                "run_hmc profiled kernels": kernels,
                "run_hmc profiled launch calls": host,
                "run_hmc defaults s (worked out)":
                    default_grads * us_grad / 1e6})

    # -- the batch tiers at TIER_SOURCES of the batch cell's sources
    bflux, bunc = batch_data(TIER_SOURCES, seed=3000, missing_every=16)

    def run_pt(ck, interval):
        mf = batch_fitter(bflux, bunc, seed=4322)
        return mf.run_pt(**PT_BATCH, checkpoint=ck,
                         checkpoint_interval=interval)

    def run_hmc(ck, interval):
        mf = batch_fitter(bflux, bunc, seed=4323)
        return mf.run_hmc(**HMC_BATCH, checkpoint=ck,
                          checkpoint_interval=interval)

    _counts(reset=True)
    mp, t1, t2 = _tier_segments(
        f"MultiFitter.run_pt({PT_BATCH}) x {TIER_SOURCES} sources", run_pt,
        PT_BATCH["nsteps"] // TIER_SEGMENT)
    mh, t3, t4 = _tier_segments(
        f"MultiFitter.run_hmc({HMC_BATCH}) x {TIER_SOURCES} sources",
        run_hmc, HMC_BATCH["nsteps"] // TIER_SEGMENT)
    c = _counts()
    ok = (np.all(np.isfinite(mp.logz_pt[0]))
          and np.all(np.isfinite(mp.par_cen("T")))
          and np.all(np.isfinite(mh.par_cen("T")))
          and np.all(mh.hmc_step_size > 0) and c["mbb_lnprob"] == 0
          and c["mbb_multi_stretch_run"] == 0)
    log(f"[22] batch PT: {mp.pt_betas.shape[1]} rungs, lnZ "
        f"{mp.logz_pt[0].min():.2f}..{mp.logz_pt[0].max():.2f}, cold "
        f"acceptance {mp.acceptance_fraction.mean():.3f}; batch HMC: "
        f"acceptance {mh.acceptance_fraction.mean():.3f}, step sizes "
        f"{mh.hmc_step_size.min():.3g}..{mh.hmc_step_size.max():.3g}; no "
        f"kernel launched (plain batch likelihood) "
        f"{'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("batch PT / HMC results not finite")
    out.update({"MultiFitter.run_pt whole": t1,
                "MultiFitter.run_pt segmented": t2,
                "MultiFitter.run_pt rungs": int(mp.pt_betas.shape[1]),
                "MultiFitter.run_hmc whole": t3,
                "MultiFitter.run_hmc segmented": t4})
    log(f"[22] phase 22: {time.time() - t0:.1f} s")
    return out["run_pt K1 launches"], out


# Phase 23: nested sampling and the population tier, within ~90 s (its
# calls are host-bound, so the host sets most of its time). The plain
# replay of the K1 nested run covers its first NESTED_REPLAY_ITERS
# iterations: the plain likelihood is a chain of some hundred small launches,
# ~3.6 ms a call on an H100, and the run's ~19,500 calls would take ~70 s.
NESTED_REPLAY_ITERS = 20
# A nested decision (fy > L* of a constrained step, the order of the live
# points) that sits this close to its threshold, relative to max(1, |L*|),
# may fall either way between K1 and the plain likelihood.
NESTED_MARGIN = 1e-4
# Iterations of the compute_evidence call traced by torch.profiler for the
# device's busy share.
NESTED_PROFILE_ITERS = 20
# The batch's evidence runs the plain batch likelihood, whose calls are
# launch-bound (~4.7 ms each at any source count on an H100): at nlive 512
# its ~600 iterations took 91 s at 16 sources and at nlive 128 its ~140
# took 20-32 s, so it runs NESTED_BATCH_SOURCES of the batch cell's sources
# (full width) at NESTED_BATCH_NLIVE live points.
NESTED_BATCH_SOURCES = 16
NESTED_BATCH_NLIVE = 64
# The hyper-posterior's evidence at HYPER_NLIVE live points (at 512, 469
# iterations took 32 s on an H100; at 128, 111 took 8-11 s), and the
# correlated population's run at CORRELATED_DEPTH (the independent family's
# runs at run(200, 1000)).
HYPER_NLIVE = 64
# (CORRELATED_DEPTH is cut from run(100, 500) to make room for phase 25;
# its check is a finite rho)
CORRELATED_DEPTH = {"nburn": 100, "nsteps": 250}
# The population fit at full size and depth (2,800 calls of a (32, 256,
# 4096, 2) hyper-lnprob) would keep the CPU far past the phase's budget, so
# it is held against the CPU's at POP_CPU_SAMPLES stored samples per source
# and POP_CPU_DEPTH, the same call on both devices; the full-size
# hyper-lnprob is held against the CPU's at POP_CHECK_VECTORS hyper
# vectors.
POP_CPU_SAMPLES = 128
POP_CPU_DEPTH = {"nburn": 50, "nsteps": 250}
POP_CHECK_VECTORS = 8
# The CPU references run in worker processes beside the card's work, one
# thread each, leaving cores to the card's host-bound side.
CPU_WORKERS, CPU_WORKER_THREADS = 3, 1


def _cpu_worker_setup():
    import torch
    torch.set_num_threads(CPU_WORKER_THREADS)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    use_repo_tests_package()


def _cpu_evidence_single(seed):
    """The CPU's compute_evidence() at config 2 (a reference worker): (lnZ,
    its error, n_iter, converged, seconds)."""
    _cpu_worker_setup()
    from tools import validate_tpu_parity as vp
    flux, unc, cov = vp.mock_data(vp.CONFIGS[2])
    fit = port_fitter(2, flux, unc, cov, seed=seed, device="cpu")
    ev, t = _timed_cpu(fit.compute_evidence)
    return ev.logz, ev.logz_err, ev.n_iter, ev.converged, t


def _cpu_evidence_batch(nsrc, seed, nlive):
    """The CPU's MultiFitter.compute_evidence(nlive=nlive) on the batch
    cell's first `nsrc` sources (a reference worker): (lnZ (S,), errors
    (S,), n_iter (S,), seconds)."""
    _cpu_worker_setup()
    flux, unc = batch_data(NSOURCES, seed=3000, missing_every=16)
    mf = batch_fitter(flux[:nsrc], unc[:nsrc], seed=seed, device="cpu")
    ev, t = _timed_cpu(lambda: mf.compute_evidence(nlive=nlive))
    return ev.logz, ev.logz_err, ev.n_iter, t


def _cpu_population(samples, names, lo, hi, phis, seed, nsamp, depth):
    """The CPU's side of the population checks (a reference worker): the
    full-size hyper-lnprob at hyper vectors `phis`, then the hyper chain of
    HierarchicalFitter.run(**depth) on the first `nsamp` stored samples per
    source, and its seconds."""
    _cpu_worker_setup()
    import torch
    from mbb_emcee_tpu_torch.hierarchy import (
        HierarchicalFitter, TruncatedGaussianPopulation)
    pop = TruncatedGaussianPopulation.for_box(names, lo, hi)
    lnprob, _, _ = HierarchicalFitter(samples, pop, seed=seed,
                                      device="cpu").build()
    lnp = lnprob(torch.as_tensor(phis)).numpy()
    small = HierarchicalFitter(samples[:, :nsamp], pop, seed=seed,
                               device="cpu")
    _, t = _timed_cpu(lambda: small.run(**depth))
    return lnp, small.chain_free, t


def _timed_cpu(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _recording_nested():
    """A context in which every nested iteration the run loop makes through
    nested.nested_iteration_from_draws is recorded as (state before it, its
    draws) in the list it yields (states are not modified in place)."""
    import contextlib
    from mbb_emcee_tpu_torch import nested

    @contextlib.contextmanager
    def ctx():
        orig, seen = nested.nested_iteration_from_draws, []

        def rec(state, lnprob_batch, draws, *args, **kwargs):
            seen.append((state, draws))
            return orig(state, lnprob_batch, draws, *args, **kwargs)
        nested.nested_iteration_from_draws = rec
        try:
            yield seen
        finally:
            nested.nested_iteration_from_draws = orig
    return ctx()


def _counting_plain_likelihood():
    """A context counting the calls of every plain single-fit likelihood
    built meanwhile (the fitter's and the lnprob kernel operands' plain
    version); yields a one-element list holding the count."""
    import contextlib
    from mbb_emcee_tpu_torch import fitter
    from mbb_emcee_tpu_torch.ops import lnprob_kernel

    @contextlib.contextmanager
    def ctx():
        count = [0]
        origs = (fitter.build_lnprob, lnprob_kernel.build_lnprob)

        def counting(*args, **kwargs):
            fn, fs = origs[0](*args, **kwargs)

            def counted(x):
                count[0] += 1
                return fn(x)
            return counted, fs
        fitter.build_lnprob = lnprob_kernel.build_lnprob = counting
        try:
            yield count
        finally:
            fitter.build_lnprob, lnprob_kernel.build_lnprob = origs
    return ctx()


def _nested_proposals(state, draws, ll_unit, a=2.0):
    """One nested iteration's decisions from `state` (a leading source axis
    of 1) on its draws under the unit-cube likelihood `ll_unit` ((n, d) ->
    (n,)): (order of the live points, L*, [(fy, accepted) of each
    constrained step])."""
    import torch
    from mbb_emcee_tpu_torch.nested import _take
    seed, partner, uz, ua = draws
    live, lnl = state.live, state.lnl
    d, nbatch = live.shape[-1], seed.shape[-1]
    order = torch.argsort(lnl, dim=-1, stable=True)
    lstar = _take(lnl, order[:, nbatch - 1:nbatch])
    surv = _take(live, order[:, nbatch:])
    x, steps = _take(surv, seed), []
    for k in range(partner.shape[-2]):
        p = _take(surv, partner[:, k])
        z = (1.0 / a) * (1.0 + uz[:, k] * (a - 1.0)) ** 2
        y = p + z[..., None] * (x - p)
        inbox = torch.all((y >= 0.0) & (y <= 1.0), dim=-1)
        fy = torch.where(inbox, ll_unit(y[0].contiguous())[None],
                         torch.full_like(y[..., 0], -torch.inf))
        ok = inbox & (fy > lstar) & (torch.log(ua[:, k])
                                     < (d - 1) * torch.log(z))
        steps.append((fy, ok))
        x = torch.where(ok[..., None], y, x)
    return order, lstar, steps


def _nested_replay(tag, got, want, ll_k1, ll_plain):
    """Compare two nested runs' recorded iterations (phase 23): the live
    points (so the dead points) and the stopping rule bitwise up to the
    first iteration where they part, their lnprob within K1's tolerance
    meanwhile and ln Z to rtol 1e-5 (K1 sums the bands in another order
    than the plain version: far out in the prior box, at |lnL| ~ 1e12, the
    two differ by an ulp). Where they part, the first decision taken
    differently -- the order of the live points, an fy > L* of a
    constrained step -- must sit within NESTED_MARGIN of its threshold
    (relative to max(1, |L*|)) on both sides. Returns (parting iteration
    or None, iterations compared, that margin, the largest relative lnprob
    difference before parting)."""
    import torch
    n = min(len(got), len(want))
    part, drift = None, 0.0
    for i in range(n):
        sg, sw = got[i][0], want[i][0]
        if not (torch.equal(sg.live, sw.live)
                and torch.equal(sg.done, sw.done)):
            part = i - 1
            break
        if not (torch.allclose(sg.lnl, sw.lnl, rtol=K1_RTOL, atol=K1_ATOL)
                and torch.equal(sg.lnx, sw.lnx)
                and torch.allclose(sg.lnz, sw.lnz, rtol=1e-5)):
            raise AssertionError(f"[{tag}] lnprob or ln Z of the K1 and "
                                 f"plain runs part at iteration {i} with "
                                 "equal live points")
        fin = torch.isfinite(sw.lnl)
        drift = max(drift, float(((sg.lnl - sw.lnl).abs()
                                  / sw.lnl.abs().clamp(min=1.0))[fin].max()))
    if part is None:
        log(f"[23] {tag}: K1 run and plain replay: live and dead points "
            f"bitwise over all {n} compared iterations, lnprob within "
            f"{drift:.3g} relative, ln Z within rtol 1e-5 PASS")
        return None, n, 0.0, drift
    if part < 0:
        raise AssertionError(f"[{tag}] the K1 and plain runs start from "
                             "different points")
    (sg, dg), (sw, dw) = got[part], want[part]
    og, lg, pg = _nested_proposals(sg, dg, ll_k1)
    ow, lw, pw = _nested_proposals(sw, dw, ll_plain)
    scale = max(1.0, abs(float(lg[0, 0])))
    what, worst = "no decision", float("inf")
    if not torch.equal(og, ow):
        nb = dg[0].shape[-1]
        what = "the order of the live points"
        worst = float((sg.lnl[0, og[0, nb]]
                       - sg.lnl[0, og[0, nb - 1]]).abs()) / scale
    else:
        for k, ((fg, ag), (fw, aw)) in enumerate(zip(pg, pw)):
            diff = ag != aw
            if diff.any():
                what = f"fy > L* at constrained step {k}"
                worst = float(torch.maximum((fg - lg)[diff].abs(),
                                            (fw - lw)[diff].abs()).max()) \
                    / scale
                break
    ok = worst < NESTED_MARGIN
    log(f"[23] {tag}: K1 run and plain replay: live and dead points bitwise "
        f"for {part} of {n} iterations (lnprob within {drift:.3g} "
        f"relative); at iteration {part} {what} fell differently, within "
        f"{worst:.3g} of its threshold relative to max(1, |L*|) (limit "
        f"{NESTED_MARGIN:g}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] K1 and plain nested runs part on a "
                             "decision away from its threshold")
    return part, n, worst, drift


def _weighted_median(x, w):
    import numpy as np
    order = np.argsort(x)
    cw = np.cumsum(w[order])
    return float(np.interp(0.5 * cw[-1], cw, x[order]))


def _nested_vs_k2(ev, ref, free, rel):
    """The nested run's weighted posterior medians against the K2 fit
    `ref`, each within max(rel, 3 sigma_MC): the nested side's sigma_MC
    from the weights' effective sample size, K2's from its autocorrelation
    time."""
    import numpy as np
    w = ev.posterior_weights()
    ess = 1.0 / np.sum(w * w)
    flat = ref.chain.reshape(-1, 5)
    sm_ref, _ = tau_se(ref.chain_free.double().cpu().numpy(), flat, free)
    rows, ok_all = [], True
    for k, pi in enumerate(free):
        x = ev.samples[:, pi]
        m1, m2 = _weighted_median(x, w), float(np.median(flat[:, pi]))
        sd = float(np.sqrt(np.sum(w * (x - np.sum(w * x)) ** 2)))
        tol = max(rel * abs(m2),
                  3 * np.hypot(1.2533 * sd / np.sqrt(ess), sm_ref[k]))
        ok = abs(m1 - m2) <= tol
        ok_all &= ok
        rows.append(f"p{pi} weighted median {m1:.5g} vs {m2:.5g} (tol "
                    f"{tol:.3g}) {'PASS' if ok else 'FAIL'}")
    log(f"[23] compute_evidence's weighted posterior (weights' ESS "
        f"{ess:.0f}) against K2 run(200, 1000), max({100 * rel:g}%, 3 "
        "sigma_MC):")
    for r in rows:
        log(f"[23]   {r}")
    if not ok_all:
        raise AssertionError("compute_evidence: posterior off the K2 fit's")


def _hyper_medians_vs(tag, a, b, rel):
    """Hyper-posterior medians of chains a and b (nrec, W, nfree), each
    within max(rel, 3 sigma_MC) (sigma_MC of both from their measured
    autocorrelation times)."""
    import numpy as np
    free = list(range(a.shape[-1]))
    (ma, sa), (mb, sb) = [
        (np.median(c.reshape(-1, c.shape[-1]), axis=0),
         tau_se(c, c.reshape(-1, c.shape[-1]), free)[0]) for c in (a, b)]
    tol = np.maximum(rel * np.abs(mb), 3 * np.hypot(sa, sb))
    ok = bool(np.all(np.abs(ma - mb) <= tol))
    log(f"[23] {tag}: medians {np.array2string(ma, precision=5)} vs "
        f"{np.array2string(mb, precision=5)}, |d| "
        f"{np.array2string(np.abs(ma - mb), precision=3)} <= tol "
        f"{np.array2string(tol, precision=3)} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: hyper medians differ")


def phase_evidence(card, tiers=None):
    """Nested sampling and the population tier through the user's entry
    points (see the module docstring, phase 23). `tiers` is phase 22's
    result (for its run_pt evidence), None when phase 22 did not run.
    Returns (launches by kernel and path, seconds and numbers by step)."""
    import concurrent.futures
    import multiprocessing
    import warnings
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import nested
    from mbb_emcee_tpu_torch.fitter import philox_key
    from mbb_emcee_tpu_torch.hierarchy import HierarchicalFitter
    from mbb_emcee_tpu_torch.ops import lnprob_kernel

    t0 = time.time()
    out = {}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}
    cfg = vp.CONFIGS[2]
    free = vp.free_indices(cfg)
    flux, unc, cov = vp.mock_data(cfg)
    seed, bseed = 2301, 4331
    bflux, bunc = batch_data(NSOURCES, seed=3000, missing_every=16)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_single = pool.submit(_cpu_evidence_single, seed)
        cpu_batch = pool.submit(_cpu_evidence_batch, 2, bseed,
                                NESTED_BATCH_NLIVE)

        # -- the population stage on the batch cell's K3 run
        mf = batch_fitter(bflux, bunc, seed=4330)
        _counts(reset=True)
        _, out["MultiFitter.run(50, 250)"] = _timed(
            lambda: mf.run(nburn=50, nsteps=250))
        c = _counts()
        if c["mbb_multi_stretch_run"] != 3 or c["plain_multi_runs"]:
            raise AssertionError("the population's batch run did not run "
                                 "through K3 alone")
        launches["mbb_multi_stretch_run"]["population's batch run "
                                          "(phase 23)"] = 3
        params = ("T", "beta")
        hf = HierarchicalFitter.from_batch(mf, params)
        _, out["HierarchicalFitter.run(200, 1000)"] = _timed(
            lambda: hf.run(nburn=200, nsteps=1000))
        pop = hf.population
        phis = np.ascontiguousarray(hf.chain_free[-1, :POP_CHECK_VECTORS],
                                    np.float32)
        cpu_pop = pool.submit(_cpu_population, hf.samples, params,
                              pop.box_lower, pop.box_upper, phis, hf.seed,
                              POP_CPU_SAMPLES, POP_CPU_DEPTH)
        hfc = HierarchicalFitter.from_batch(mf, params, correlated=True)
        _, out["HierarchicalFitter.run, correlated"] = _timed(
            lambda: hfc.run(**CORRELATED_DEPTH))
        evh, out["HierarchicalFitter.compute_evidence"] = _timed(
            lambda: hf.compute_evidence(nlive=HYPER_NLIVE))
        ess, out["reweight_ess"] = _timed(hf.reweight_ess)
        rho = hfc.par_cen("rho_T_beta")
        ok = (np.all(np.isfinite(hf.flatchain)) and evh.converged
              and np.isfinite(evh.logz) and np.all(ess > 1.0)
              and np.isfinite(rho[0]))
        log(f"[23] population of {mf.nsources} sources x "
            f"{hf.samples.shape[1]} stored samples (T, beta): mu_T "
            f"{hf.par_cen('mu_T')[0]:.4g}, sigma_T "
            f"{hf.par_cen('sigma_T')[0]:.4g}, mu_beta "
            f"{hf.par_cen('mu_beta')[0]:.4g}, acceptance "
            f"{hf.acceptance_fraction.mean():.3f}; correlated rho "
            f"{rho[0]:.3f} +{rho[1]:.2g} -{rho[2]:.2g}; hyper lnZ "
            f"{evh.logz:.3f} +- {evh.logz_err:.3f} (nlive {HYPER_NLIVE}, "
            f"{evh.n_iter} iterations); reweight ESS min {ess.min():.0f} / "
            f"median {np.median(ess):.0f} {'PASS' if ok else 'FAIL'} "
            f"({card})")
        log("[23] population seconds (host clock): " + ", ".join(
            f"{k} {out[k]:.2f}" for k in (
                "MultiFitter.run(50, 250)",
                "HierarchicalFitter.run(200, 1000)",
                "HierarchicalFitter.run, correlated",
                "HierarchicalFitter.compute_evidence", "reweight_ess")))
        if not ok:
            raise AssertionError("population stage results not finite")
        small = HierarchicalFitter(hf.samples[:, :POP_CPU_SAMPLES], pop,
                                   seed=hf.seed, device=DEVICE)
        _, out["HierarchicalFitter.run, CPU check depth"] = _timed(
            lambda: small.run(**POP_CPU_DEPTH))
        lnprob_h, _, _ = hf.build()
        lnp_card = lnprob_h(torch.as_tensor(phis, device=DEVICE)).cpu()

        # -- single fit: compute_evidence() at its defaults on K1
        ref = port_fitter(2, flux, unc, cov, seed=2201)
        _counts(reset=True)
        _, out["K2 run(200, 1000)"] = _timed(lambda: ref.run(nburn=200,
                                                             nsteps=1000))
        launches["mbb_stretch_run"]["posterior yardstick (phase 23)"] = \
            _counts()["mbb_stretch_run"]
        fit = port_fitter(2, flux, unc, cov, seed=seed)
        _counts(reset=True)
        with _counting_plain_likelihood() as nplain, \
                _recording_nested() as got:
            ev, t_ev = _timed(fit.compute_evidence)
        c = _counts()
        want = 1 + ev.n_iter * 32
        plain = c["plain_sampler_runs"] + c["plain_multi_runs"] + nplain[0]
        ok = (c["mbb_lnprob"] == want and plain == 0 and ev.converged
              and len(got) == ev.n_iter)
        log(f"[23] compute_evidence() at its defaults (nlive 512, nbatch "
            f"32, nsteps 32), config 2 x {NWALKERS}: lnZ {ev.logz:.4f} +- "
            f"{ev.logz_err:.4f}, H {ev.h:.2f}, n_iter {ev.n_iter}, n_like "
            f"{ev.n_like}, converged {ev.converged}, {t_ev:.2f} s (host "
            f"clock), {1e3 * t_ev / ev.n_iter:.2f} ms per iteration; "
            f"{c['mbb_lnprob']} K1 launches (want 1 + n_iter x 32 = "
            f"{want}), {plain} plain likelihood calls or runs "
            f"{'PASS' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError("compute_evidence did not run through K1 "
                                 "alone")
        launches["mbb_lnprob"]["compute_evidence (phase 23)"] = \
            c["mbb_lnprob"]
        out.update({"compute_evidence": t_ev, "n_iter": ev.n_iter,
                    "n_like": ev.n_like,
                    "ms per iteration": 1e3 * t_ev / ev.n_iter,
                    "lnZ": [ev.logz, ev.logz_err]})

        # its plain replay on the card, the first NESTED_REPLAY_ITERS
        plain_ll, fs = fit._batched_lnprob(plain=True)
        ops = lnprob_kernel.prepare_lnprob_inputs(
            fit.phot, fit.shape, fit._effective_spec(), device=DEVICE)
        lo = torch.as_tensor(np.asarray(fs.lower, np.float32), device=DEVICE)
        wd = torch.as_tensor(np.asarray(fs.upper - fs.lower, np.float32),
                             device=DEVICE)
        _counts(reset=True)
        with _recording_nested() as rep, warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _, out["plain replay"] = _timed(lambda: nested.nested_sample(
                plain_ll, fs.lower, fs.upper, philox_key(seed),
                max_iter=NESTED_REPLAY_ITERS, device=DEVICE))
        if _counts()["mbb_lnprob"] != 0:
            raise AssertionError("the plain replay launched K1")
        log(f"[23] plain replay of {NESTED_REPLAY_ITERS} iterations on the "
            f"card: {out['plain replay']:.2f} s (host clock)")
        part, n, margin, drift = _nested_replay(
            "compute_evidence", got, rep,
            lambda u: lnprob_kernel.mbb_lnprob(lo + wd * u, ops),
            lambda u: plain_ll(lo + wd * u))
        out.update({"replay parting iteration": part,
                    "replay iterations": n,
                    "replay lnprob max relative difference": drift})
        del got, rep

        _nested_vs_k2(ev, ref, free, 0.02)

        # thin against thick at config 2's data (config 2 is the thick one)
        thin = port_fitter(2, flux, unc, cov, seed=seed, opthin=True)
        _counts(reset=True)
        evt, out["compute_evidence, thin"] = _timed(thin.compute_evidence)
        launches["mbb_lnprob"]["compute_evidence, thin (phase 23)"] = \
            _counts()["mbb_lnprob"]
        d = ev.logz - evt.logz
        log(f"[23] thin against thick at config 2's data: lnZ thin "
            f"{evt.logz:.4f} +- {evt.logz_err:.4f} ({evt.n_iter} "
            f"iterations, {out['compute_evidence, thin']:.2f} s), thick "
            f"{ev.logz:.4f} +- {ev.logz_err:.4f}; ln B(thick/thin) {d:.4f} "
            f"+- {np.hypot(ev.logz_err, evt.logz_err):.4f}")
        if not (evt.converged and np.isfinite(d)):
            raise AssertionError("the thin model's evidence did not "
                                 "converge")
        out["lnZ thin"] = [evt.logz, evt.logz_err]

        # the device's busy share of a compute_evidence call
        prof = port_fitter(2, flux, unc, cov, seed=seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _, busy = _profiled_busy_ms(lambda: prof.compute_evidence(
                max_iter=NESTED_PROFILE_ITERS))
            _, wall = _timed(lambda: prof.compute_evidence(
                max_iter=NESTED_PROFILE_ITERS))
        share = None if busy is None else busy / (1e3 * wall)
        log(f"[23] compute_evidence(max_iter={NESTED_PROFILE_ITERS}): "
            f"{wall:.3f} s host clock, device busy "
            f"{'not measured' if busy is None else f'{busy:.1f} ms'}"
            f"{'' if share is None else f' ({100 * share:.1f}%)'} "
            f"(torch.profiler, {card})")
        out.update({"profiled iterations": NESTED_PROFILE_ITERS,
                    "profiled wall s": wall, "device busy ms": busy,
                    "device busy share": share})

        # the PT evidence on the same data (phase 22's run_pt, else its own)
        if tiers is not None:
            lz_pt, _, se_pt = tiers["logz_pt"]["card"]
        else:
            ptf = port_fitter(2, flux, unc, cov, seed=2202)
            with _recording_pt_steps() as steps:
                ptf.run_pt()
            lz_pt = ptf.logz_pt[0]
            se_pt = _ss_batch_means(steps, 1000, 1000)[1]
            del steps
        tol = 3 * np.hypot(ev.logz_err, se_pt)
        ok = abs(ev.logz - lz_pt) <= tol
        log(f"[23] nested lnZ {ev.logz:.4f} against run_pt()'s stepping "
            f"stone {lz_pt:.4f} (batch-means error {se_pt:.4f}): |d| "
            f"{abs(ev.logz - lz_pt):.4f} <= 3 x combined {tol:.4f} "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("nested and PT evidences disagree")

        # -- the batch: per-source evidence on the plain batch likelihood
        mfe = batch_fitter(bflux[:NESTED_BATCH_SOURCES],
                           bunc[:NESTED_BATCH_SOURCES], seed=bseed)
        _counts(reset=True)
        evb, t_b = _timed(lambda: mfe.compute_evidence(
            nlive=NESTED_BATCH_NLIVE))
        c = _counts()
        ok = (bool(evb.converged.all()) and c["mbb_lnprob"] == 0
              and c["mbb_multi_stretch_run"] == 0
              and np.all(np.isfinite(evb.logz)))
        log(f"[23] MultiFitter.compute_evidence(nlive="
            f"{NESTED_BATCH_NLIVE}) over {NESTED_BATCH_SOURCES} of the batch "
            f"cell's sources: {t_b:.2f} s (host clock), iterations "
            f"{evb.n_iter.min()}-{evb.n_iter.max()}, lnZ "
            f"{evb.logz.min():.2f}..{evb.logz.max():.2f}, all converged "
            f"{bool(evb.converged.all())}, no kernel launched (plain batch "
            f"likelihood) {'PASS' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError("batch evidence did not converge")
        out.update({"MultiFitter.compute_evidence": t_b,
                    "batch n_iter": [int(evb.n_iter.min()),
                                     int(evb.n_iter.max())]})

        # -- the CPU references
        t_wait = time.time()
        lc, dc, nc, conv_c, t_c = cpu_single.result()
        bl, bd, bn, t_cb = cpu_batch.result()
        lnp_cpu, chain_cpu, t_pc = cpu_pop.result()
        out["waited for the CPU"] = time.time() - t_wait
        tol = 3 * np.hypot(ev.logz_err, dc)
        ok = conv_c and abs(ev.logz - lc) <= tol
        log(f"[23] the CPU's compute_evidence() on the same seed: lnZ "
            f"{lc:.4f} +- {dc:.4f} ({nc} iterations, {t_c:.1f} s in a "
            f"worker with {CPU_WORKER_THREADS} threads); |d| "
            f"{abs(ev.logz - lc):.4f} <= 3 x combined {tol:.4f} "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("compute_evidence on the card is not the "
                                 "CPU's")
        tol = 3 * np.hypot(evb.logz_err[:2], bd)
        ok = bool(np.all(np.abs(evb.logz[:2] - bl) <= tol))
        log(f"[23] the CPU's batch compute_evidence on sources 0-1: lnZ "
            f"{np.array2string(bl, precision=4)} against the card's "
            f"{np.array2string(evb.logz[:2], precision=4)}, |d| <= 3 x "
            f"combined {np.array2string(tol, precision=4)} ({t_cb:.1f} s) "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("batch evidence on the card is not the "
                                 "CPU's")
        ok = torch.allclose(lnp_card, torch.as_tensor(lnp_cpu), rtol=1e-5,
                            atol=1e-3)
        log(f"[23] full-size hyper-lnprob ({mf.nsources} x "
            f"{hf.samples.shape[1]} x 2) at {POP_CHECK_VECTORS} hyper "
            f"vectors, card against CPU: max |d| "
            f"{float((lnp_card - torch.as_tensor(lnp_cpu)).abs().max()):.3g}"
            f" {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("hyper-lnprob on the card is not the CPU's")
        _hyper_medians_vs(
            f"HierarchicalFitter.run({POP_CPU_DEPTH}) on {POP_CPU_SAMPLES} "
            f"stored samples per source, card against CPU "
            f"({t_pc:.1f} s), max(1%, 3 sigma_MC)", small.chain_free,
            chain_cpu, 0.01)
        out.update({"CPU compute_evidence": t_c,
                    "CPU batch compute_evidence (2 sources)": t_cb,
                    "CPU population check": t_pc})
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    out["phase 23"] = time.time() - t0
    log(f"[23] phase 23: {out['phase 23']:.1f} s")
    return launches, out


# -- phase 24: the generic-model tier (sed.py) --------------------------------
# The generic tier runs no kernel: SEDFitter's stretch move is the plain
# torch sampler over the vmapped user model, launch-bound on the card (~15
# ms per step at 250 walkers on an H100), so its tiers run at depths cut to
# keep the phase near a minute: fit_map at SED_MAP (its defaults: 8 starts,
# 150 Adam + 12 Newton steps), run(init="map") at SED_SEEDED, run_pt at
# SED_PT (defaults 300 burn + 1000 steps), run_hmc at SED_HMC (defaults 500
# + 1000 x 16 leapfrog steps), compute_evidence at SED_NESTED (defaults
# nlive 512, nbatch 32, nsteps 32) on the box SED_EVIDENCE_BOX beside
# MBBFitter.compute_evidence on K1 at the same settings and box.
SED_MAP = {"nstarts": 4, "n_adam": 50, "n_newton": 6}
SED_SEEDED = {"nburn": 50, "nsteps": 100}
SED_PT = {"nburn": 100, "nsteps": 200}
SED_HMC = {"nwarmup": 10, "nsteps": 20, "n_leapfrog": 4}
SED_NESTED = {"nlive": 64, "nbatch": 16, "nsteps": 8}
# A prior volume around config 2's posterior (T, beta, lambda0, alpha,
# fnorm): on the default box (lambda0 up to 2e4, fnorm up to 1e7) nested
# sampling at 8 constrained steps per iteration lands tens of nats low.
SED_EVIDENCE_BOX = ((15.0, 0.5, 20.0, 0.5, 20.0), (80.0, 4.5, 1500.0, 10.0,
                                                   80.0))
# The examples' models through run(50, 250) on the card and in a CPU worker.
SED_EXAMPLE_DEPTH = {"nburn": 50, "nsteps": 250}
# Production lengths of the marginal stretch-step time, and the steps of
# the call whose device busy time torch.profiler takes.
SED_TIME_STEPS = (20, 80)
SED_PROFILE_STEPS = 3


def sed_mbb_model(opthin=False, noalpha=False):
    """The 5-parameter MBB as a user SEDModel (the twin of
    tests/test_sed.py's wrapped model) on the parity tool's box."""
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import SEDModel
    from mbb_emcee_tpu_torch.models.modified_blackbody import (
        MBBShape, log_mbb_fnu)
    shape = MBBShape(opthin=opthin, noalpha=noalpha)

    def fnu(theta, wave):
        return torch.exp(log_mbb_fnu(theta, wave, shape))
    return SEDModel(fnu=fnu, param_names=vp.PARAM_NAMES, lower=vp.LOWER,
                    upper=vp.UPPER, name="mbb-wrapped")


def sed_fitter(ci, flux, unc, cov, seed, device=None):
    """An SEDFitter of the wrapped MBB at parity config `ci`, set up as
    port_fitter sets up MBBFitter (box, priors, upper-limit band, the
    shape's fixed parameters, the walker ball at the truth with
    MBBFitter's scatter)."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import ResponseSet, SEDFitter
    from mbb_emcee_tpu_torch.fitter import DEFAULT_SCATTER
    cfg = vp.CONFIGS[ci]
    fit = SEDFitter(sed_mbb_model(cfg["opthin"], cfg["noalpha"]),
                    nwalkers=NWALKERS, seed=seed, device=device or DEVICE)
    band_names = vp.BANDS if cfg["response"] else None
    fit.set_data(vp.WAVE, flux, unc, cov=cov, band_names=band_names)
    if cfg["response"]:
        fit.set_responses(ResponseSet.builtin(vp.BANDS, nnodes=65))
    fit.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    ub = cfg.get("uplim_band")
    if ub is not None:
        mask = np.zeros(flux.size, bool)
        mask[ub] = True
        fit.set_phot_upperlimits(mask)
    for (pi, mean, sig) in cfg["priors"]:
        fit.set_gaussian_prior(pi, mean, sig)
    # MBBFitter's ball: a generic model's default scatter, 5% of the box
    # center, is far too wide in lambda0 and fnorm for the MBB's box
    for i in range(5):
        fit.set_param_init(i, vp.TRUE[i], DEFAULT_SCATTER[i])
    if cfg["opthin"]:
        fit.fix_param("lambda0", vp.TRUE[2])
    if cfg["noalpha"]:
        fit.fix_param("alpha", vp.TRUE[3])
    return fit


def two_temp_model():
    """examples/two_temp_model.py's cold + warm greybody (shared beta), in
    torch."""
    import torch
    from mbb_emcee_tpu_torch import SEDModel
    from mbb_emcee_tpu_torch.models.modified_blackbody import (
        MBBShape, log_mbb_fnu)
    shape = MBBShape(opthin=True, noalpha=True)

    def fnu(theta, wave):
        t_c, t_w, beta, f_c, f_w = theta
        pin = [torch.full_like(t_c, 250.0), torch.full_like(t_c, 4.0)]
        p_c = torch.stack([t_c, beta, *pin, f_c])
        p_w = torch.stack([t_w, beta, *pin, f_w])
        return (torch.exp(log_mbb_fnu(p_c, wave, shape))
                + torch.exp(log_mbb_fnu(p_w, wave, shape)))
    return SEDModel(
        fnu=fnu,
        param_names=("T_cold", "T_warm", "beta", "fnorm_cold", "fnorm_warm"),
        lower=[5.0, 25.0, 0.5, 1e-3, 1e-4],
        upper=[25.0, 120.0, 4.0, 1e3, 1e2], name="two-temp-greybody")


def example_fitter(which, seed, device=None):
    """An SEDFitter of one of the examples' models on mock data made from
    its truth (5% errors, noise from numpy seed 3): "two-temp" at nine
    bands with tests/test_sed.py's beta prior, "cmb" (cmb_corrected_mbb(
    5.0, opthin=True, noalpha=True), examples/cmb_high_z_model.py) at five
    submm bands with T bounded to 10-60 K as the example's command line
    bounds it."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch import SEDFitter, cmb_corrected_mbb
    if which == "two-temp":
        model = two_temp_model()
        true = np.array([20.0, 45.0, 1.8, 30.0, 0.8])
        wave = np.array([60.0, 100.0, 160.0, 250.0, 350.0, 500.0, 850.0,
                         1100.0, 2000.0])
    else:
        model = cmb_corrected_mbb(5.0, opthin=True, noalpha=True,
                                  name="cmb-mbb-z5")
        true = np.array([22.0, 1.8, 100.0, 3.0, 8.0])
        wave = np.array([450.0, 850.0, 1300.0, 2000.0, 3000.0])
    f = model.fnu(torch.tensor(true, dtype=torch.float32),
                  torch.tensor(wave, dtype=torch.float32)).double().numpy()
    unc = 0.05 * f
    flux = f + unc * np.random.default_rng(3).standard_normal(f.size)
    fit = SEDFitter(model, nwalkers=NWALKERS, seed=seed,
                    device=device or DEVICE)
    fit.set_data(wave, flux, unc)
    for n, v in zip(model.param_names, true):
        fit.set_param_init(n, v, 0.1 * abs(v))
    if which == "two-temp":
        fit.set_gaussian_prior("beta", 1.8, 0.5)
    else:
        fit.fix_param("lambda0", 100.0).fix_param("alpha", 3.0)
        fit.set_lowlim("T", 10.0).set_uplim("T", 60.0)
        fit.set_uplim("beta", 4.0)
    return fit


def _cpu_example_run(which, seed):
    """The CPU's run of one of the examples' models (a reference worker):
    (chain_free (nrec, W, nfree), seconds)."""
    _cpu_worker_setup()
    fit = example_fitter(which, seed, device="cpu")
    _, t = _timed_cpu(lambda: fit.run(**SED_EXAMPLE_DEPTH))
    return fit.chain_free.numpy(), t


def _cpu_sed_map(seed):
    """The CPU's SEDFitter.fit_map at config 2 (a reference worker): (mode,
    Laplace sigma, lnp, seconds)."""
    _cpu_worker_setup()
    from tools import validate_tpu_parity as vp
    flux, unc, cov = vp.mock_data(vp.CONFIGS[2])
    fit = sed_fitter(2, flux, unc, cov, seed, device="cpu")
    r, t = _timed_cpu(lambda: fit.fit_map(**SED_MAP))
    return r.x, r.sigma, r.lnprob, t


def _cpu_sed_hmc(seed):
    """The CPU's SEDFitter.run_hmc(**SED_HMC) at config 2 (a reference
    worker): (chain_free, mean acceptance, seconds)."""
    _cpu_worker_setup()
    from tools import validate_tpu_parity as vp
    flux, unc, cov = vp.mock_data(vp.CONFIGS[2])
    fit = sed_fitter(2, flux, unc, cov, seed, device="cpu")
    _, t = _timed_cpu(lambda: fit.run_hmc(**SED_HMC))
    return fit.chain_free.numpy(), float(fit.acceptance_fraction.mean()), t


def _medians_vs(tag, a, b, names):
    """Medians of two (nrec, W, nfree) host chains within 3 sigma_MC of
    their difference (each side's from its autocorrelation time)."""
    import numpy as np
    free = list(range(a.shape[-1]))
    (ma, sa), (mb, sb) = [
        (np.median(c.reshape(-1, c.shape[-1]), axis=0),
         tau_se(c, c.reshape(-1, c.shape[-1]), free)[0]) for c in (a, b)]
    tol = 3 * np.hypot(sa, sb)
    ok = bool(np.all(np.abs(ma - mb) <= tol))
    log(f"[24] {tag}: " + ", ".join(
        f"{n} {x:.5g} vs {y:.5g} (tol {t:.3g})"
        for n, x, y, t in zip(names, ma, mb, tol))
        + f" {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: medians differ")


def _sed_vs_k1(tag, ci, n, pack=None):
    """build_sed_lnprob on the wrapped MBB against K1 on the same `n`
    vectors (about 10% out of the box) at config `ci`, K1's tolerance,
    floors identical. Returns the max abs difference."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.likelihood import LNPROB_FLOOR
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        mbb_lnprob, prepare_lnprob_inputs)
    from mbb_emcee_tpu_torch.sed import build_sed_lnprob
    phot, shape, spec = problem(ci)
    ops = prepare_lnprob_inputs(phot, shape, spec, pack, device=DEVICE)
    sed_lnp, fs = build_sed_lnprob(
        phot, sed_mbb_model(shape.opthin, shape.noalpha), spec,
        response_pack=pack, device=DEVICE)
    th, _ = thetas(fs, n=n)
    x = torch.as_tensor(th, device=DEVICE)
    got = sed_lnp(x).double().cpu().numpy()
    want = mbb_lnprob(x, ops).double().cpu().numpy()
    floor_g, floor_w = got <= LNPROB_FLOOR / 2, want <= LNPROB_FLOOR / 2
    m = ~floor_w
    dabs = np.abs(got[m] - want[m])
    ok = (np.array_equal(floor_g, floor_w)
          and np.all(dabs <= K1_ATOL + K1_RTOL * np.abs(want[m])))
    log(f"[24] (a) {tag}: build_sed_lnprob against K1 on {n} vectors "
        f"({int((~m).sum())} floored in both): max |d| {dabs.max():.3g}, "
        f"max rel {(dabs / np.abs(want[m])).max():.3g} (rtol {K1_RTOL:g}, "
        f"atol {K1_ATOL:g}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"build_sed_lnprob disagrees with K1 ({tag})")
    return float(dabs.max())


def phase_generic(card):
    """The generic-model tier through the user's entry points (see the
    module docstring, phase 24). Returns (launches by kernel and path,
    seconds and numbers by step)."""
    import concurrent.futures
    import multiprocessing
    import warnings
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBResults, modelcheck, derived
    from mbb_emcee_tpu_torch.sed import SEDResults

    t0 = time.time()
    out = {}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}
    cfg = vp.CONFIGS[2]
    free = vp.free_indices(cfg)
    flux, unc, cov = vp.mock_data(cfg)

    def lap(part):
        out[f"{part} ends at s"] = time.time() - t0

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_runs = {w: pool.submit(_cpu_example_run, w, 2410 + i)
                    for i, w in enumerate(("two-temp", "cmb"))}
        cpu_map = pool.submit(_cpu_sed_map, 2420)
        cpu_hmc = pool.submit(_cpu_sed_hmc, 2422)

        # -- (a) the SED lnprob against K1
        _, pack = port_response_pack()
        out["(a) max |d|"] = max(
            _sed_vs_k1(f"config 2, point, {n}", 2, n) for n in (250, 4096))
        out["(a) max |d| response"] = max(
            _sed_vs_k1(f"config 3, 5 x 65, {n}", 3, n, pack)
            for n in (250, 4096))
        lap("(a)")

        # -- (b) SEDFitter.run(200, 1000) against MBBFitter.run on K2
        ref = port_fitter(2, flux, unc, cov, seed=2401)
        _counts(reset=True)
        _, out["K2 run(200, 1000)"] = _timed(lambda: ref.run(nburn=200,
                                                             nsteps=1000))
        launches["mbb_stretch_run"]["posterior yardstick (phase 24)"] = \
            _counts()["mbb_stretch_run"]
        fit = sed_fitter(2, flux, unc, cov, seed=2402)
        _counts(reset=True)
        _, t_run = _timed(lambda: fit.run(nburn=200, nsteps=1000))
        c = _counts()
        kernels = (c["mbb_lnprob"] + c["mbb_stretch_run"]
                   + c["mbb_multi_stretch_run"])
        ok = kernels == 0 and c["plain_sampler_runs"] == 3
        log(f"[24] (b) SEDFitter(mbb-wrapped).run(200, 1000), config 2 x "
            f"{NWALKERS}: {t_run:.2f} s (host clock), acceptance "
            f"{fit.acceptance_fraction.mean():.3f}; {kernels} kernel "
            f"launches, {c['plain_sampler_runs']} plain sampler runs (want "
            f"0 and 3: the generic tier runs no TPU-kernel port) "
            f"{'PASS' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError("SEDFitter.run did not run the plain "
                                 "sampler alone")
        out["SEDFitter.run(200, 1000)"] = t_run
        _posterior_vs("SEDFitter.run(200, 1000)", fit, ref, 0.02, free,
                      phase=24)
        whole = sed_fitter(2, flux, unc, cov, seed=2403).run(nburn=10,
                                                             nsteps=30)
        part = sed_fitter(2, flux, unc, cov, seed=2403).run(nburn=10,
                                                            nsteps=20)
        part.extend(10)
        ok = (torch.equal(whole.chain_free, part.chain_free)
              and torch.equal(whole.lnprobability, part.lnprobability))
        log(f"[24] (b) run(10, 20) + extend(10) against run(10, 30): chains "
            f"{'bitwise equal PASS' if ok else 'DIFFERENT FAIL'}")
        lap("(b)")
        if not ok:
            raise AssertionError("SEDFitter.extend is not the longer run")

        # -- (c) derived posteriors on a chain shared with MBBResults
        sres = fit.results(redshift=2.2)
        mres = MBBResults(fit=ref, redshift=2.2)
        mres.chain = sres.chain
        n_samp = sres.flatchain.shape[0]
        lir_s, out["SEDResults.compute_lir"] = _timed(sres.compute_lir)
        lir_m, _ = _timed(mres.compute_lir)
        pk_s, out["SEDResults.compute_peaklambda"] = _timed(
            sres.compute_peaklambda)
        pk_m, _ = _timed(mres.compute_peaklambda)
        d_lir = float(np.max(np.abs(lir_s / lir_m - 1.0)))
        d_pk = float(np.max(np.abs(pk_s / pk_m - 1.0)))
        ok = d_lir <= 1e-4 and d_pk <= 2e-3
        log(f"[24] (c) {n_samp} samples of the SED chain through "
            f"SEDResults and MBBResults: L_IR max rel {d_lir:.3g} (rtol "
            f"1e-4), lambda_peak max rel {d_pk:.3g} (rtol 2e-3); SEDResults "
            f"{out['SEDResults.compute_lir']:.2f} s / "
            f"{out['SEDResults.compute_peaklambda']:.2f} s (host clock) "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("generic derived posteriors are not "
                                 "MBBResults'")
        zfit = _zparam_fitter(DEVICE)
        _, t_z = _timed(lambda: zfit.run(nburn=20, nsteps=40))
        zres = zfit.results()
        lz_card, _ = _timed(lambda: zres.compute_lir(z_param="z"))
        lz_cpu = SEDResults(fit=zfit, device="cpu").compute_lir(
            z_param="z")
        d_z = float(np.max(np.abs(lz_card / lz_cpu - 1.0)))
        ok = d_z <= 1e-4 and np.all(np.isfinite(lz_card))
        log(f"[24] (c) compute_lir(z_param='z') of a sampled-redshift model "
            f"({lz_card.size} samples of run(20, 40), {t_z:.2f} s): card "
            f"against CPU max rel {d_z:.3g} (rtol 1e-4), L_IR median "
            f"{np.median(lz_card):.4g} L_sun {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("z_param L_IR on the card is not the CPU's")
        lap("(c)")

        # -- (d) the examples' models, card against the CPU
        for i, which in enumerate(("two-temp", "cmb")):
            ex = example_fitter(which, 2410 + i)
            _, t_ex = _timed(lambda: ex.run(**SED_EXAMPLE_DEPTH))
            chain_cpu, t_cpu = cpu_runs[which].result()
            names = [ex.model.param_names[j] for j in ex.free_space.free_idx]
            _medians_vs(f"(d) {ex.model.name} run(50, 250): card "
                        f"({t_ex:.2f} s) against CPU ({t_cpu:.1f} s), "
                        "within 3 sigma_MC", ex.chain_free.cpu().numpy(),
                        chain_cpu, names)
            out[f"{which} run(50, 250)"] = t_ex
        lap("(d)")

        # -- (e) the tiers through SEDFitter
        tfit = sed_fitter(2, flux, unc, cov, seed=2420)
        r, out["fit_map"] = _timed(lambda: tfit.fit_map(**SED_MAP))
        x_c, s_c, lnp_c, t_mc = cpu_map.result()
        dx = np.abs(r.x - x_c) / s_c
        ok = bool(np.all(dx < 1e-2)) and abs(r.lnprob - lnp_c) < 1e-2
        log(f"[24] (e) fit_map({SED_MAP}) on the card "
            f"({out['fit_map']:.2f} s) against "
            f"the CPU's ({t_mc:.1f} s): |d mode| <= {dx.max():.3g} Laplace "
            f"sigma (1e-2), lnp {r.lnprob:.4f} vs {lnp_c:.4f} "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("SED fit_map on the card is not the CPU's")
        (_, _, ess), out["map_importance"] = _timed(tfit.map_importance)
        _, t_seeded = _timed(lambda: tfit.run(init="map", **SED_SEEDED))
        out["run(init='map')"] = t_seeded
        log(f"[24] (e) map_importance(2048): ESS {ess:.0f}; "
            f"run(init='map', {SED_SEEDED}) {t_seeded:.2f} s")
        _posterior_vs(f"run(init='map', {SED_SEEDED})", tfit, ref, 0.02,
                      free, phase=24)
        res = tfit.results()
        ppc, out["posterior_predictive"] = _timed(res.posterior_predictive)
        loo, out["compute_loo"] = _timed(res.compute_loo)
        samples = res._samples(1)
        mbb_flux = derived.band_flux_eval(
            vp_shape(2), vp.WAVE)(samples)
        r_mbb = (mbb_flux - torch.as_tensor(
            flux, dtype=torch.float32, device=DEVICE)) / torch.as_tensor(
            unc, dtype=torch.float32, device=DEVICE)
        chi2_mbb = torch.sum(r_mbb * r_mbb, dim=-1).double().cpu().numpy()
        want_loo = modelcheck.loo_from_loglik(
            modelcheck.pointwise_loglik_matrix(
                derived.band_flux_eval(vp_shape(2), vp.WAVE), samples, flux,
                np.arange(5), unc_det=unc))
        d_chi = float(np.max(np.abs(ppc.chi2_obs - chi2_mbb)
                             / (1.0 + chi2_mbb)))
        d_loo = abs(loo.elpd_loo - want_loo.elpd_loo)
        ok = (d_chi < 1e-4 and d_loo < 1e-3 * abs(want_loo.elpd_loo)
              and 0.0 < ppc.p_value < 1.0)
        log(f"[24] (e) posterior_predictive ({out['posterior_predictive']:.2f}"
            f" s) p {ppc.p_value:.3f}, chi2_obs against the MBB band "
            f"fluxes' max rel {d_chi:.3g}; compute_loo "
            f"({out['compute_loo']:.2f} s) elpd {loo.elpd_loo:.3f} against "
            f"{want_loo.elpd_loo:.3f} {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("SED PPC / LOO are not the MBB model's")
        pfit = sed_fitter(2, flux, unc, cov, seed=2421)
        _, out["run_pt"] = _timed(lambda: pfit.run_pt(**SED_PT))
        log(f"[24] (e) run_pt({SED_PT}): {pfit.pt_result.betas.size} rungs, "
            f"{out['run_pt']:.2f} s, stepping-stone lnZ "
            f"{pfit.logz_pt[0]:.3f} +- {pfit.logz_pt[1]:.3f}")
        _posterior_vs(f"run_pt({SED_PT}) cold chain", pfit, ref, 0.02, free,
                      phase=24)
        hfit = sed_fitter(2, flux, unc, cov, seed=2422)
        _, out["run_hmc"] = _timed(lambda: hfit.run_hmc(**SED_HMC))
        grads = 1 + (SED_HMC["nwarmup"] + SED_HMC["nsteps"]) \
            * SED_HMC["n_leapfrog"]
        chain_cpu, acc_cpu, t_hc = cpu_hmc.result()
        log(f"[24] (e) run_hmc({SED_HMC}): {out['run_hmc']:.2f} s, "
            f"{1e3 * out['run_hmc'] / grads:.1f} ms per gradient, acceptance "
            f"{hfit.acceptance_fraction.mean():.3f} (CPU {acc_cpu:.3f}, "
            f"{t_hc:.1f} s)")
        _medians_vs(f"(e) run_hmc({SED_HMC}) on the card against the CPU's "
                    "same call (a depth too short to converge: held to the "
                    "CPU, not to K2), within 3 sigma_MC",
                    hfit.chain_free.cpu().numpy(), chain_cpu,
                    list(vp.PARAM_NAMES))
        efit = sed_fitter(2, flux, unc, cov, seed=2423)
        kfit = port_fitter(2, flux, unc, cov, seed=2423)
        for f in (efit, kfit):
            for i in range(5):
                f.set_lowlim(i, SED_EVIDENCE_BOX[0][i])
                f.set_uplim(i, SED_EVIDENCE_BOX[1][i])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            ev, out["compute_evidence"] = _timed(
                lambda: efit.compute_evidence(**SED_NESTED))
            _counts(reset=True)
            evk, out["K1 compute_evidence"] = _timed(
                lambda: kfit.compute_evidence(**SED_NESTED))
        nk = _counts()["mbb_lnprob"]
        launches["mbb_lnprob"]["compute_evidence, yardstick (phase 24)"] = nk
        tol = 3 * np.hypot(ev.logz_err, evk.logz_err)
        ok = (abs(ev.logz - evk.logz) <= tol and nk == 1 + evk.n_iter
              * SED_NESTED["nsteps"])
        log(f"[24] (e) compute_evidence({SED_NESTED}) on SED_EVIDENCE_BOX: "
            f"SED lnZ "
            f"{ev.logz:.4f} +- {ev.logz_err:.4f} ({ev.n_iter} iterations, "
            f"{out['compute_evidence']:.2f} s) against MBBFitter on K1 "
            f"{evk.logz:.4f} +- {evk.logz_err:.4f} ({evk.n_iter} iterations, "
            f"{nk} K1 launches, {out['K1 compute_evidence']:.2f} s): |d| "
            f"{abs(ev.logz - evk.logz):.4f} <= 3 x combined {tol:.4f} "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("SED evidence is not K1's")
        lap("(e)")

        # -- (f) the stretch step's time, kernels and busy share
        sfit = sed_fitter(2, flux, unc, cov, seed=2430)
        sfit.run(nburn=0, nsteps=SED_TIME_STEPS[0])
        ts = [_timed(lambda: sfit.run(nburn=0, nsteps=n))[1]
              for n in SED_TIME_STEPS]
        ms_step = 1e3 * (ts[1] - ts[0]) / (SED_TIME_STEPS[1]
                                          - SED_TIME_STEPS[0])
        # kernels per step: the difference of two traced runs, so the
        # start's likelihood call drops out
        t_prof = time.time()
        (k1, h1), (k2, h2) = (_profiled_launches(
            lambda: sfit.run(nburn=0, nsteps=n)) for n in (1, 2))
        kernels, host = k2 - k1, h2 - h1
        _, busy = _profiled_busy_ms(
            lambda: sfit.run(nburn=0, nsteps=SED_PROFILE_STEPS))
        t_prof = time.time() - t_prof
        _, wall = _timed(lambda: sfit.run(nburn=0,
                                          nsteps=SED_PROFILE_STEPS))
        kref = port_fitter(2, flux, unc, cov, seed=2430)
        kref.run(nburn=0, nsteps=200)
        tk = [_timed(lambda: kref.run(nburn=0, nsteps=n))[1]
              for n in (1000, 3000)]
        k2_ms = 1e3 * (tk[1] - tk[0]) / 2000
        share = None if busy is None else busy / (1e3 * wall)
        log(f"[24] (f) SEDFitter stretch step, config 2 x {NWALKERS}: "
            f"{ms_step:.3f} ms per step (marginal, run(0, "
            f"{SED_TIME_STEPS[1]}) - run(0, {SED_TIME_STEPS[0]}), host clock"
            f" with the card synchronized); {kernels:.0f} device kernels and "
            f"{host:.0f} cudaLaunchKernel calls per step (torch.profiler, "
            f"run(0, 2) - run(0, 1)); device busy "
            f"{'not measured' if busy is None else f'{busy:.1f} ms'} of "
            f"{1e3 * wall:.1f} ms for run(0, {SED_PROFILE_STEPS})"
            f"{'' if share is None else f' ({100 * share:.1f}%)'}; the "
            f"traced runs took {t_prof:.1f} s; K2 on the same posterior "
            f"{1e3 * k2_ms:.2f} us per step (marginal, run(0, 3000) - "
            f"run(0, 1000)): {ms_step / k2_ms:.0f}x ({card})")
        out.update({"ms per stretch step": ms_step,
                    "kernels per step": kernels,
                    "launch calls per step": host,
                    "device busy ms": busy, "profiled wall s": wall,
                    "device busy share": share, "traced runs s": t_prof,
                    "K2 us per step": 1e3 * k2_ms})
        lap("(f)")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    out["phase 24"] = time.time() - t0
    log(f"[24] phase 24: {out['phase 24']:.1f} s; parts end at " + ", ".join(
        f"{k.split()[0]} {v:.1f} s" for k, v in out.items()
        if k.endswith("ends at s")))
    return launches, out


def vp_shape(ci):
    """The MBBShape of parity config `ci`."""
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.models.modified_blackbody import MBBShape
    cfg = vp.CONFIGS[ci]
    return MBBShape(opthin=cfg["opthin"], noalpha=cfg["noalpha"])


def _zparam_fitter(device):
    """An SEDFitter of a thin greybody with a SAMPLED redshift (T rest
    frame, T / (1 + z) observed) on mock data at six submm bands, with a T
    prior (tests/test_torch_sed.py's model)."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch import SEDFitter, SEDModel
    from mbb_emcee_tpu_torch.models.modified_blackbody import (
        MBBShape, log_mbb_fnu)
    shape = MBBShape(opthin=True, noalpha=True)

    def fnu(th, w):
        t_obs = th[0] / (1.0 + th[3])
        p = torch.stack([t_obs, th[1], torch.full_like(t_obs, 250.0),
                         torch.full_like(t_obs, 3.5), th[2]])
        return torch.exp(log_mbb_fnu(p, w, shape))
    model = SEDModel(fnu=fnu, param_names=("T", "beta", "fnorm", "z"),
                     lower=[5.0, 0.5, 1.0, 0.5], upper=[150.0, 4.0, 500.0,
                                                        6.0],
                     name="photoz-greybody")
    true = np.array([38.0, 1.9, 10.0, 3.0])
    wave = np.array([250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0])
    f = model.fnu(torch.tensor(true, dtype=torch.float32),
                  torch.tensor(wave, dtype=torch.float32)).double().numpy()
    fit = SEDFitter(model, nwalkers=NWALKERS, seed=2404, device=device)
    fit.set_data(wave, f, 0.07 * f)
    fit.set_gaussian_prior("T", 38.0, 6.0)
    for n, v in zip(model.param_names, true):
        fit.set_param_init(n, v, 0.05 * v)
    return fit


# Phase 25: the generic batch tier and submm photo-z. (a) photoz_mbb's fnu
# on PZ_VECTORS rows per variant; (b) tests/test_photoz.py:352's photo-z
# fit (T prior; beta, lambda0, alpha fixed) at NWALKERS walkers, cut from
# that test's run(250, 1200, thin=2) at 64 walkers to PZ_FIT (PERF.md
# section 4), held against the exact (T, fnorm, z) grid marginal of
# PZ_GRID points; (c) SEDMultiFitter at the batch cell's width through
# SEDMULTI_DEPTH against MultiFitter's on K3, and extend bitwise at
# SEDMULTI_EXTEND_SOURCES sources; (d) the derived posteriors on one chain
# thinned by SEDMULTI_DERIVED_THIN, and compute_dustmass_batch of a
# PZ_BATCH_SOURCES-source photo-z batch; (e) the batch stretch step's time
# from two production lengths SEDMULTI_TIME_STEPS, and K3's from
# K3_TIME_STEPS on the same posterior.
PZ_VECTORS = 4096
PZ_FIT = {"nburn": 100, "nsteps": 300}
PZ_GRID = (96, 96, 144)
SEDMULTI_DEPTH = {"nburn": 50, "nsteps": 250}
SEDMULTI_EXTEND_SOURCES = 16
SEDMULTI_DERIVED_THIN = 25
PZ_BATCH_SOURCES = 16
PZ_BATCH_DEPTH = {"nburn": 20, "nsteps": 40}
SEDMULTI_TIME_STEPS = (10, 30)
K3_TIME_STEPS = (200, 1000)
PZ_WAVE = (250.0, 350.0, 500.0, 850.0, 1100.0, 2000.0)


def _pz_thetas(n, seed):
    """n photo-z parameter rows in the default box's populated part, z in
    [0, 12] with 8 rows at each bound and just inside them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    th = np.column_stack([
        rng.uniform(15.0, 60.0, n), rng.uniform(1.0, 2.5, n),
        rng.uniform(50.0, 300.0, n), rng.uniform(1.0, 5.0, n),
        rng.uniform(1.0, 50.0, n), rng.uniform(0.0, 12.0, n)])
    th[:8, 5], th[8:16, 5] = 0.0, 12.0
    th[16:24, 5], th[24:32, 5] = 1e-3, 11.99
    return th.astype(np.float32)


def _pz_fnu_vs_cpu():
    """(a) photoz_mbb's fnu, every variant, on PZ_VECTORS rows on the card
    against the same call on the CPU, and each of the two fp32 results
    against an independent witness: the same formulas on the CPU in fp64 on
    the same (fp32) inputs. Each |d ln f| is held to 1e-5, plus 8 ulp of
    the Planck argument x = hc / (lambda k T_dust) at the band and at the
    normalization point (on the Wien side ln(e^x - 1) ~ x, so an fp32
    evaluation carries a few ulp of x: up to ~60 at z = 12), plus the CMB
    visibility's conditioning near T_dust ~ T_CMB(z), 2e-6 (e^-vis - 1) at
    the band and at the normalization point (tests/test_torch_photoz.py's
    rule). Returns the largest |d ln f| of card - CPU, card - fp64 and
    CPU - fp64, and the largest of each over its bound."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.constants import HCOK_UM_K
    from mbb_emcee_tpu_torch.models.cmb import (
        dust_temperature_with_cmb, log_cmb_visibility)
    from mbb_emcee_tpu_torch.photoz import photoz_mbb
    from mbb_emcee_tpu_torch.sed import batched_fnu
    EPS32 = float(np.finfo(np.float32).eps)
    th = _pz_thetas(PZ_VECTORS, 25)
    wave = np.asarray(PZ_WAVE, np.float32)
    th64, wave64 = (torch.as_tensor(a).double() for a in (th, wave))
    pairs = ("card - CPU", "card - fp64", "CPU - fp64")
    worst = {k: 0.0 for k in pairs}
    worst.update({f"{k} / tol": 0.0 for k in pairs})
    for cmb in (False, True):
        for opthin in (False, True):
            for noalpha in (False, True):
                m = photoz_mbb(cmb=cmb, opthin=opthin, noalpha=noalpha)
                card, cpu = (batched_fnu(m.fnu)(
                    torch.as_tensor(th, device=dev),
                    torch.as_tensor(wave, device=dev)).double().cpu().numpy()
                    for dev in (DEVICE, "cpu"))
                exact = batched_fnu(m.fnu)(th64, wave64).numpy()
                z = th64[:, 5]
                t_d = (dust_temperature_with_cmb(th64[:, 0], th64[:, 1], z)
                       if cmb else th64[:, 0])
                opz_t = (1.0 + z.numpy())[:, None]
                t_dd = t_d.numpy()[:, None]
                x_b = HCOK_UM_K * opz_t / (wave64.numpy()[None, :] * t_dd)
                x_n = HCOK_UM_K * opz_t / (500.0 * t_dd)
                tol = 1e-5 + 8 * EPS32 * (x_b + x_n)
                if cmb:
                    vis = log_cmb_visibility(
                        wave64[None] / (1.0 + z[:, None]), t_d[:, None],
                        z[:, None]).numpy()
                    vis_n = log_cmb_visibility(500.0 / (1.0 + z), t_d,
                                               z).numpy()
                    tol += 2e-6 * (np.expm1(-vis) + np.expm1(-vis_n)[:, None])
                ok = all(np.all(np.isfinite(f)) for f in (card, cpu, exact))
                parts = []
                for k, (f, g) in zip(pairs, ((card, cpu), (card, exact),
                                             (cpu, exact))):
                    d = np.abs(np.log(f) - np.log(g))
                    ok = ok and bool(np.all(d <= tol))
                    worst[k] = max(worst[k], float(d.max()))
                    worst[f"{k} / tol"] = max(worst[f"{k} / tol"],
                                              float(np.max(d / tol)))
                    parts.append(f"{k} max |d ln f| {d.max():.3g} "
                                 f"(/ tol {np.max(d / tol):.3f})")
                log(f"[25] (a) {m.name} opthin={opthin} noalpha={noalpha}: "
                    f"{PZ_VECTORS} x {wave.size} fluxes, the card's fp32, "
                    f"the CPU's fp32 and the CPU's fp64: " + ", ".join(parts)
                    + f" (tol 1e-5 + 8 ulp of x + the visibility's "
                    f"conditioning) {'PASS' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("photo-z fnu on the card is not the "
                                         "CPU's or not within fp32 of fp64")
    return worst


def _pz_fit_vs_grid(out):
    """(b) The photo-z fit of tests/test_photoz.py:352 on the card at
    PZ_FIT against the exact (T, fnorm, z) grid marginal of P(z), the grid
    evaluated on the card in one batched call."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch import SEDFitter
    from mbb_emcee_tpu_torch.photoz import photoz_mbb
    model = photoz_mbb(cmb=True, opthin=True, noalpha=True, z_upper=8.0)
    truth = np.array([38.0, 1.9, 250.0, 4.0, 10.0, 4.0])
    wave = np.asarray(PZ_WAVE)
    f = model.fnu(torch.tensor(truth, dtype=torch.float32),
                  torch.tensor(wave, dtype=torch.float32)).double().numpy()
    unc = 0.07 * f
    flux = f + unc * np.random.default_rng(21).standard_normal(wave.size)
    fit = SEDFitter(model, nwalkers=NWALKERS, seed=13, device=DEVICE)
    fit.set_data(wave, flux, unc)
    fit.set_gaussian_prior("T", 38.0, 6.0)
    fit.fix_param("beta", 1.9).fix_param("lambda0", 250.0)
    fit.fix_param("alpha", 4.0)
    for nm, v in zip(model.param_names, truth):
        fit.set_param_init(nm, v, 0.1 * abs(v))
    _counts(reset=True)
    _, out["(b) photo-z run"] = _timed(lambda: fit.run(**PZ_FIT))
    c = _counts()
    zc = fit.results().par_cen("z")

    def grid():
        tg = np.linspace(10.0, 80.0, PZ_GRID[0])
        fg = np.linspace(5.0, 18.0, PZ_GRID[1])
        zg = np.linspace(0.8, 8.0, PZ_GRID[2])
        tt, ff, zz = np.meshgrid(tg, fg, zg, indexing="ij")
        pts = np.column_stack([
            tt.ravel(), np.full(tt.size, 1.9), np.full(tt.size, 250.0),
            np.full(tt.size, 4.0), ff.ravel(), zz.ravel()])
        x = torch.as_tensor(pts.astype(np.float32), device=DEVICE)
        w, y, iu = (torch.as_tensor(a.astype(np.float32), device=DEVICE)
                    for a in (wave, flux, 1.0 / unc))
        r = (torch.func.vmap(model.fnu, in_dims=(0, None))(x, w) - y) * iu
        lnp = -0.5 * torch.sum(r * r, dim=-1) \
            - 0.5 * ((x[:, 0] - 38.0) / 6.0) ** 2
        return lnp.double().cpu().numpy().reshape(tt.shape), zg

    (vals, zg), out["(b) grid"] = _timed(grid)
    post = np.exp(vals - vals.max())
    pz = post.sum(axis=(0, 1))
    cdf = np.cumsum(pz) / pz.sum()
    zmed, zlo, zhi = (np.interp(q, cdf, zg) for q in (0.5, 0.1585, 0.8415))
    width_g, width_m = zhi - zlo, zc[1] + zc[2]
    contained = pz[0] < 1e-2 * pz.max() and pz[-1] < 1e-2 * pz.max()
    ok = (contained and abs(zc[0] - zmed) < 0.08 * width_g
          and abs(width_m - width_g) < 0.12 * width_g
          and c["mbb_lnprob"] + c["mbb_multi_stretch_run"] == 0)
    log(f"[25] (b) photo-z SEDFitter.run({PZ_FIT}) x {NWALKERS} walkers, "
        f"cmb=True, T prior (38, 6), beta/lambda0/alpha fixed: "
        f"{out['(b) photo-z run']:.2f} s, {c['plain_sampler_runs']} plain "
        f"sampler runs; z median {zc[0]:.4f}, 68% width {width_m:.4f} "
        f"against the {'x'.join(map(str, PZ_GRID))} grid's "
        f"{zmed:.4f} / {width_g:.4f} ({out['(b) grid']:.2f} s, one batched "
        f"call on the card): |d median| {abs(zc[0] - zmed):.4f} < "
        f"{0.08 * width_g:.4f}, |d width| {abs(width_m - width_g):.4f} < "
        f"{0.12 * width_g:.4f} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("photo-z P(z) is off the exact grid marginal")


def sedmulti_fitter(flux, unc, seed, device=None):
    """An SEDMultiFitter of the wrapped 5-parameter MBB on the batch cell's
    data, set up as batch_fitter sets up MultiFitter (config 2's box and
    priors), with both fitters' walker balls at the truth with MBBFitter's
    scatter."""
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import SEDMultiFitter
    from mbb_emcee_tpu_torch.fitter import DEFAULT_SCATTER
    smf = SEDMultiFitter(sed_mbb_model(), nwalkers=NWALKERS, seed=seed,
                         device=device or DEVICE)
    smf.set_data(vp.WAVE, flux, unc)
    smf.set_uplim("T", vp.UPPER[0]).set_uplim("beta", vp.UPPER[1])
    for (pi, mean, sig) in vp.CONFIGS[2]["priors"]:
        smf.set_gaussian_prior(pi, mean, sig)
    for i in range(5):
        smf.set_param_init(i, vp.TRUE[i], DEFAULT_SCATTER[i])
    return smf


def _batch_posterior_vs(tag, a, b, rel):
    """Per-source medians and 68% widths of batch fit `a` against `b`, each
    within max(rel, 3 sigma_MC) (sigma_MC of both runs from their batched
    autocorrelation times). Returns the number of (source, parameter)
    checks."""
    import numpy as np
    from mbb_emcee_tpu_torch.likelihood import param_index
    stats = []
    for f in (a, b):
        tau = np.maximum(np.nan_to_num(f.autocorrelation_time(), nan=1.0),
                         1.0)                             # (S, nfree)
        n = f.chain_free.shape[1] * f.chain_free.shape[2]
        std = f.chain_free.double().reshape(
            f.nsources, n, -1).std(dim=1).cpu().numpy()
        se = std / np.sqrt(n / tau)
        cen = np.stack([f.par_cen(p) for p in f.free_param_names], axis=1)
        stats.append((cen[..., 0], cen[..., 1] + cen[..., 2],
                      1.2533 * se, 1.54 * se))
    (m1, w1, s1m, s1w), (m2, w2, s2m, s2w) = stats
    tm = np.maximum(rel * np.abs(m2), 3 * np.hypot(s1m, s2m))
    tw = np.maximum(rel * w2, 3 * np.hypot(s1w, s2w))
    bad_m, bad_w = np.abs(m1 - m2) > tm, np.abs(w1 - w2) > tw
    ok = not (bad_m.any() or bad_w.any())
    names = [f"p{param_index(p)}" for p in b.free_param_names]
    worst = [f"{n} median max |d|/tol {np.max(np.abs(m1 - m2)[:, k] / tm[:, k]):.3f}"
             f", width {np.max(np.abs(w1 - w2)[:, k] / tw[:, k]):.3f}"
             for k, n in enumerate(names)]
    log(f"[25] {tag}: {m1.shape[0]} sources x {m1.shape[1]} parameters, "
        f"max(2%, 3 sigma_MC): " + "; ".join(worst)
        + f"; {int(bad_m.sum() + bad_w.sum())} outside "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: posteriors differ")
    return bad_m.size


def phase_generic_batch(card):
    """The generic batch tier and photo-z through the user's entry points
    (see the module docstring, phase 25). Returns (launches by kernel and
    path, seconds and numbers by step)."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.photoz import (
        compute_dustmass_batch, photoz_mbb)
    from mbb_emcee_tpu_torch import SEDMultiFitter

    t0 = time.time()
    out = {}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}

    def lap(part):
        out[f"{part} ends at s"] = time.time() - t0

    # -- (a) photo-z fnu, card against CPU
    out.update({f"(a) max |d ln f| {k}": v
                for k, v in _pz_fnu_vs_cpu().items()})
    lap("(a)")

    # -- (b) the photo-z fit against the exact grid
    _pz_fit_vs_grid(out)
    lap("(b)")

    # -- (c) SEDMultiFitter against MultiFitter on K3 at the batch cell
    flux, unc = batch_data(NSOURCES, seed=2500, missing_every=16)
    ref = batch_fitter(flux, unc, seed=2501)
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.fitter import DEFAULT_SCATTER
    for i in range(5):
        ref.set_param_init(i, vp.TRUE[i], DEFAULT_SCATTER[i])
    _counts(reset=True)
    _, out["K3 MultiFitter.run"] = _timed(lambda: ref.run(**SEDMULTI_DEPTH))
    nk3 = _counts()["mbb_multi_stretch_run"]
    launches["mbb_multi_stretch_run"]["posterior yardstick (phase 25)"] = nk3
    if ref._backend_used != "fused" or nk3 != 3:
        raise AssertionError("the yardstick did not run on K3")
    # the same seed: the same walker balls and per-source Philox streams as
    # K3's run, so a source parts from K3's chain only where K3's lnprob
    # and the vmapped model round differently across an accept threshold
    # (phase 8); a parted source is held at the same bound
    smf = sedmulti_fitter(flux, unc, seed=2501)
    _counts(reset=True)
    _, t_run = _timed(lambda: smf.run(**SEDMULTI_DEPTH))
    c = _counts()
    kernels = c["mbb_lnprob"] + c["mbb_stretch_run"] \
        + c["mbb_multi_stretch_run"]
    ok = (kernels == 0 and c["plain_multi_runs"] == 3
          and c["plain_sampler_runs"] == 0)
    out["SEDMultiFitter.run"] = t_run
    log(f"[25] (c) SEDMultiFitter(mbb-wrapped).run({SEDMULTI_DEPTH}), "
        f"{NSOURCES} sources x {NWALKERS} walkers x 5 bands (band 0 missing "
        f"in {len(range(1, NSOURCES, 16))}): {t_run:.2f} s (host clock), "
        f"acceptance {smf.acceptance_fraction.mean():.3f}; "
        f"{c['mbb_lnprob']} K1 and {c['mbb_multi_stretch_run']} K3 launches"
        f", {c['plain_multi_runs']} plain multi runs (want 0, 0 and 3); "
        f"K3's MultiFitter.run on the same data "
        f"{out['K3 MultiFitter.run']:.2f} s {'PASS' if ok else 'FAIL'} "
        f"({card})")
    if not ok:
        raise AssertionError("SEDMultiFitter.run did not run the plain "
                             "multi run alone")
    parted = int((smf.chain_free != ref.chain_free).flatten(1).any(
        dim=1).sum())
    out["(c) sources parted from K3"] = parted
    out["(c) checks"] = _batch_posterior_vs(
        f"(c) SEDMultiFitter.run against K3's MultiFitter.run ({parted} of "
        f"{NSOURCES} sources' chains parted from K3's)", smf, ref, 0.02)
    ns = SEDMULTI_EXTEND_SOURCES
    whole = sedmulti_fitter(flux[:ns], unc[:ns], seed=2503).run(nburn=5,
                                                                nsteps=20)
    part = sedmulti_fitter(flux[:ns], unc[:ns], seed=2503).run(nburn=5,
                                                               nsteps=10)
    part.extend(10)
    ok = (torch.equal(whole.chain_free, part.chain_free)
          and torch.equal(whole.lnprobability, part.lnprobability))
    log(f"[25] (c) {ns} sources: run(5, 10) + extend(10) against run(5, 20)"
        f": chains {'bitwise equal PASS' if ok else 'DIFFERENT FAIL'}")
    if not ok:
        raise AssertionError("SEDMultiFitter.extend is not the longer run")
    lap("(c)")

    # -- (d) derived posteriors on one chain, and the photo-z dust mass
    thin = SEDMULTI_DERIVED_THIN
    z = np.random.default_rng(5).uniform(0.5, 4.0, NSOURCES)
    ref.chain_free = smf.chain_free
    lir_s, out["(d) SED compute_lir"] = _timed(
        lambda: smf.compute_lir(redshifts=z, thin=thin))
    lir_m, out["(d) MBB compute_lir"] = _timed(
        lambda: ref.compute_lir(redshifts=z, thin=thin))
    pk_s, out["(d) SED compute_peaklambda"] = _timed(
        lambda: smf.compute_peaklambda(thin=thin))
    pk_m, out["(d) MBB compute_peaklambda"] = _timed(
        lambda: ref.compute_peaklambda(thin=thin))
    d_lir = float(np.max(np.abs(lir_s / lir_m - 1.0)))
    d_pk = float(np.max(np.abs(pk_s / pk_m - 1.0)))
    ok = d_lir <= 1e-4 and d_pk <= 2e-3 and lir_s.shape == lir_m.shape
    log(f"[25] (d) {lir_s.shape[0]} x {lir_s.shape[1]} samples of the "
        f"SEDMultiFitter chain (thin {thin}) through SEDMultiFitter and "
        f"MultiFitter: L_IR max rel {d_lir:.3g} (rtol 1e-4), lambda_peak "
        f"max rel {d_pk:.3g} (rtol 2e-3); SEDMultiFitter "
        f"{out['(d) SED compute_lir']:.2f} s / "
        f"{out['(d) SED compute_peaklambda']:.2f} s, MultiFitter "
        f"{out['(d) MBB compute_lir']:.2f} s / "
        f"{out['(d) MBB compute_peaklambda']:.2f} s (host clock) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generic batch derived posteriors are not "
                             "MultiFitter's")
    model = photoz_mbb(cmb=True, z_upper=8.0)
    zs = np.linspace(1.5, 6.0, PZ_BATCH_SOURCES)
    rng = np.random.default_rng(12)
    wave = np.asarray(PZ_WAVE)
    pflux = np.stack([model.fnu(
        torch.tensor([38.0, 1.9, 80.0, 3.0, 10.0, zz]),
        torch.tensor(wave, dtype=torch.float32)).double().numpy()
        for zz in zs]) * (1.0 + 0.05 * rng.standard_normal(
            (PZ_BATCH_SOURCES, wave.size)))
    pz = SEDMultiFitter(model, nwalkers=NWALKERS, seed=2504, device=DEVICE)
    pz.set_data(wave, pflux, 0.07 * pflux)
    pz.set_gaussian_prior("T", 38.0, 6.0)
    pz.fix_param("alpha", 3.0)
    for nm, v in zip(model.param_names, (38.0, 1.9, 80.0, 3.0, 10.0, 3.5)):
        pz.set_param_init(nm, v, 0.1 * v)
    _, out["(d) photo-z batch run"] = _timed(lambda: pz.run(**PZ_BATCH_DEPTH))
    dm_card, out["(d) compute_dustmass_batch"] = _timed(
        lambda: compute_dustmass_batch(pz, thin=4))
    cpu = SEDMultiFitter(model, nwalkers=NWALKERS, seed=2504, device="cpu")
    cpu.set_data(wave, pflux, 0.07 * pflux)
    cpu.chain_free, cpu.free_space = pz.chain_free.cpu(), pz.free_space
    dm_cpu = compute_dustmass_batch(cpu, thin=4)
    d_dm = float(np.max(np.abs(dm_card / dm_cpu - 1.0)))
    ok = d_dm <= 1e-4 and np.all(np.isfinite(dm_card)) and np.all(dm_card > 0)
    log(f"[25] (d) compute_dustmass_batch of a {PZ_BATCH_SOURCES}-source "
        f"photo-z batch (run({PZ_BATCH_DEPTH}) {out['(d) photo-z batch run']:.2f}"
        f" s), {dm_card.shape[1]} samples each: card against CPU max rel "
        f"{d_dm:.3g} (rtol 1e-4), {out['(d) compute_dustmass_batch']:.2f} s;"
        f" median log10 M_dust {np.median(np.log10(dm_card)):.3f} "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("photo-z batch dust mass on the card is not the "
                             "CPU's")
    lap("(d)")

    # -- (e) the batch stretch step's time, kernels and busy share
    smf.run(nburn=0, nsteps=SEDMULTI_TIME_STEPS[0])
    ts = [_timed(lambda: smf.run(nburn=0, nsteps=n))[1]
          for n in SEDMULTI_TIME_STEPS]
    ms_step = 1e3 * (ts[1] - ts[0]) / (SEDMULTI_TIME_STEPS[1]
                                      - SEDMULTI_TIME_STEPS[0])
    t_prof = time.time()
    (k1, h1), (k2, h2) = (_profiled_launches(
        lambda: smf.run(nburn=0, nsteps=n)) for n in (1, 2))
    _, busy = _profiled_busy_ms(lambda: smf.run(nburn=0, nsteps=3))
    t_prof = time.time() - t_prof
    _, wall = _timed(lambda: smf.run(nburn=0, nsteps=3))
    tk = [_timed(lambda: ref.run(nburn=0, nsteps=n))[1]
          for n in K3_TIME_STEPS]
    k3_ms = 1e3 * (tk[1] - tk[0]) / (K3_TIME_STEPS[1] - K3_TIME_STEPS[0])
    share = None if busy is None else busy / (1e3 * wall)
    log(f"[25] (e) SEDMultiFitter batch stretch step, {NSOURCES} x "
        f"{NWALKERS} x 5 bands: {ms_step:.3f} ms per step (marginal, "
        f"run(0, {SEDMULTI_TIME_STEPS[1]}) - run(0, {SEDMULTI_TIME_STEPS[0]}"
        f"), host clock with the card synchronized); {k2 - k1:.0f} device "
        f"kernels and {h2 - h1:.0f} cudaLaunchKernel calls per step "
        f"(torch.profiler, run(0, 2) - run(0, 1)); device busy "
        f"{'not measured' if busy is None else f'{busy:.1f} ms'} of "
        f"{1e3 * wall:.1f} ms for run(0, 3)"
        f"{'' if share is None else f' ({100 * share:.1f}%)'}; the traced "
        f"runs took {t_prof:.1f} s; K3 on the same posterior "
        f"{1e3 * k3_ms:.2f} us per step (marginal, run(0, "
        f"{K3_TIME_STEPS[1]}) - run(0, {K3_TIME_STEPS[0]})): "
        f"{ms_step / k3_ms:.0f}x ({card})")
    out.update({"ms per batch stretch step": ms_step,
                "kernels per step": k2 - k1,
                "launch calls per step": h2 - h1,
                "device busy ms": busy, "profiled wall s": wall,
                "device busy share": share, "traced runs s": t_prof,
                "K3 us per step": 1e3 * k3_ms})
    lap("(e)")
    out["phase 25"] = time.time() - t0
    ok = out["phase 25"] <= 40.0
    log(f"[25] phase 25: {out['phase 25']:.1f} s (advisory budget 40 s: "
        f"{'within' if ok else 'OVER'}); parts end at " + ", ".join(
            f"{k.split()[0]} {v:.1f} s" for k, v in out.items()
            if k.endswith("ends at s")))
    return launches, out


# Phase 26: the generic command line (cli_sed.py) and the plots. The batch
# cell's width (NSOURCES sources x NWALKERS walkers x 5 bands) on a mock
# catalog of examples/two_temp_model_torch.py, depth cut to CLI_SED_DEPTH;
# (b) extends by CLI_SED_DEPTH's -n up to CLI_SED_MAX_STEPS production
# steps; the model-file twins' fnu on TWIN_VECTORS rows; _mc_marginal at
# MC_MARGINAL_N draws; the batch stretch step's time from two production
# lengths CLI_SED_TIME_STEPS. Budget CLI_SED_BUDGET_S, advisory.
CLI_SED_DEPTH = ("-b", "20", "-n", "40")
CLI_SED_SEED = 5
CLI_SED_MAX_STEPS = 120
CLI_SED_WAVE = (60.0, 100.0, 250.0, 500.0, 1100.0)
CLI_SED_INIT = ("--initval", "T_cold", "18", "--initval", "T_warm", "45",
                "--initval", "fnorm_cold", "30", "--initval", "fnorm_warm",
                "1.5")
CLI_SED_TIME_STEPS = (10, 30)
CLI_SED_BUDGET_S = 20.0
TWIN_VECTORS = 4096
MC_MARGINAL_N = 4096
TWIN_FILES = ("two_temp_model", "cmb_high_z_model", "photoz_model")


def cli_sed_catalog(path, seed=2600):
    """A mock catalog of NSOURCES sources from the shipped
    examples/two_temp_model_torch.py at CLI_SED_WAVE (5% errors, numpy
    draws from `seed`, redshifts 1.5-2.5), written in the catalog format;
    returns the model file's path."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.cli_sed import load_model
    from mbb_emcee_tpu_torch.sed import batched_fnu
    mpath = os.path.join(REPO, "examples", "two_temp_model_torch.py")
    model = load_model(mpath)
    rng = np.random.default_rng(seed)
    s = NSOURCES
    truths = np.column_stack([
        rng.uniform(15, 22, s), rng.uniform(38, 52, s), np.full(s, 1.8),
        rng.uniform(15, 60, s), rng.uniform(0.5, 3.0, s)])
    z = rng.uniform(1.5, 2.5, s)
    f = batched_fnu(model.fnu)(
        torch.tensor(truths, dtype=torch.float32),
        torch.tensor(CLI_SED_WAVE, dtype=torch.float32)).double().numpy()
    unc = 0.05 * f
    flux = f + unc * rng.standard_normal(f.shape)
    lines = ["wave = " + " ".join(f"{w:g}" for w in CLI_SED_WAVE)]
    for i in range(s):
        lines.append(f"SRC{i:03d} {z[i]:.4f} " + " ".join(
            f"{flux[i, j]:.6g} {unc[i, j]:.6g}"
            for j in range(len(CLI_SED_WAVE))))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return mpath


def _twin_rows(stem, n, seed):
    """n rows in the populated part of each model file's box (the rows of
    tests/test_torch_examples.py)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if stem == "two_temp_model":
        th = np.column_stack([
            rng.uniform(5.0, 25.0, n), rng.uniform(25.0, 120.0, n),
            rng.uniform(0.5, 4.0, n), rng.uniform(1e-3, 1e3, n),
            rng.uniform(1e-4, 1e2, n)])
    else:
        cols = [rng.uniform(15.0, 60.0, n), rng.uniform(1.0, 2.5, n),
                rng.uniform(50.0, 300.0, n), rng.uniform(1.0, 5.0, n),
                rng.uniform(1.0, 50.0, n)]
        if stem == "photoz_model":
            cols.append(rng.uniform(0.0, 10.0, n))
        th = np.column_stack(cols)
    return th.astype(np.float32)


def _twin_tol(stem, th64, wave64):
    """Phase 25 (a)'s bound on |d ln f| for the same formulas: 1e-5, plus 8
    ulp of the Planck argument x at the band and at the normalization point
    (of the cold component, the larger x, for the two-temperature model),
    plus the CMB visibility's conditioning, 2e-6 (e^-vis - 1) at the band
    and at the normalization point, for the CMB models (z = 5 for the
    cmb_high_z file, the sampled z for photo-z)."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.constants import HCOK_UM_K
    from mbb_emcee_tpu_torch.models.cmb import (
        dust_temperature_with_cmb, log_cmb_visibility)
    eps32 = float(np.finfo(np.float32).eps)
    w = wave64.numpy()[None, :]
    if stem == "two_temp_model":
        t = th64[:, 0].numpy()[:, None]
        return 1e-5 + 8 * eps32 * (HCOK_UM_K / (w * t)
                                   + HCOK_UM_K / (500.0 * t))
    z = (th64[:, 5] if stem == "photoz_model"
         else torch.full_like(th64[:, 0], 5.0))
    t_d = dust_temperature_with_cmb(th64[:, 0], th64[:, 1], z)
    opz, td = (1.0 + z.numpy())[:, None], t_d.numpy()[:, None]
    tol = 1e-5 + 8 * eps32 * (HCOK_UM_K * opz / (w * td)
                              + HCOK_UM_K * opz / (500.0 * td))
    vis = log_cmb_visibility(wave64[None] / (1.0 + z[:, None]),
                             t_d[:, None], z[:, None]).numpy()
    vis_n = log_cmb_visibility(500.0 / (1.0 + z), t_d, z).numpy()
    return tol + 2e-6 * (np.expm1(-vis) + np.expm1(-vis_n)[:, None])


def _twins_on_card():
    """(c) Each model-file twin through cli_sed.load_model: fnu on the card
    against the CPU on TWIN_VECTORS rows x its JAX test's bands. Returns
    {file: (max |d ln f|, max |d ln f| / bound)}."""
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.cli_sed import load_model
    from mbb_emcee_tpu_torch.sed import batched_fnu
    waves = {"two_temp_model": CLI_SED_WAVE,
             "cmb_high_z_model": (250.0, 450.0, 850.0, 1300.0, 2000.0,
                                  3000.0),
             "photoz_model": PZ_WAVE}
    out = {}
    for stem in TWIN_FILES:
        model = load_model(os.path.join(REPO, "examples",
                                        f"{stem}_torch.py"))
        th = _twin_rows(stem, TWIN_VECTORS, 26)
        wave = np.asarray(waves[stem], np.float32)
        card, cpu = (batched_fnu(model.fnu)(
            torch.as_tensor(th, device=dev),
            torch.as_tensor(wave, device=dev)).double().cpu().numpy()
            for dev in (DEVICE, "cpu"))
        tol = _twin_tol(stem, torch.as_tensor(th).double(),
                        torch.as_tensor(wave).double())
        d = np.abs(np.log(card) - np.log(cpu))
        ok = (bool(np.all(np.isfinite(card))) and bool(np.all(card > 0))
              and bool(np.all(d <= tol)))
        out[stem] = (float(d.max()), float(np.max(d / tol)))
        log(f"[26] (c) examples/{stem}_torch.py [{model.name}]: fnu of "
            f"{TWIN_VECTORS} x {wave.size} on the card against the CPU: max "
            f"|d ln f| {d.max():.3g} (/ bound {np.max(d / tol):.3f}; bound "
            f"1e-5 + 8 ulp of x + the visibility's conditioning, phase 25 "
            f"(a)'s) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{stem}_torch.py: fnu on the card is not "
                                 "the CPU's")
    return out


def _extension_lines():
    """A context that records the messages of the package logger (the
    serving loop's 'extending by' lines) in the list it yields."""
    import contextlib
    import logging

    @contextlib.contextmanager
    def ctx():
        got = []

        class Keep(logging.Handler):
            def emit(self, record):
                got.append(record.getMessage())
        handler = Keep()
        logger = logging.getLogger("mbb_emcee_tpu_torch")
        logger.addHandler(handler)
        try:
            yield got
        finally:
            logger.removeHandler(handler)
    return ctx()


def _refusal(fn):
    """'ImportError: ...' (or the other error, or 'no error') of fn()."""
    try:
        fn()
    except ImportError as e:
        return f"ImportError: {e}"
    except Exception as e:  # noqa: BLE001 - reported, then failed
        return f"{type(e).__name__}: {e}"
    return "no error"


def phase_cli_sed(card):
    """The generic command line and the plots through the user's entry
    points (see the module docstring, phase 26). Returns (launches by
    kernel and path, seconds and numbers by step)."""
    import importlib.util
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch import cli_sed
    from mbb_emcee_tpu_torch.catalog import read_catalog
    from mbb_emcee_tpu_torch.hierarchy import TruncatedGaussianPopulation
    from mbb_emcee_tpu_torch.sedmulti import SEDMultiFitter

    t0 = time.time()
    out = {}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}

    def lap(part):
        out[f"{part} ends at s"] = time.time() - t0

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cat = os.path.join(work, "two_temp_catalog.txt")
    mpath = cli_sed_catalog(cat)
    base = [mpath, cat, os.path.join(work, "unwritten.h5"), "--seed",
            str(CLI_SED_SEED), *CLI_SED_DEPTH, *CLI_SED_INIT, "--device",
            DEVICE]
    nburn, nsteps = int(CLI_SED_DEPTH[1]), int(CLI_SED_DEPTH[3])

    # -- (a) the CLI's fit stage against SEDMultiFitter run directly
    _counts(reset=True)
    res, out["(a) CLI fit stage s"] = _timed(lambda: cli_sed.fit(base))
    c = _counts()
    kernels = c["mbb_lnprob"] + c["mbb_stretch_run"] \
        + c["mbb_multi_stretch_run"]
    for name in launches:
        launches[name]["run_sed_tpu_torch fit stage (phase 26)"] = c[name]
    model = cli_sed.load_model(mpath)
    cdata = read_catalog(cat)
    direct = SEDMultiFitter(model, NWALKERS, seed=CLI_SED_SEED,
                            device=DEVICE)
    direct.set_data(cdata.wave, cdata.flux, cdata.unc,
                    band_names=cdata.band_names,
                    source_names=list(cdata.names),
                    redshifts=cdata.redshifts)
    for i in range(0, len(CLI_SED_INIT), 3):
        direct.set_param_init(CLI_SED_INIT[i + 1],
                              float(CLI_SED_INIT[i + 2]))
    _, out["(a) direct run s"] = _timed(
        lambda: direct.run(nburn=nburn, nsteps=nsteps))
    mf = res.mf
    same = (torch.equal(mf.chain_free, direct.chain_free)
            and torch.equal(mf.lnprobability, direct.lnprobability))
    ok = (same and kernels == 0 and c["plain_multi_runs"] == 3
          and c["plain_sampler_runs"] == 0
          and tuple(mf.chain_free.shape) == (NSOURCES, nsteps, NWALKERS, 5))
    log(f"[26] (a) run_sed_tpu_torch's fit stage (cli_sed.fit) on "
        f"examples/two_temp_model_torch.py, {NSOURCES} sources x {NWALKERS} "
        f"walkers x {len(CLI_SED_WAVE)} bands, --seed {CLI_SED_SEED} "
        f"{' '.join(CLI_SED_DEPTH)}: {out['(a) CLI fit stage s']:.2f} s "
        f"(host clock, model and catalog load included); chains "
        f"{'bitwise' if same else 'NOT bitwise'} those of "
        f"SEDMultiFitter(model, {NWALKERS}, seed={CLI_SED_SEED}).run("
        f"{nburn}, {nsteps}) on the same data ({out['(a) direct run s']:.2f}"
        f" s); {c['mbb_lnprob']} K1, {c['mbb_stretch_run']} K2 and "
        f"{c['mbb_multi_stretch_run']} K3 launches, {c['plain_multi_runs']} "
        f"plain multi runs (want 0, 0, 0 and 3) {'PASS' if ok else 'FAIL'} "
        f"({card})")
    if not ok:
        raise AssertionError("the CLI's fit stage is not SEDMultiFitter.run "
                             "on the plain batch step")
    lap("(a)")

    # -- (b) the serving loop, derived posteriors, PPC and the summary
    flags = ["--extend-until", "1.1", "--max-steps", str(CLI_SED_MAX_STEPS),
             "--ppc", "--get-lir", "--get-peaklambda", "--derived-thin",
             "10", "--summary", "-v"]
    _counts(reset=True)
    with _extension_lines() as msgs:
        res_b, out["(b) CLI fit stage s"] = _timed(
            lambda: cli_sed.fit(base + flags))
    c = _counts()
    kernels_b = c["mbb_lnprob"] + c["mbb_stretch_run"] \
        + c["mbb_multi_stretch_run"]
    mf_b, ppc = res_b.mf, res_b.ppc
    n_ext = sum("extending by" in m for m in msgs)
    production = int(mf_b.chain_free.shape[1])
    table = cli_sed._summary(mf_b, ppc=ppc).splitlines()
    lir = np.median(mf_b.lir_chain, axis=1)
    peak = np.median(mf_b.peaklambda_chain, axis=1)
    ok = (production == nsteps * (1 + n_ext)
          and production <= CLI_SED_MAX_STEPS
          and "PPC p" in table[0] and len(table) == NSOURCES + 1
          and bool(np.all(np.isfinite(ppc.p_value)))
          and bool(np.all(np.isfinite(lir))) and bool(np.all(lir > 0))
          and bool(np.all(np.isfinite(peak))) and bool(np.all(peak > 0))
          and kernels_b == 0)
    n_conv = int(np.sum(mf_b.converged(
        rhat_max=1.1, window=nsteps, stride=max(1, production // nsteps))))
    out.update({"(b) extensions": n_ext, "(b) production steps": production,
                "(b) sources converged": n_conv,
                "(b) median PPC p": float(np.median(ppc.p_value))})
    log(f"[26] (b) the fit stage with {' '.join(flags)}: "
        f"{out['(b) CLI fit stage s']:.2f} s (host clock); {n_ext} "
        f"extension(s) logged, {production} production steps recorded "
        f"(want {nsteps} x (1 + {n_ext}) <= {CLI_SED_MAX_STEPS}); "
        f"{n_conv}/{NSOURCES} sources below R-hat 1.1 at the end; summary "
        f"{len(table) - 1} rows with a 'PPC p' column: "
        f"{'yes' if 'PPC p' in table[0] else 'NO'}; median PPC p "
        f"{np.median(ppc.p_value):.3f}, L_IR medians "
        f"{lir.min():.3g}-{lir.max():.3g} Lsun, lambda_peak medians "
        f"{peak.min():.1f}-{peak.max():.1f} um, all finite; {kernels_b} "
        f"kernel launches {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("the CLI's serving loop, derived posteriors or "
                             "summary failed")
    lap("(b)")

    # -- (c) the model-file twins on the card
    out.update({f"(c) {k} max |d ln f|": v[0]
                for k, v in _twins_on_card().items()})
    lap("(c)")

    # -- (d) plotting where there is no matplotlib; _mc_marginal card / CPU
    import mbb_emcee_tpu_torch.plotting as plotting
    if importlib.util.find_spec("matplotlib") is None:
        got = _refusal(lambda: mf.results(0).plot_sed())
        ok = got.startswith("ImportError") and "matplotlib" in got
        log(f"[26] (d) import mbb_emcee_tpu_torch.plotting: done without "
            f"matplotlib; SEDResults.plot_sed() raised {got!r} (want the "
            f"ImportError naming matplotlib) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a plot hook without matplotlib did not "
                                 "raise the ImportError naming it")
    else:
        log("[26] (d) matplotlib is installed on this machine: the check "
            "of the ImportError without it does not apply here")
    x = np.linspace(12.0, 58.0, 101)
    worst = 0.0
    for names, lo, hi, phi in (
            (("T",), [10.0], [60.0], np.array([35.0, 4.0])),
            (("T", "beta"), [10.0, 0.5], [60.0, 4.0],
             np.array([35.0, 1.9, 4.0, 0.3]))):
        pop = TruncatedGaussianPopulation.for_box(names, lo, hi)
        on_card, on_cpu = (plotting._mc_marginal(
            pop, 0, n_mc=MC_MARGINAL_N, seed=3, device=dev)(phi, x)
            for dev in (DEVICE, "cpu"))
        rel = float(np.max(np.abs(on_card - on_cpu)
                           / np.maximum(np.abs(on_cpu), 1e-30)))
        worst = max(worst, rel)
        ok = bool(np.all(np.isfinite(on_card))) and bool(
            np.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-12))
        log(f"[26] (d) _mc_marginal of the {len(names)}-parameter truncated "
            f"normal, {MC_MARGINAL_N} importance draws x {x.size} grid "
            f"points: card against CPU max rel {rel:.3g} (rtol 1e-5) "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("_mc_marginal on the card is not the CPU's")
    out["(d) _mc_marginal max rel"] = worst
    lap("(d)")

    # -- (e) the two-temperature batch step's time and kernels
    direct.run(nburn=0, nsteps=CLI_SED_TIME_STEPS[0])
    ts = [_timed(lambda: direct.run(nburn=0, nsteps=n))[1]
          for n in CLI_SED_TIME_STEPS]
    ms_step = 1e3 * (ts[1] - ts[0]) / (CLI_SED_TIME_STEPS[1]
                                      - CLI_SED_TIME_STEPS[0])
    (k1, h1), (k2, h2) = (_profiled_launches(
        lambda: direct.run(nburn=0, nsteps=n)) for n in (1, 2))
    out.update({"ms per batch stretch step": ms_step,
                "kernels per step": k2 - k1,
                "launch calls per step": h2 - h1})
    log(f"[26] (e) two-temperature batch stretch step, {NSOURCES} x "
        f"{NWALKERS} x {len(CLI_SED_WAVE)} bands: {ms_step:.3f} ms per step "
        f"(marginal, run(0, {CLI_SED_TIME_STEPS[1]}) - run(0, "
        f"{CLI_SED_TIME_STEPS[0]}), host clock with the card synchronized); "
        f"{k2 - k1:.0f} device kernels and {h2 - h1:.0f} cudaLaunchKernel "
        f"calls per step (torch.profiler, run(0, 2) - run(0, 1)) ({card})")
    lap("(e)")
    out["phase 26"] = time.time() - t0
    ok = out["phase 26"] <= CLI_SED_BUDGET_S
    log(f"[26] phase 26: {out['phase 26']:.1f} s (advisory budget "
        f"{CLI_SED_BUDGET_S:.0f} s: {'within' if ok else 'OVER'}); parts end "
        f"at " + ", ".join(f"{k.split()[0]} {v:.1f} s"
                           for k, v in out.items()
                           if k.endswith("ends at s")))
    return launches, out


MIGRATION_DEPTH = (50, 250)
MIGRATION_SEED = 2700
MIGRATION_COSMOLOGY = "Planck18"
MIGRATION_BUDGET_S = 20.0
# A default MBBFitter.run launches K1 at the walker ball's init and again at
# the re-centered re-burn's, and K2 for the burn, the re-burn and the
# production run.
FIT_LAUNCHES = {"mbb_lnprob": 2, "mbb_stretch_run": 3,
                "mbb_multi_stretch_run": 0}


def _trace_kernels(path):
    """{kernel event name: count} of the device-kernel events of one
    torch.profiler Chrome trace file."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    got = {}
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            got[e.get("name", "")] = got.get(e.get("name", ""), 0) + 1
    return got


def _traced_fit(tdir, phot, seed, device):
    """A worker process's MBBFitter.run(*MIGRATION_DEPTH) on `device` under
    profiling.trace(tdir): the process's first torch.profiler session (a
    process that has already run many sessions can drop the device events
    of a later trace). A warm-up run (the kernels' load) and an untraced run
    come first. Returns (the traced run's launch counts, untraced seconds,
    traced seconds, StepTimer's walker-steps/s over the traced run)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from mbb_emcee_tpu_torch import MBBFitter
    from mbb_emcee_tpu_torch.utils.profiling import StepTimer, trace

    nburn, nsteps = MIGRATION_DEPTH

    def fit():
        return MBBFitter(NWALKERS, phot, None, 0, 500.0, False, False,
                         seed=seed, device=device)
    fit().run(nburn, nsteps)
    _, untraced_s = _timed(lambda: fit().run(nburn, nsteps))
    timer = StepTimer(NWALKERS)
    traced_fit = fit()

    def traced():
        with trace(tdir):
            with timer.phase("burn + production", nsteps + 2 * nburn):
                traced_fit.run(nburn, nsteps)
    _counts(reset=True)
    _, traced_s = _timed(traced)
    return _counts(), untraced_s, traced_s, timer.rate()


def phase_migration(card):
    """The migration surface through the user's entry points (see the
    module docstring, phase 27). Returns (launches by kernel and path,
    seconds and numbers by step)."""
    import concurrent.futures
    import glob
    import importlib.util
    import multiprocessing
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBFitter, MBBResults
    from mbb_emcee_tpu_torch import cli_inspect, compat, legacy_h5

    t0 = time.time()
    out = {}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}

    def lap(part):
        out[f"{part} ends at s"] = time.time() - t0

    nburn, nsteps = MIGRATION_DEPTH
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase27_", dir=work)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        flux, unc, _ = vp.mock_data(vp.CONFIGS[2])
        phot = os.path.join(tmp, "phot.txt")
        with open(phot, "w") as fh:
            for w, f, u in zip(vp.WAVE, flux, unc):
                fh.write(f"{w:.17g} {f:.17g} {u:.17g}\n")
        args = (NWALKERS, phot, None, 0, 500.0, False, False)
        # (b)'s worker starts now: its start-up overlaps (a)
        tdir = os.path.join(tmp, "trace")
        traced_run = pool.submit(_traced_fit, tdir, phot,
                                 MIGRATION_SEED + 1, DEVICE)

        # -- (a) compat.mbb_fitter on the card, against MBBFitter
        _counts(reset=True)
        fit, out["(a) compat run s"] = _timed(lambda: compat.mbb_fitter(
            *args, 4, redshift=2.5, seed=MIGRATION_SEED,
            device=DEVICE).run(nburn, nsteps))
        c = _counts()
        path = "compat.mbb_fitter.run (phase 27)"
        for name in launches:
            launches[name][path] = c[name]
        _counts(reset=True)
        ref, out["(a) MBBFitter run s"] = _timed(lambda: MBBFitter(
            *args, nthreads=4, redshift=2.5, seed=MIGRATION_SEED,
            device=DEVICE).run(nburn, nsteps))
        c_ref = _counts()
        same = (torch.equal(fit.chain_free, ref.chain_free)
                and torch.equal(fit.lnprobability, ref.lnprobability))
        theta = np.asarray(vp.TRUE, np.float64)
        like, call = float(fit.like(theta)), float(fit(theta))
        lir_c = np.asarray(compat.mbb_results(
            fit=fit, cosmo_type=MIGRATION_COSMOLOGY).compute_lir())
        lir_n = np.asarray(MBBResults(
            fit=fit, cosmology=MIGRATION_COSMOLOGY).compute_lir())
        lir_same = lir_c.shape == lir_n.shape and bool(
            np.array_equal(lir_c, lir_n)) and bool(np.all(np.isfinite(lir_c)))
        want = {k: c_ref[k] for k in FIT_LAUNCHES}
        ok = (same and {k: c[k] for k in FIT_LAUNCHES} == want == FIT_LAUNCHES
              and c["plain_sampler_runs"] + c["plain_multi_runs"] == 0
              and like == call and np.isfinite(like) and lir_same
              and fit.redshift == 2.5
              and tuple(fit.chain_free.shape) == (nsteps, NWALKERS, 5))
        out.update({"(a) like": like, "(a) L_IR median": float(
            np.median(lir_c))})
        log(f"[27] (a) compat.mbb_fitter{args[:1] + ('phot.txt',) + args[2:]}"
            f" + (4,) [nthreads], redshift=2.5, seed={MIGRATION_SEED}, "
            f"config 2's mock data: run({nburn}, {nsteps}) "
            f"{out['(a) compat run s']:.2f} s (host clock); chains "
            f"{'bitwise' if same else 'NOT bitwise'} MBBFitter's by "
            f"keyword ({out['(a) MBBFitter run s']:.2f} s); "
            f"{c['mbb_lnprob']} K1, {c['mbb_stretch_run']} K2, "
            f"{c['mbb_multi_stretch_run']} K3 launches and "
            f"{c['plain_sampler_runs'] + c['plain_multi_runs']} plain runs "
            f"(want {FIT_LAUNCHES['mbb_lnprob']}, "
            f"{FIT_LAUNCHES['mbb_stretch_run']}, 0, 0: MBBFitter.run's "
            f"{c_ref['mbb_lnprob']}, {c_ref['mbb_stretch_run']}, "
            f"{c_ref['mbb_multi_stretch_run']}); like(theta) {like:.9g} "
            f"{'==' if like == call else '!='} fit(theta) {call:.9g}; "
            f"mbb_results(cosmo_type={MIGRATION_COSMOLOGY!r}).compute_lir() "
            f"{'bitwise' if lir_same else 'NOT bitwise'} MBBResults("
            f"cosmology=...)'s, median {np.median(lir_c):.6g} Lsun "
            f"{'PASS' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError("compat.mbb_fitter / mbb_results is not "
                                 "MBBFitter / MBBResults on the card")
        lap("(a)")

        # -- (b) profiling.trace around a second run (in the worker)
        c, out["(b) untraced run s"], out["(b) traced run s"], rate = \
            traced_run.result()
        path = "MBBFitter.run under profiling.trace (phase 27)"
        for name in launches:
            launches[name][path] = c[name]
        files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
        kernels = _trace_kernels(files[0]) if len(files) == 1 else {}
        n_k2 = sum(n for k, n in kernels.items()
                   if "mbb_stretch_kernel" in k)
        n_k1 = sum(n for k, n in kernels.items()
                   if "mbb_lnprob_kernel" in k
                   or "mbb_lnprob_loop_kernel" in k)
        out.update({
            "(b) trace files": len(files),
            "(b) trace bytes": (os.path.getsize(files[0]) if files else 0),
            "(b) trace adds s": out["(b) traced run s"]
            - out["(b) untraced run s"],
            "(b) K2 kernel events": n_k2, "(b) K1 kernel events": n_k1,
            "(b) device kernel events": sum(kernels.values()),
            "(b) StepTimer walker-steps/s": rate})
        ok = (len(files) == 1 and n_k2 == FIT_LAUNCHES["mbb_stretch_run"]
              and n_k1 >= 1 and {k: c[k] for k in FIT_LAUNCHES} == FIT_LAUNCHES
              and np.isfinite(rate) and rate > 0)
        log(f"[27] (b) profiling.trace(dir) around MBBFitter.run({nburn}, "
            f"{nsteps}) on the card, the first trace of a fresh worker "
            f"process: {len(files)} trace file(s) (want 1), "
            f"{out['(b) trace bytes']:,} bytes, "
            f"{sum(kernels.values())} device-kernel events: "
            f"mbb_stretch_kernel x {n_k2} (want 3), mbb_lnprob kernels x "
            f"{n_k1} (want >= 1); {c['mbb_lnprob']} K1 and "
            f"{c['mbb_stretch_run']} K2 launches counted (want "
            f"{FIT_LAUNCHES['mbb_lnprob']} and "
            f"{FIT_LAUNCHES['mbb_stretch_run']}: the trace adds none); the "
            f"traced call {out['(b) traced run s']:.2f}"
            f" s against {out['(b) untraced run s']:.2f} s untraced (host "
            f"clock): the trace adds {out['(b) trace adds s']:.2f} s; "
            f"StepTimer {rate:,.0f} walker-steps/s over the traced call "
            f"{'PASS' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError("the profiler trace of a fit on the card "
                                 "lacks its kernels")
        lap("(b)")

        # -- (c) the host-only modules where there is no h5py
        parsed = cli_inspect.build_parser().parse_args(["x.h5"])
        parse_ok = (parsed.files == ["x.h5"] and parsed.percentile == 68.3
                    and not parsed.json)
        if importlib.util.find_spec("h5py") is None:
            got_r = _refusal(lambda: legacy_h5.read_upstream_results(phot))
            got_i = _refusal(lambda: cli_inspect.inspect_file(phot))
            ok = parse_ok and all(g.startswith("ImportError") and "h5py" in g
                                  for g in (got_r, got_i))
            log(f"[27] (c) mbb_emcee_tpu_torch.legacy_h5, .cli_inspect and "
                f".compat imported without h5py; read_upstream_results "
                f"raised {got_r!r}, inspect_file raised {got_i!r} (want the "
                f"ImportError naming h5py); build_parser().parse_args("
                f"['x.h5']) {'parsed' if parse_ok else 'FAILED'} "
                f"{'PASS' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the host-only modules did not refuse "
                                     "by name without h5py")
        else:
            log("[27] (c) h5py is installed on this machine: the check of "
                "the ImportError without it does not apply here; "
                f"build_parser().parse_args(['x.h5']) "
                f"{'parsed' if parse_ok else 'FAILED'}")
            if not parse_ok:
                raise AssertionError("mbb_tpu_inspect_torch's parser")
        lap("(c)")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase 27"] = time.time() - t0
    ok = out["phase 27"] <= MIGRATION_BUDGET_S
    log(f"[27] phase 27: {out['phase 27']:.1f} s (advisory budget "
        f"{MIGRATION_BUDGET_S:.0f} s: {'within' if ok else 'OVER'}); parts "
        f"end at " + ", ".join(f"{k.split()[0]} {v:.1f} s"
                               for k, v in out.items()
                               if k.endswith("ends at s")))
    return launches, out

MESH_DEPTH = (50, 250)
MESH_BATCH_SHARDS = 4
MESH_WALKER_SHARDS = 5
MESH_SOURCE0 = 64
# (f)'s catalog of several waves per card: the batch cell tiled 64 times,
# 16,384 sources, about 4 of K3's 1,056-source waves per card on 4 cards
MESH_WIDE_TILES = 64
MESH_TIME_STEPS = 100
MESH_BUDGET_S = 20.0


def card_mesh(n):
    """(mesh of n shards, where they lie): across the cards when the
    machine has more than one, else n shards sharing cuda:0 (on the CPU,
    the CPU)."""
    import torch
    from mbb_emcee_tpu_torch.parallel import walker_mesh
    if DEVICE == "cpu":
        return walker_mesh(n, devices=["cpu"] * n), f"{n} CPU shards"
    k = torch.cuda.device_count()
    mesh = walker_mesh(n, devices=[f"cuda:{i % k}" for i in range(n)])
    return mesh, (f"{n} shards across {k} cards" if k > 1 else
                  f"{n} shards sharing cuda:0 (one card: the path across "
                  f"cards is not exercised)")


def phase_mesh(card):
    """Multi-device sharding through the user's entry points (see the
    module docstring, phase 28). Returns (launches by kernel and path,
    seconds and numbers by step, max abs error by kernel)."""
    import dataclasses
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import cli_batch
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        mbb_lnprob, prepare_lnprob_inputs)
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.parallel import ShardedEnsembleSampler
    from mbb_emcee_tpu_torch.sampler import (
        EnsembleSampler, multi_stretch_run_plain)

    t0 = time.time()
    out = {}
    errs = {"mbb_lnprob": 0.0, "mbb_multi_stretch_run": 0.0}
    launches = {"mbb_lnprob": {}, "mbb_stretch_run": {},
                "mbb_multi_stretch_run": {}}
    nburn, nsteps = MESH_DEPTH

    def lap(part):
        out[f"{part} ends at s"] = time.time() - t0

    # -- (a) the batch cell over a source mesh: K3 once per shard and phase
    mesh_b, where_b = card_mesh(MESH_BATCH_SHARDS)
    flux, unc = batch_data(NSOURCES, seed=2800, missing_every=16)

    def batch(mesh):
        # the default sampler_backend ("auto"): K3 on the card, mesh or not
        return batch_fitter(flux, unc, seed=2801, mesh=mesh)

    _counts(reset=True)
    got, out["(a) sharded run s"] = _timed(
        lambda: batch(mesh_b).run(nburn, nsteps))
    c = _counts()
    path = f"MultiFitter(mesh={MESH_BATCH_SHARDS} shards).run (phase 28)"
    for name in launches:
        launches[name][path] = c[name]
    want, out["(a) unsharded run s"] = _timed(
        lambda: batch(None).run(nburn, nsteps))
    same = (torch.equal(got.chain_free, want.chain_free)
            and torch.equal(got.lnprobability, want.lnprobability)
            and np.array_equal(got.acceptance_fraction,
                               want.acceptance_fraction))
    n_k3 = 3 * MESH_BATCH_SHARDS
    ok = (same and c["mbb_multi_stretch_run"] == n_k3
          and c["plain_multi_runs"] == 0 and got._backend_used == "fused"
          and bool(torch.isfinite(got.lnprobability).all()))
    log(f"[28] (a) MultiFitter(mesh), default sampler_backend, at the batch "
        f"cell's width ({NSOURCES} sources x {NWALKERS} walkers x 5 bands, "
        f"band 0 missing in 16) on {where_b}: run({nburn}, {nsteps}) "
        f"{out['(a) sharded run s']:.2f} s against "
        f"{out['(a) unsharded run s']:.2f} s unsharded (host clock); chains, "
        f"lnprob and acceptance {'bitwise' if same else 'NOT bitwise'} the "
        f"unsharded K3 run's; {c['mbb_multi_stretch_run']} K3 launches "
        f"(want {n_k3}: 3 per shard), {c['plain_multi_runs']} plain multi "
        f"runs {'PASS' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError("the sharded batch run is not the unsharded "
                             "K3 run")
    lap("(a)")

    # -- (b) K3 at a global source offset against its plain version
    mf = batch(None)
    spec = mf._effective_spec()
    whole = mf._build_sampler(spec)
    lo, hi = MESH_SOURCE0, 2 * MESH_SOURCE0
    view = mf._shard_view(lo, hi, mf.device)
    part = view._build_sampler(view._effective_spec())
    state = whole.init_state(_multi_ball(whole.free_space, NSOURCES, 40),
                             seed=77)
    pstate = dataclasses.replace(state, pos=state.pos[lo:hi].contiguous(),
                                 lnp=state.lnp[lo:hi].contiguous(),
                                 naccept=state.naccept[lo:hi].contiguous())
    got_w = whole.run_mcmc(state, 200, thin=10)
    got_p = part.run_mcmc(pstate, 200, thin=10)
    rows = (torch.equal(got_p[1], got_w[1][lo:hi])
            and torch.equal(got_p[2], got_w[2][lo:hi])
            and torch.equal(got_p[0].naccept, got_w[0].naccept[lo:hi]))
    log(f"[28] (b) K3 with source0={lo} on sources {lo}..{hi - 1} of the "
        f"batch cell, Philox mode, 20 records x thin 10: chains, lnprob and "
        f"accepts {'bitwise' if rows else 'NOT bitwise'} rows {lo}:{hi} of "
        f"the {NSOURCES}-source launch {'PASS' if rows else 'FAIL'}")
    if not rows:
        raise AssertionError("K3's source0 does not give a source the "
                             "stream it has in the whole batch")
    plain = multi_stretch_run_plain(pstate, part.ops.plain, 20, 10, part.a,
                                    source0=lo)
    errs["mbb_multi_stretch_run"] = _compare_multi_width(
        "28", part, pstate, got_p, plain, 10)
    lap("(b)")

    # -- (c) the walker-sharded sampler on K1 per shard, bitwise the
    # single-device sampler on the same K1 lnprob
    mesh_w, where_w = card_mesh(MESH_WALKER_SHARDS)
    phot, shape, spec2 = problem(2)
    ops_by_dev, by_dev = {}, {}
    for dev in mesh_w.devices:
        if dev not in by_dev:
            ops = ops_by_dev[dev] = prepare_lnprob_inputs(phot, shape, spec2,
                                                          device=dev)
            by_dev[dev] = (lambda o: lambda x: mbb_lnprob(x.contiguous(),
                                                          o))(ops)
    sharded = ShardedEnsembleSampler(
        NWALKERS, ops.nfree, [by_dev[d] for d in mesh_w.devices], mesh_w)
    single = EnsembleSampler(NWALKERS, ops.nfree, by_dev[mesh_w.devices[0]])
    p0 = _ball(ops.free_space, NWALKERS, 28, mesh_w.devices[0])
    nrun = 200
    _counts(reset=True)
    rs = sharded.run_mcmc(sharded.init_state(p0, seed=2802), nrun, thin=10)
    k1_sharded = _counts()["mbb_lnprob"]
    _counts(reset=True)
    r1 = single.run_mcmc(single.init_state(p0, seed=2802), nrun, thin=10)
    k1_single = _counts()["mbb_lnprob"]
    same = (torch.equal(rs[1], r1[1]) and torch.equal(rs[2], r1[2])
            and torch.equal(rs[0].naccept, r1[0].naccept))
    k = MESH_WALKER_SHARDS
    want_k1 = 2 * k + 2 * k + 2 * k * nrun
    ok = same and k1_sharded == want_k1 and k1_single == 3 + 2 * nrun
    path = f"ShardedEnsembleSampler({k} shards) on K1 (phase 28)"
    launches["mbb_lnprob"][path] = k1_sharded
    log(f"[28] (c) ShardedEnsembleSampler on {where_w}, K1 per shard, "
        f"config 2, {NWALKERS} walkers ({NWALKERS // 2 // k} per shard and "
        f"half), run_mcmc({nrun}, thin=10): chains, lnprob and accepts "
        f"{'bitwise' if same else 'NOT bitwise'} EnsembleSampler's on the "
        f"same K1 lnprob and seed; {k1_sharded} K1 launches (want "
        f"{want_k1}: 2 per shard and half-step, 4 per shard to start), "
        f"{k1_single} unsharded (want {3 + 2 * nrun}) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the walker-sharded sampler is not the single "
                             "sampler on K1")
    # K1 at the shard's batch against its plain version (build_lnprob's),
    # on each shard's device: every shard's block of each half, at the
    # first and last records of the sharded run's chain
    loc = NWALKERS // 2 // k
    dk1 = 0.0
    for rec in (0, rs[1].shape[0] - 1):
        for h in range(2):
            for d, dev in enumerate(mesh_w.devices):
                lo_w = h * (NWALKERS // 2) + d * loc
                x = rs[1][rec, lo_w:lo_w + loc].to(dev).contiguous()
                kern = mbb_lnprob(x, ops_by_dev[dev]).double()
                want = ops_by_dev[dev].plain(x).double()
                dabs = (kern - want).abs()
                if not bool((dabs <= K1_ATOL + K1_RTOL * want.abs()).all()):
                    raise AssertionError(
                        f"K1 on shard {d} ({dev}) disagrees with its plain "
                        f"version at {loc} vectors")
                dk1 = max(dk1, float(dabs.max()))
    errs["mbb_lnprob"] = dk1
    log(f"[28] (c) K1 on each shard's device at its batch ({loc} vectors, "
        f"every shard and half, first and last records) against "
        f"build_lnprob's plain version: max |d| {dk1:.3g} (rtol "
        f"{K1_RTOL:g}, atol {K1_ATOL:g}) PASS")
    lap("(c)")

    # -- (d) MBBFitter(mesh=) through the whole protocol against K2's fit
    flux2, unc2, cov2 = vp.mock_data(vp.CONFIGS[2])
    free = vp.free_indices(vp.CONFIGS[2])
    _counts(reset=True)
    fit, out["(d) sharded fit s"] = _timed(lambda: port_fitter(
        2, flux2, unc2, cov2, 2803, mesh=mesh_w).run(nburn, nsteps))
    c = _counts()
    path = f"MBBFitter(mesh={k} shards).run (phase 28)"
    for name in launches:
        launches[name][path] = c[name]
    ref, out["(d) K2 fit s"] = _timed(lambda: port_fitter(
        2, flux2, unc2, cov2, 2803).run(nburn, nsteps))
    # K1 once per shard and half: for each of the two init_states and at
    # the start of each of the three runs, then at every half-step
    want_k1 = 2 * k * (2 + 3 + 2 * nburn + nsteps)
    ok = (fit._backend_used == "sharded" and c["mbb_lnprob"] == want_k1
          and c["mbb_stretch_run"] == 0
          and c["plain_sampler_runs"] + c["plain_multi_runs"] == 0)
    log(f"[28] (d) MBBFitter(mesh) on {where_w}, config 2, run({nburn}, "
        f"{nsteps}): {out['(d) sharded fit s']:.2f} s against K2's "
        f"{out['(d) K2 fit s']:.2f} s (host clock); {c['mbb_lnprob']} K1 "
        f"launches (want {want_k1}), {c['mbb_stretch_run']} K2, "
        f"{c['plain_sampler_runs'] + c['plain_multi_runs']} plain runs "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MBBFitter(mesh=) did not run on K1 per shard")
    _posterior_vs(f"MBBFitter(mesh={k} shards).run({nburn}, {nsteps})", fit,
                  ref, 0.01, free, phase=28,
                  ref_tag=f"K2 run({nburn}, {nsteps})")
    lap("(d)")

    # -- (e) --mesh-devices asks for more cards than there are
    have = 1 if DEVICE == "cpu" else torch.cuda.device_count()
    try:
        cli_batch.main(["catalog.txt", "out.h5", "--device", "cuda",
                        "--mesh-devices", str(have + 1)])
        got_e = "no error"
    except (ValueError, SystemExit) as err:
        got_e = f"{type(err).__name__}: {err}"
    ok = got_e == (f"ValueError: requested {have + 1} devices, only {have} "
                   "available")
    log(f"[28] (e) cli_batch.main(... --device cuda --mesh-devices "
        f"{have + 1}) with {have} card(s): {got_e} "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok and DEVICE != "cpu":
        raise AssertionError("--mesh-devices did not refuse a mesh larger "
                             "than the cards present")
    lap("(e)")

    # -- (f) time and kernels per step: the sharded single fit against K2,
    # the sharded K3 run against the unsharded
    st = sharded.init_state(p0, seed=2804)
    t_sh = _host_s(lambda: sharded.run_mcmc(st, MESH_TIME_STEPS))
    n_sh = _profiled_launches(lambda: sharded.run_mcmc(st, 10))[0]
    k2 = FusedSampler(NWALKERS, phot, shape, spec2, device=mesh_w.devices[0])
    st2 = k2.init_state(p0, seed=2804)
    t_k2 = _host_s(lambda: k2.run_mcmc(st2, MESH_TIME_STEPS))
    n_k2 = _profiled_launches(lambda: k2.run_mcmc(st2, 10))[0]
    lap("(f1)")
    samp_b = got._sampler
    st_b = samp_b.init_state(_multi_ball(whole.free_space, NSOURCES, 41),
                             seed=78)
    t_kb = _host_s(lambda: samp_b.run_mcmc(st_b, 200, thin=10))
    t_k1 = _host_s(lambda: whole.run_mcmc(st_b, 200, thin=10))
    lap("(f2)")
    # K3 on a catalog of several waves per card, sharded and not, in turns
    # (sharded, unsharded, unsharded, sharded) after a short warm-up each
    nwide = MESH_WIDE_TILES * NSOURCES
    wide = [batch_fitter(np.tile(flux, (MESH_WIDE_TILES, 1)),
                         np.tile(unc, (MESH_WIDE_TILES, 1)), seed=2805,
                         mesh=m) for m in (mesh_b, None)]
    samps = [w._batch_sampler(w._effective_spec()) for w in wide]
    st_w = samps[1].init_state(_multi_ball(
        whole.free_space, NSOURCES, 42).repeat(MESH_WIDE_TILES, 1, 1),
        seed=79)
    runs = [sm.run_mcmc(st_w, 200, thin=10) for sm in samps]
    same_w = (torch.equal(runs[0][1], runs[1][1])
              and torch.equal(runs[0][2], runs[1][2]))
    del runs
    # thin 10 records 20 states per walker; thin 200 one, so the join
    # moves a twentieth of the bytes and the time is mostly the launches
    t_w = {(i, th): [] for i in (0, 1) for th in (10, 200)}
    for th in (10, 200):
        for i in (0, 1, 1, 0):
            t_w[i, th].append(_host_s(lambda: samps[i].run_mcmc(
                st_w, 200, thin=th)))
    # where the sharded time goes (thin 200): each shard's K3 run alone on
    # its card, and the host's seconds until the sharded run returns (the
    # launches enqueued, no sync)
    from mbb_emcee_tpu_torch.batchengine import _cut
    shards = samps[0]._shards
    cuts = [_cut(st_w, sh.lo, sh.hi, sh.device) for sh in shards]
    t_alone = [_host_s(lambda: sh.obj.run_mcmc(c, 200, thin=200))
               for sh, c in zip(shards, cuts)]
    _sync_all()
    t_q = time.perf_counter()
    samps[0].run_mcmc(st_w, 200, thin=200)
    t_q = time.perf_counter() - t_q
    _sync_all()
    out.update({
        "(f) sharded single fit ms per step": 1e3 * t_sh / MESH_TIME_STEPS,
        "(f) sharded single fit kernels per step": n_sh / 10,
        "(f) K2 ms per step": 1e3 * t_k2 / MESH_TIME_STEPS,
        "(f) K2 kernels per 10-step run": n_k2,
        "(f) sharded K3 run ms (200 steps)": 1e3 * t_kb,
        "(f) unsharded K3 run ms (200 steps)": 1e3 * t_k1,
        **{f"(f) {'un' if i else ''}sharded K3 run ms ({nwide} sources, "
           f"200 steps, thin {th}, two turns)": [1e3 * x for x in v]
           for (i, th), v in t_w.items()},
        f"(f) each shard's K3 run alone ms ({nwide} sources, thin 200)":
            [1e3 * x for x in t_alone],
        f"(f) host ms until the sharded run returns ({nwide} sources, "
        "thin 200)": 1e3 * t_q})
    log(f"[28] (f) the walker-sharded single fit ({where_w}): "
        f"{1e3 * t_sh / MESH_TIME_STEPS:.3f} ms per step, "
        f"{n_sh / 10:.1f} device kernels per step; K2 on the same posterior "
        f"{1e3 * t_k2 / MESH_TIME_STEPS:.4f} ms per step, {n_k2} kernel(s) "
        f"per {10}-step run; K3 over {where_b}: {1e3 * t_kb:.2f} ms per "
        f"200-step run of {NSOURCES} sources, unsharded {1e3 * t_k1:.2f} ms; "
        f"at {nwide} sources " + "; ".join(
            f"thin {th}: "
            f"{', '.join(f'{1e3 * x:.2f}' for x in t_w[0, th])} ms sharded "
            f"against {', '.join(f'{1e3 * x:.2f}' for x in t_w[1, th])} ms "
            f"unsharded" for th in (10, 200))
        + f"; each shard alone (thin 200) "
        f"{', '.join(f'{1e3 * x:.2f}' for x in t_alone)} ms, the sharded "
        f"run returns to the host after {1e3 * t_q:.2f} ms"
        f", chains {'bitwise' if same_w else 'NOT bitwise'} (host clock, "
        f"every card synchronized) ({card})")
    if not same_w:
        raise AssertionError(f"the sharded {nwide}-source K3 run is not the "
                             "unsharded one")
    lap("(f)")
    out["phase 28"] = time.time() - t0
    ok = out["phase 28"] <= MESH_BUDGET_S
    log(f"[28] phase 28: {out['phase 28']:.1f} s (advisory budget "
        f"{MESH_BUDGET_S:.0f} s: {'within' if ok else 'OVER'}); parts end "
        f"at " + ", ".join(f"{k_.split()[0]} {v:.1f} s"
                           for k_, v in out.items()
                           if k_.endswith("ends at s")))
    return launches, out, errs


PHASES = ("0", "1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11", "12",
          "13", "14", "15", "16", "17", "18", "19", "20", "21", "22", "23",
          "24", "25", "26", "27", "28")


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers to run alone (a "
                         "rehearsal: no kernel table and no result line)")
    ap.add_argument("--profile-derived", action="store_true",
                    help="phases 9 and 14 also take each derived "
                         "posterior's device busy time from torch.profiler "
                         "(adds about a minute)")
    args = ap.parse_args(argv)
    global PROFILE_DERIVED
    PROFILE_DERIVED = args.profile_derived
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    use_repo_tests_package()
    use_port_response_pack()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    t0 = time.time()
    steps = [
        ("0", phase_device), ("1", phase_build), ("2", phase_k1),
        ("3", phase_k2), ("4", phase_determinism), ("5", phase_main_path),
        ("6", lambda: phase_time(card)), ("7", phase_k3),
        ("8", lambda: (phase_k3_philox(), phase_k3_width())[1]),
        ("9", lambda: phase_batch_path(card)),
        ("10", lambda: phase_time_k3(card)),
        ("11", phase_response_kernels), ("12", phase_extend),
        ("13", lambda: phase_time_response(card)),
        ("14", lambda: phase_parity(card)),
        ("15", phase_k2_layouts), ("16", lambda: phase_plan_sweep(card)),
        ("17", phase_k3_layouts), ("18", lambda: phase_k3_sweep(card)),
        ("19", phase_k1_layouts), ("20", lambda: phase_k1_sweep(card)),
        ("21", lambda: phase_map_checks(card)),
        ("22", lambda: phase_tiers(card)),
        ("23", lambda: phase_evidence(
            card, res["22"][1] if "22" in res else None)),
        ("24", lambda: phase_generic(card)),
        ("25", lambda: phase_generic_batch(card)),
        ("26", lambda: phase_cli_sed(card)),
        ("27", lambda: phase_migration(card)),
        ("28", lambda: phase_mesh(card))]
    only = None if args.phases is None else set(args.phases.split(","))
    if only is not None and not only <= set(PHASES):
        raise SystemExit(f"unknown phases {sorted(only - set(PHASES))}")
    res = {}
    for name, fn in steps:
        if only is None or name in only or name in ("0", "1"):
            t_phase = time.time()
            res[name] = fn()
            log(f"phase {name}: {time.time() - t_phase:.1f} s")
    if only is not None:
        log(f"rehearsal of phases {sorted(only, key=int)} done: no kernel "
            "table, no result line")
        return 0

    counts, ext, (par, derived_single) = res["5"], res["12"], res["14"]
    t = {**res["6"], **res["10"], **res["13"]}
    r1, r2, r3 = res["11"]
    plans, k2_layout_err = res["15"]
    sweep = res["16"]
    k3_plans, k3_layout_err = res["17"]
    k3_sweep = res["18"]
    k1_by_path = {"single fit (phase 5)": counts["mbb_lnprob"],
                  "extend (phase 12)": ext["mbb_lnprob"],
                  "parity matrix (phase 14)": par["mbb_lnprob"]}
    k2_by_path = {"single fit (phase 5)": counts["mbb_stretch_run"],
                  "extend (phase 12)": ext["mbb_stretch_run"],
                  "parity matrix (phase 14)": par["mbb_stretch_run"]}
    k3_by_path = dict(res["9"][0])
    k1_plans, k1_layout_err, (rc1, rc2, rc3) = res["19"]
    k1_sweep, k1_host = res["20"]
    k3_by_path["extend (phase 12)"] = ext["mbb_multi_stretch_run"]
    map_paths, map_times = res["21"]
    pt_launches, tier_times = res["22"]
    k1_by_path["run_pt (phase 22)"] = pt_launches
    evidence_paths, evidence_times = res["23"]
    generic_paths, generic_times = res["24"]
    batch_paths, batch_times = res["25"]
    cli_sed_paths, cli_sed_times = res["26"]
    migration_paths, migration_times = res["27"]
    mesh_paths, mesh_times, mesh_errs = res["28"]
    for by_path, name in ((k1_by_path, "mbb_lnprob"),
                          (k2_by_path, "mbb_stretch_run"),
                          (k3_by_path, "mbb_multi_stretch_run")):
        by_path.update({f"{k} (phase 21)": v
                        for k, v in map_paths[name].items()})
        by_path.update(evidence_paths[name])
        by_path.update(generic_paths[name])
        by_path.update(batch_paths[name])
        by_path.update(cli_sed_paths[name])
        by_path.update(migration_paths[name])
        by_path.update(mesh_paths[name])
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import LnprobPlan
    no_library = "no single PyTorch call computes it"
    kernels = [
        {"name": "mbb_lnprob", "route": "cuda",
         "source": "mbb_emcee_tpu_torch/csrc/lnprob.cu",
         "replaces": "mbb_emcee_tpu/ops/pallas_lnprob.py:248",
         "launches": sum(k1_by_path.values()),
         "launches_by_path": k1_by_path,
         "max_abs_err": max(res["2"], r1, k1_layout_err, rc1,
                            mesh_errs["mbb_lnprob"]),
         "ms": t["k1_ms"], "plain_ms": t["k1_plain_ms"],
         "bound_ms": t["k1_bound"][0], "bound_us": 1e3 * t["k1_bound"][0],
         "bound_by": t["k1_bound"][1], "library_ms": None,
         "library_note": no_library,
         "response_ms": t["k1_resp_ms"],
         "response_plain_ms": t["k1_resp_plain_ms"],
         "response_bound_ms": t["k1_resp_bound"][0],
         "plans": {k: _k1_name(p) for k, p in k1_plans.items()
                   if k.split(",")[0] in dict(SWEEP_CASES)},
         "sweep_cells": {k: {"plan": _k1_name(LnprobPlan(**v["plan"])),
                             "us": v["us"], "us_g1_128": v["old_us"],
                             "bound_us": v["bound_us"],
                             "share_of_bound": v["share_of_bound"]}
                         for k, v in k1_sweep.items()},
         "probe": k1_host,
         "ptxas": [{k: r[k] for k in ("kernel", "group", "registers",
                                      "spill_stores", "spill_loads")}
                   for r in res["1"][1]]},
        {"name": "mbb_stretch_run", "route": "cuda",
         "source": "mbb_emcee_tpu_torch/csrc/sampler.cu",
         "replaces": "mbb_emcee_tpu/ops/pallas_sampler.py:63",
         "launches": sum(k2_by_path.values()),
         "launches_by_path": k2_by_path,
         "max_abs_err": max(res["3"], r2, k2_layout_err, rc2),
         "ms": t["k2_ms"], "plain_ms": t["k2_plain_ms"],
         "bound_ms": t["k2_bound"][0], "bound_us": 1e3 * t["k2_bound"][0],
         "bound_by": t["k2_bound"][1], "library_ms": None,
         "library_note": no_library,
         "plan": sweep["point"]["plan"],
         "sweep_us": sweep["point"]["us"],
         "sweep_us_g1c1": sweep["point"]["old_us"],
         "response_ms": t["k2_resp_ms"],
         "response_plain_ms": t["k2_resp_plain_ms"],
         "response_bound_ms": t["k2_resp_bound"][0],
         "response_plan": sweep["response"]["plan"],
         "response_sweep_us": sweep["response"]["us"],
         "response_sweep_us_g1c1": sweep["response"]["old_us"]},
        {"name": "mbb_multi_stretch_run", "route": "cuda",
         "source": "mbb_emcee_tpu_torch/csrc/multifit.cu",
         "replaces": "mbb_emcee_tpu/ops/pallas_multifit.py:203",
         "launches": sum(k3_by_path.values()),
         "launches_by_path": k3_by_path,
         "max_abs_err": max(res["7"], res["8"], r3, k3_layout_err, rc3,
                            mesh_errs["mbb_multi_stretch_run"]),
         "ms": t["k3_ms"], "plain_ms": t["k3_plain_ms"],
         "bound_ms": t["k3_bound"][0], "bound_us": 1e3 * t["k3_bound"][0],
         "bound_by": t["k3_bound"][1], "library_ms": None,
         "library_note": no_library,
         "rate": t["k3_rate"],
         "plan": k3_sweep[f"point {NSOURCES}"]["plan"],
         "sweep_us": k3_sweep[f"point {NSOURCES}"]["us"],
         "sweep_us_g1c1": k3_sweep[f"point {NSOURCES}"]["old_us"],
         "plan_4_sources": k3_sweep["point 4"]["plan"],
         "sweep_us_4_sources": k3_sweep["point 4"]["us"],
         "sweep_us_4_sources_g1c1": k3_sweep["point 4"]["old_us"],
         "bound_us_4_sources": k3_sweep["point 4"]["bound_us"],
         "response_ms": t["k3_resp_ms"],
         "response_plain_ms": t["k3_resp_plain_ms"],
         "response_bound_ms": t["k3_resp_bound"][0],
         "response_rate": t["k3_resp_rate"],
         "response_plan": k3_sweep[f"response {NSOURCES}"]["plan"],
         "response_sweep_us": k3_sweep[f"response {NSOURCES}"]["us"],
         "response_sweep_us_g1c1": k3_sweep[f"response {NSOURCES}"]["old_us"],
         "response_plan_4_sources": k3_sweep["response 4"]["plan"],
         "response_sweep_us_4_sources": k3_sweep["response 4"]["us"],
         "response_sweep_us_4_sources_g1c1":
             k3_sweep["response 4"]["old_us"],
         "response_bound_us_4_sources": k3_sweep["response 4"]["bound_us"],
         "planned_layouts": {k: f"G={p.group} x C={p.cluster}"
                             for k, p in k3_plans.items()},
         "sweep_cells": {k: {"plan": f"G={v['plan']['group']} x "
                                     f"C={v['plan']['cluster']}",
                             "us": v["us"], "us_g1c1": v["old_us"],
                             "bound_us": v["bound_us"]}
                         for k, v in k3_sweep.items()},
         "ptxas": [{k: r[k] for k in ("group", "cluster", "registers",
                                      "spill_stores", "spill_loads")}
                   for r in res["1"][0]]},
    ]
    log("derived posteriors (the next thing to shorten): " + json.dumps(
        {"batch 256 x 62500 samples": res["9"][1],
         "single fit, config 4": derived_single}))
    log(f"MAP and model checking, host seconds ({card}): "
        + json.dumps(map_times))
    log(f"HMC and PT, host seconds and counts ({card}): "
        + json.dumps(tier_times))
    log(f"nested sampling and population, host seconds and counts "
        f"({card}): " + json.dumps(evidence_times))
    log(f"generic tier, host seconds and counts ({card}): "
        + json.dumps(generic_times))
    log(f"generic batch tier and photo-z, host seconds and counts ({card}): "
        + json.dumps(batch_times))
    log(f"generic CLI and plots, host seconds and counts ({card}): "
        + json.dumps(cli_sed_times))
    log(f"migration surface, host seconds and counts ({card}): "
        + json.dumps(migration_times))
    log(f"multi-device sharding, host seconds and counts ({card}): "
        + json.dumps(mesh_times))
    log(f"all phases: {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
