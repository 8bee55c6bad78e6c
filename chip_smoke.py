"""On-card smoke run of the PyTorch + CUDA port (mbb_emcee_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without printing a result):

  0. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     nvcc path;
  1. build: compile the kernels of mbb_emcee_tpu_torch/csrc with nvcc;
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
     torch sampler on the card.

It then prints the kernel table as one JSON line, the nvidia-smi line, and
as its last line {"ok": true, "device": {...}}. Without a CUDA device it
exits with code 1 before any phase.
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


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    from mbb_emcee_tpu_torch.ops.build import build_kernels, build_log
    t0 = time.time()
    build_kernels()
    log(f"[1] build: {time.time() - t0:.1f} s")
    for line in (build_log() or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[1]   {line.strip()}")


def phase_k1():
    """K1 against build_lnprob's function on the card, per case."""
    import numpy as np
    import torch
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch.likelihood import LNPROB_FLOOR
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import (
        prepare_lnprob_inputs, mbb_lnprob)

    cases = [("config0 thin3", dict(ci=0)), ("config1 thick4", dict(ci=1)),
             ("config2 full5", dict(ci=2)), ("config5 cov", dict(ci=5)),
             ("config6 cov+uplim", dict(ci=6)),
             ("response 5x65", dict(ci=2, response_pack=numpy_response_pack(
                 vp.WAVE))),
             ("alpha fixed at 0", dict(ci=2, alpha_fixed_at=0.0))]
    worst = 0.0
    for name, kw in cases:
        ci = kw.pop("ci")
        pack = kw.get("response_pack")
        phot, shape, spec = problem(ci, **kw)
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
        drel = dabs / np.maximum(np.abs(want[m]), 1e-30)
        rtol, atol = ((K1_ALPHA0_RTOL, K1_ALPHA0_ATOL) if "alpha" in name
                      else (K1_RTOL, K1_ATOL))
        ok = np.all(dabs <= atol + rtol * np.abs(want[m]))
        log(f"[2] K1 {name}: {m.sum()} in box, {(~m).sum()} floored; "
            f"max |d| {dabs.max():.3g}, max rel {drel.max():.3g} "
            f"(rtol {rtol:g}, atol {atol:g}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with plain torch")
        worst = max(worst, float(dabs.max()))
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
    import numpy as np
    import torch
    from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
    from mbb_emcee_tpu_torch.sampler import stretch_run_plain

    phot, shape, spec = problem(2)
    samp = FusedSampler(NWALKERS, phot, shape, spec, rng="external",
                        device=DEVICE)
    p0 = _ball(samp.free_space, NWALKERS, 2, DEVICE)
    state = samp.init_state(p0, seed=3)
    nrec, thin = 3, 2
    u = np.random.default_rng(11).uniform(
        0.001, 0.999, (nrec, 6 * thin, samp.half)).astype(np.float32)
    u = torch.as_tensor(u, device=DEVICE)
    got = samp.run_mcmc(state, nrec * thin, thin, uniforms=u)
    want = stretch_run_plain(state, samp.ops.plain, nrec, thin, samp.a, u)
    return _compare_runs("3", got, want)


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


def port_fit(ci, flux, unc, cov, seed, nburn, nsteps):
    """One port MBBFitter run of parity config `ci`, set up as
    tools/validate_tpu_parity.py's jax_fit sets up the JAX fitter."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBFitter

    cfg = vp.CONFIGS[ci]
    fit = MBBFitter(nwalkers=NWALKERS, seed=seed, opthin=cfg["opthin"],
                    noalpha=cfg["noalpha"], device=DEVICE)
    fit.set_data(vp.WAVE, flux, unc, cov=cov)
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


def phase_main_path():
    """The main path through the user's entry points, with the kernels'
    launch counts taken over exactly this phase. Returns the counts."""
    import numpy as np
    from tools import validate_tpu_parity as vp
    from mbb_emcee_tpu_torch import MBBResults
    from mbb_emcee_tpu_torch import sampler as plain_sampler
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.sampler_kernel import mbb_stretch_run

    with open(vp.SENTINEL_PATH) as fh:
        reference = json.load(fh)["configs"]
    geom = vp.SENTINEL
    mbb_lnprob.launches = 0
    mbb_stretch_run.launches = 0
    plain_sampler.stretch_run_plain.runs = 0
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
    counts = {"mbb_lnprob": mbb_lnprob.launches,
              "mbb_stretch_run": mbb_stretch_run.launches,
              "plain_sampler_runs": plain_sampler.stretch_run_plain.runs}
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


def _host_s(fn):
    """Seconds of fn() on the host clock, synchronized on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


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
    log(f"[6] K2 run, 250 walkers x 200 steps: kernel {out['k2_ms']:.3f} "
        f"ms, plain torch {out['k2_plain_ms']:.1f} ms ({card})")
    log(f"[6] kernel sampler: 1000 steps {t1 * 1e3:.2f} ms, 3000 steps "
        f"{t3 * 1e3:.2f} ms -> marginal {rate:,.0f} walker-steps/s "
        f"({card})")
    log(f"[6] plain torch sampler: {rate_plain:,.0f} walker-steps/s over "
        f"200 steps ({card})")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    use_repo_tests_package()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    phase_device()
    phase_build()
    k1_err = phase_k1()
    k2_err = phase_k2()
    phase_determinism()
    counts = phase_main_path()
    t = phase_time(card)
    kernels = [
        {"name": "mbb_lnprob", "route": "cuda",
         "source": "mbb_emcee_tpu_torch/csrc/lnprob.cu",
         "replaces": "mbb_emcee_tpu/ops/pallas_lnprob.py:248",
         "launches": counts["mbb_lnprob"], "max_abs_err": k1_err,
         "ms": t["k1_ms"], "plain_ms": t["k1_plain_ms"]},
        {"name": "mbb_stretch_run", "route": "cuda",
         "source": "mbb_emcee_tpu_torch/csrc/sampler.cu",
         "replaces": "mbb_emcee_tpu/ops/pallas_sampler.py:63",
         "launches": counts["mbb_stretch_run"], "max_abs_err": k2_err,
         "ms": t["k2_ms"], "plain_ms": t["k2_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
