"""What the metric readers (metrics/<name>.py) share. A reader gets the
run's context (harness.py: the cell, its configuration and traffic, the
window's requests with their spans, the window's length, the set-up time,
and in the traced run the device timeline) and returns a number, or None
when the run holds nothing for it to read.
"""

from __future__ import annotations

import numpy as np

from portbench import yardstick

# The sampler kernels as the profiler names them (csrc/sampler.cu,
# csrc/multifit.cu).
K2_KERNEL = "mbb_stretch_kernel"
K3_KERNEL = "mbb_multi_stretch_kernel"


def span_mean_ms(ctx, name, fitter):
    """Mean milliseconds of the harness's `name` span over the window's
    requests, in a cell of the given fitter kind."""
    if ctx.cfg["fitter"] != fitter:
        return None
    d = [b - a for r in ctx.requests for n, a, b in r.spans if n == name]
    return float(np.mean(d)) * 1e3 if d else None


def idle_pct(ctx, fitter):
    """100 x (1 - busy / window), averaged over the cell's cards."""
    tl = ctx.timeline
    if tl is None or ctx.cfg["fitter"] != fitter:
        return None
    busy = np.mean([tl.busy_s(c) for c in ctx.cards])
    return 100.0 * (1.0 - busy / tl.window_s)


def _nnodes(cfg):
    """Quadrature nodes a band: the filter responses' count, or 1 for point
    bands."""
    return int(cfg.get("responses", {}).get("nnodes", 1))


def _icfg(cfg):
    """The likelihood configuration lnprob_ops counts: point bands, or
    each band's filter curve at its node count."""
    m = cfg["model"]
    return (int(m["opthin"]), int(m["noalpha"]), 0, len(cfg["wave"]),
            _nnodes(cfg))


def request_bound_ms(cfg, traffic, nsrc):
    """The least device time of one request's sampler launches on nsrc
    sources: the burn (every step recorded by a single fit's run_mcmc,
    none by the batch tier's advance), the re-burn, and production at its
    thin, each by the frozen k2_bound."""
    nb, nw = len(cfg["wave"]), int(cfg["nwalkers"])
    nfree = 5 - int(cfg["model"]["opthin"]) - int(cfg["model"]["noalpha"])
    nburn, nsteps = int(traffic["nburn"]), int(traffic["nsteps"])
    nconsts = 20 + 2 * nb * nsrc        # box, priors, and each band's data
    if _nnodes(cfg) > 1:                # the curves' nodes and weights
        nconsts += 2 * nb * _nnodes(cfg)
    burn_rec = nburn if cfg["fitter"] == "single" else 1
    phases = [(nburn, burn_rec), (nburn, 1),
              (nsteps, nsteps // int(traffic["thin"]))]
    return sum(yardstick.k2_bound(_icfg(cfg), nsrc, nw, nfree, nconsts,
                                  steps, nrec)[0]
               for steps, nrec in phases if steps > 0)


def roofline_pct(ctx, fitter, needle):
    """100 x the sampler kernel's least time over its device time in the
    window, per card over that card's own sources, averaged over cards."""
    tl = ctx.timeline
    if tl is None or ctx.cfg["fitter"] != fitter:
        return None
    done = sum(1 for r in ctx.requests if r.error is None)
    nsrc = int(ctx.cfg["nsources"]) // len(ctx.cards)
    least = done * request_bound_ms(ctx.cfg, ctx.traffic, nsrc) * 1e-3
    shares = []
    for c in ctx.cards:
        t = tl.kernel_s(c, needle)
        if t <= 0.0:
            return None
        shares.append(100.0 * least / t)
    return float(np.mean(shares))
