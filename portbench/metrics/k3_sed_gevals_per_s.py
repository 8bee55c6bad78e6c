"""k3_sed_gevals_per_s: the SED evaluations K3 computed in the traced
window, as the program's sed_evals counter counts them on its
mbb.kernel.k3 spans (steps x walkers x bands x nodes a band x sources: 1
node for point bands, the filter curve's quadrature nodes in response
mode), over K3's device time, in 1e9 a second. A program without the
counter has nothing to read."""

from portbench import program
from portbench.readers import K3_KERNEL


def read(ctx):
    tl = ctx.timeline
    if tl is None or ctx.cfg["fitter"] != "catalog":
        return None
    spans = program.recorded() or []
    evals = [s.counters["sed_evals"] for s in spans
             if s.name == "mbb.kernel.k3" and "sed_evals" in s.counters]
    seconds = sum(tl.kernel_s(c, K3_KERNEL) for c in ctx.cards)
    if not evals or seconds <= 0.0:
        return None
    return sum(evals) / seconds * 1e-9
