"""results_idle_ms.catalog: ms a catalog request leaves the card idle
while the host is inside BatchEngine.par_cen's mbb.results.percentiles
spans, per request, in the traced window."""

from portbench.program import idle_ms


def read(ctx):
    return idle_ms(ctx, "catalog", "results")
