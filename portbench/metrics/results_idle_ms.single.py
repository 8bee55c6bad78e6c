"""results_idle_ms.single: ms a single fit leaves the card idle while the
host is inside the results layer's spans (mbb.results.load: MBBResults'
copy of the chain to the host; mbb.results.percentiles: par_cen), per
request, in the traced window."""

from portbench.program import idle_ms


def read(ctx):
    return idle_ms(ctx, "single", "results")
