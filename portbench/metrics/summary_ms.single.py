"""summary_ms.single: mean ms of the span around MBBResults and par_cen of
every parameter."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "summary", "single")
