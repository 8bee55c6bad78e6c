"""derived_ms.catalog: mean ms of the span around compute_lir,
compute_dustmass and compute_peaklambda and their summaries."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "derived", "catalog")
