"""run_ms.catalog: mean ms of the span around MultiFitter.run
(BatchEngine.run)."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "run", "catalog")
