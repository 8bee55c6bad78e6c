"""run_ms.single: mean ms of the span around MBBFitter.run (the fit
protocol with its K1 and K2 calls)."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "run", "single")
