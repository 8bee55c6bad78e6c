"""d2h_mb.catalog: megabytes (1e6 bytes) a catalog request copies from the
card to the host, as the program's d2h_bytes counter counts them (each
derived-posterior chunk, par_cen's percentiles, the best walkers, the
acceptance fractions), per request, in the traced window."""

from portbench.program import d2h_mb


def read(ctx):
    return d2h_mb(ctx, "catalog")
