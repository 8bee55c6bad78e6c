"""d2h_mb.single: megabytes (1e6 bytes) a single fit copies from the card
to the host, as the program's d2h_bytes counter counts them (the chain and
lnprob MBBResults loads, the best walker, the acceptance fractions), per
request, in the traced window."""

from portbench.program import d2h_mb


def read(ctx):
    return d2h_mb(ctx, "single")
