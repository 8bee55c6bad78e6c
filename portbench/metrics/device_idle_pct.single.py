"""device_idle_pct.single: 100 x (1 - the union of device activity / the
traced window) in a single-fit cell."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "single")
