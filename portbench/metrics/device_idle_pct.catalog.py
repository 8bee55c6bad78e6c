"""device_idle_pct.catalog: 100 x (1 - the union of device activity / the
traced window), averaged over every card the catalog cell holds."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "catalog")
