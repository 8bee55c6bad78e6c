"""k3_roofline_pct: the frozen k2_bound of every request's K3 launches
with nsrc sources over K3's device time in the traced window."""

from portbench.readers import K3_KERNEL, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "catalog", K3_KERNEL)
