"""k2_roofline_pct: the frozen k2_bound of every request's K2 launches
over K2's device time in the traced window (torch.profiler)."""

from portbench.readers import K2_KERNEL, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "single", K2_KERNEL)
