"""derived_idle_ms.catalog: ms a catalog request leaves the card idle while
the host is inside the derived posteriors' spans (mbb.derived.*: each
compute_* with its distances and sample chunks, and each *_cen summary),
per request, in the traced window of a cell whose traffic asks for them."""

from portbench.program import idle_ms


def read(ctx):
    if not ctx.traffic["derived"]:
        return None
    return idle_ms(ctx, "catalog", "derived posteriors")
