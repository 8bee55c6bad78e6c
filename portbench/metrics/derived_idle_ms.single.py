"""derived_idle_ms.single: ms a single fit leaves the card idle while the
host is inside the derived posteriors' spans (mbb.derived.*: MBBResults'
compute_* with their distances and sample chunks, and each *_cen
summary), per request, in the traced window of a cell whose traffic asks
for them."""

from portbench.program import idle_ms


def read(ctx):
    if not ctx.traffic["derived"]:
        return None
    return idle_ms(ctx, "single", "derived posteriors")
