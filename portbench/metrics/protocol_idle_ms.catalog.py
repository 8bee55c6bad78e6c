"""protocol_idle_ms.catalog: ms a catalog request leaves the card idle
while the host is inside the fit protocol's spans (mbb.fit.*, under
MultiFitter.set_data and BatchEngine.run), per request, in the traced
window."""

from portbench.program import idle_ms


def read(ctx):
    return idle_ms(ctx, "catalog", "fit protocol")
