"""protocol_idle_ms.single: ms a single fit leaves the card idle while the
host is inside the fit protocol's spans (mbb.fit.*: set_data, run and its
ball, burn, re-centre, re-burn, reset, production and record steps), per
request, in the traced window."""

from portbench.program import idle_ms


def read(ctx):
    return idle_ms(ctx, "single", "fit protocol")
