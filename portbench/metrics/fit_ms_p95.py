"""fit_ms_p95: the 95th percentile of the wall-clock of every single-fit
request in the window, data in to summaries out (a failed request counts
with the time it took)."""

import numpy as np


def read(ctx):
    if ctx.cfg["fitter"] != "single":
        return None
    return float(np.percentile([r.latency_s for r in ctx.requests], 95)
                 ) * 1e3
