"""walker_steps_per_s.single: walker_steps_per_s of a single-fit cell read
per layer, in its traced window: the walker-steps of every completed
request over the whole window. It stands beside fit_ms_p95 in a cell
whose host-bound requests make the rate swing with the host's speed from
run to run by more than an end-to-end bound holds (single_cli_derived)."""


def read(ctx):
    if ctx.cfg["fitter"] != "single":
        return None
    return sum(r.walker_steps for r in ctx.requests) / ctx.window_s
