"""walker_steps_per_s: the walker-steps of every completed request (burn,
re-burn and production, x walkers x sources) over the whole window."""


def read(ctx):
    return sum(r.walker_steps for r in ctx.requests) / ctx.window_s
