"""setup_s: process start to the first timed request (imports, CUDA
context, the kernel library, one warm-up request of the cell's shape)."""


def read(ctx):
    return ctx.setup_s
