"""Seconds from the process's start to the first timed iteration:
imports, the CUDA context, the grid, the kernel library, the inputs from
the seed and the warm-up."""


def read(ctx):
    return ctx.setup_s
