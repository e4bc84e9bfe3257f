"""The CUDA allocator's peak over the measured window (reset at its
start), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9
