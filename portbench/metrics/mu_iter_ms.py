"""The window's host-clock milliseconds, ended by a synchronize, over the
MU iterations it finished."""


def read(ctx):
    n = ctx.work.get("iterations", 0)
    return 1e3 * ctx.window_s / n if n else None
