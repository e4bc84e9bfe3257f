"""The window's host-clock seconds over the whole sweeps it finished."""


def read(ctx):
    n = ctx.work.get("sweeps", 0)
    return ctx.window_s / n if n else None
