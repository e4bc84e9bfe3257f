"""Share of the traced window in which no operation ran on the device."""


def read(ctx):
    tl = ctx.timeline
    if not tl.ops or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
