"""The whole MU iteration's share of the chip's peak: the iteration's
least time from ``portbench.work`` (the larger of its operations at the
float32 peak and its bytes at HBM bandwidth) over the device's busy time
per iteration in the trace.  Busy time, not the traced window: under the
profiler the dense loop's host falls behind the card on some machines,
and the idle that opens is the profiler's; the untraced loop's own
stalls show in ``mu_iter_ms``."""
from portbench import work


def read(ctx):
    n = ctx.work.get("iterations", 0)
    busy = ctx.timeline.busy_s
    if n == 0 or busy <= 0:
        return None
    return 100.0 * n * work.mu_iteration(ctx.share, ctx.k).bound_s / busy
