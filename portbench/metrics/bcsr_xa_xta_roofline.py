"""``bcsr_xa_xta``'s share of its roofline: the least time of its calls
in the window's MU iterations (``portbench/work/bcsr_xa_xta.py``) over
the device time of its two kernels (the block pass and the ordered sum
of the X^T B partials), by name in the trace.  A call may launch its
kernels more than once (twice at k = 10 > 8)."""
from portbench.work import bcsr_xa_xta

KERNELS = ("bcsr_xa::xa_xta_kernel", "bcsr_xa::xtb_reduce_kernel")


def read(ctx):
    n = ctx.work.get("iterations", 0)
    seconds = ctx.timeline.op_seconds(
        lambda name: any(k in name for k in KERNELS))
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * bcsr_xa_xta.per_iteration(ctx.config).bound_s \
        / seconds
