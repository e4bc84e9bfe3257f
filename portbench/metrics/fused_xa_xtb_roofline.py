"""``fused_xa_xtb``'s share of its roofline: the least time of its calls
in the window's MU iterations (``portbench/work/fused_xa_xtb.py``) over
the device time of its kernels (operand split, main pass, partial sums),
by name in the trace."""
from portbench.work import fused_xa_xtb

KERNELS = ("dense::fused_kernel", "dense::split_operands",
           "dense::reduce_parts")


def read(ctx):
    n = ctx.work.get("iterations", 0)
    seconds = ctx.timeline.op_seconds(
        lambda name: any(k in name for k in KERNELS))
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * fused_xa_xtb.per_iteration(ctx.config).bound_s \
        / seconds
