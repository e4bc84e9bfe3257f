"""Device milliseconds per MU iteration outside the port's own CUDA
kernels: the k-thin GEMMs, elementwise passes, copies and fills of the
MU algebra."""

# the namespaces of the port's kernels (src/repro_torch/kernels/csrc)
PORT_KERNELS = ("dense::", "bcsr_xa::", "bcsr::", "mu::")


def read(ctx):
    tl = ctx.timeline
    n = ctx.work.get("iterations", 0)
    if n == 0 or not tl.ops:
        return None
    named = tl.op_seconds(lambda name: any(k in name for k in PORT_KERNELS))
    return 1e3 * max(tl.busy_s - named, 0.0) / n
