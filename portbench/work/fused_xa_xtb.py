"""``fused_xa_xtb``'s work on a dense X (m, n1, n2): X_t B1 and X_t^T B2
for every slice.  Inputs X, B1 (n2, k) and B2 (n1, k; the same for
every slice), outputs (m, n1, k) and (m, n2, k)."""
from portbench.work import F32, Work


def call(m: int, n1: int, n2: int, k: int) -> Work:
    flops = 4 * m * n1 * n2 * k
    nbytes = F32 * (m * n1 * n2 + n2 * k + n1 * k + m * n1 * k
                    + m * n2 * k)
    return Work(flops, nbytes)


def per_iteration(config: dict) -> Work:
    """The calls of one MU iteration on the configuration's dense share:
    one over all m slices under the batched schedule, m of one slice
    under the sliced."""
    share, k = config["share"], config["k"]
    m, n = share["m"], share["n_local"]
    if config["schedule"] == "sliced":
        return call(1, n, n, k).times(m)
    return call(m, n, n, k)
