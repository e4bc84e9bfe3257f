"""``bcsr_xa_xta``'s work on m slices of nnzb stored (bs, bs) blocks over
n entities: X_t B1 and X_t^T B2.  Inputs the blocks, their coordinates,
B1 and B2 (n, k); outputs two (m, n, k)."""
from portbench.work import F32, I32, Work


def call(m: int, nnzb: int, bs: int, n: int, k: int) -> Work:
    flops = 4 * m * nnzb * bs * bs * k
    nbytes = (F32 * m * nnzb * bs * bs + 2 * I32 * nnzb
              + F32 * (2 * n * k + 2 * m * n * k))
    return Work(flops, nbytes)


def per_iteration(config: dict) -> Work:
    """The calls of one MU iteration on the configuration's BCSR share:
    one over all m slices under the batched schedule, m of one slice
    under the sliced."""
    share, k = config["share"], config["k"]
    m, n = share["m"], share["n_local"]
    nnzb, bs = share["nnzb"], share["bs"]
    if config["schedule"] == "sliced":
        return call(1, nnzb, bs, n, k).times(m)
    return call(m, nnzb, bs, n, k)
