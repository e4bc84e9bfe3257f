"""Work counts from shapes: the yardstick of every roofline share.

Each count is the work the computation needs, worked out from its shapes
alone: the floating-point operations of the products, each input byte
read once and each output byte written once.  Nothing here asks the
program what it did, so no change to the program can move a
denominator.  Peaks are the published ones of one NVIDIA H100 SXM:
float32 outside the tensor cores and HBM3 bandwidth.  A run records the
card's power limit beside them.

The MU iteration (paper Alg. 3, one rank's block, rank k, m slices of
``nnz`` stored values each) counts the products whose size grows with
the entity count n:

    per slice   X_t A and X_t^T A           2 * 2 * nnz * k
                A^T (X_t A)                 2 * n * k^2
                (X_t A) R_t^T, (X_t^T A) R_t  2 * 2 * n * k^2
    once        A^T A, A S                  2 * 2 * n * k^2

and moves the operand's values (and a sparse operand's block
coordinates) once, A in once and out once, R in once and out once.
The k-by-k work of the R update and of S is left out: it does not grow
with n.

Each kernel's count sits in a file of its own, ``work/<kernel>.py``,
with ``per_iteration(config)``: the work of its calls in one MU
iteration of the configuration's share.
"""
from __future__ import annotations

import dataclasses

PEAK_FP32_FLOP_PER_S = 67e12      # H100 SXM, float32 without tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12    # H100 SXM, HBM3
F32 = 4
I32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    @property
    def bound_s(self) -> float:
        """The least time the chip could take: the larger of the
        operations at the float32 peak and the bytes at HBM bandwidth."""
        return max(self.flops / PEAK_FP32_FLOP_PER_S,
                   self.bytes / PEAK_HBM_BYTES_PER_S)

    def times(self, calls: int) -> "Work":
        return Work(calls * self.flops, calls * self.bytes)

    @property
    def bound_by(self) -> str:
        return ("operations" if self.flops / PEAK_FP32_FLOP_PER_S
                >= self.bytes / PEAK_HBM_BYTES_PER_S else "bytes")


def slice_values(share: dict) -> int:
    """Stored values of one relation slice of the share: n_local^2 for a
    dense block, nnzb * bs^2 for a BCSR shard."""
    if share["operand"] == "dense":
        return share["n_local"] ** 2
    return share["nnzb"] * share["bs"] ** 2


def pattern_bytes(share: dict) -> int:
    """A BCSR shard's block coordinates (block_rows and block_cols,
    int32); nothing for a dense block."""
    return 0 if share["operand"] == "dense" else 2 * I32 * share["nnzb"]


def mu_iteration(share: dict, k: int) -> Work:
    """One MU iteration of the share at rank k (the module docstring)."""
    m, n, nnz = share["m"], share["n_local"], slice_values(share)
    flops = m * (4 * nnz * k + 6 * n * k * k) + 4 * n * k * k
    nbytes = (F32 * m * nnz + pattern_bytes(share)
              + 2 * F32 * n * k + 2 * F32 * m * k * k)
    return Work(flops, nbytes)
