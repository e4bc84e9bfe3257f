"""bcsr_xa_xta — (X_t @ B1, X_t^T @ B2) on a BCSR tensor in one pass, as a
CUDA kernel for Hopper.

Replaces ``src/repro/kernels/bcsr_fused.py:bcsr_xa_xta``, the Pallas
kernel behind every sparse MU iteration (``core/sparse.py:207``, B1 = B2
= A).  Source: ``csrc/bcsr_fused.cu``.

Bound on an H100: memory.  Each stored block is read once for both
products (m * nnzb * bs^2 * 4 bytes per member) at ~4k flop per value,
far below the fp32 ridge at the sweep's ranks; the floor is those bytes
plus the B reads and the two output writes over 3.35 TB/s.  Design: one
CTA per (slice, block-row); XA accumulates in registers and is written
once (deterministic); each block's X^T tile is reduced across the CTA's
warps in shared memory and added into XTB with fp32 ``atomicAdd``, so XTB
is NOT deterministic run to run at rounding level.  XTB is allocated with
``torch.zeros``, so block-columns with no stored block stay exactly zero.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_bcsr_xa_xta``); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import BCSR, product_shape

from . import _build
from ._launch import Launch
from .ref import ref_bcsr_xa_xta

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def bcsr_xa_xta(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor):
    """sp: BCSR ([r,] m, nnzb, bs, bs) with row-major blocks; B1, B2
    ([r,] n, k) -> (X @ B1, X^T @ B2), each ([r,] m, n, k), in one pass
    over the stored blocks.  nnzb == 0 returns zeros without a launch;
    bs not dividing n pads the operands and crops the outputs."""
    global _launches
    if all(x.device.type == "cpu" for x in (sp.data, B1, B2)):
        return ref_bcsr_xa_xta(sp, B1, B2)
    call = Launch("bcsr_xa_xta", sp, B1, B2)
    if sp.nnzb == 0:
        shape = product_shape(sp, B1)
        return (torch.zeros(shape, dtype=B1.dtype, device=B1.device),
                torch.zeros(shape, dtype=B1.dtype, device=B1.device))
    B1p, B2p = call.padded(B1), call.padded(B2)
    xa = call.empty()
    xtb = call.empty(zero=True)
    with torch.cuda.device(sp.data.device):
        rc = _build.library().repro_bcsr_xa_xta(
            sp.data.data_ptr(), sp.row_ptr.data_ptr(),
            sp.block_cols.data_ptr(), B1p.data_ptr(), B2p.data_ptr(),
            xa.data_ptr(), xtb.data_ptr(), call.T, sp.m, sp.nblocks,
            sp.nnzb, sp.bs, call.k, call.data_member_stride,
            call.b_member_stride, call.stream())
    _build.check(rc, "bcsr_xa_xta")
    _launches += 1
    return call.shape_out(xa), call.shape_out(xtb)
