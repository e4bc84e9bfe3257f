"""bcsr_spmm — X_t @ B on a BCSR tensor, as a CUDA kernel for Hopper.

Replaces ``src/repro/kernels/bcsr_spmm.py:bcsr_spmm`` (the Pallas kernel
``sparse_rel_error`` runs, ``core/sparse.py:282``); in the port it also
serves the per-k regression (``sparse_regress_R``).  Source:
``csrc/bcsr_spmm.cu``.

Bound on an H100: memory.  The kernel reads every stored block once
(m * nnzb * bs^2 * 4 bytes per member) and does ~2k flop per value read,
far below the fp32 ridge at the sweep's ranks, so its floor is those bytes
plus the B reads and output writes over 3.35 TB/s.  Design: one CTA per
(slice, block-row) walks the block-row's stored blocks through shared
memory with coalesced 16-byte loads and keeps its output rows in
registers; deterministic, no atomics, no pre-zeroed output.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_bcsr_spmm``); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import BCSR, product_shape

from . import _build
from ._launch import Launch
from .ref import ref_bcsr_spmm

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def bcsr_spmm(sp: BCSR, B: torch.Tensor) -> torch.Tensor:
    """X_t @ B for all t.  sp: BCSR ([r,] m, nnzb, bs, bs); B ([r,] n, k)
    -> ([r,] m, n, k).  Edge cases: nnzb == 0 returns zeros without a
    launch; bs not dividing n pads B and crops the output; empty
    block-rows come out exactly zero (the kernel writes them)."""
    global _launches
    if sp.data.device.type == "cpu" and B.device.type == "cpu":
        return ref_bcsr_spmm(sp, B)
    call = Launch("bcsr_spmm", sp, B)
    if sp.nnzb == 0:
        return torch.zeros(product_shape(sp, B), dtype=B.dtype,
                           device=B.device)
    Bp = call.padded(B)
    out = call.empty()
    with torch.cuda.device(sp.data.device):
        rc = _build.library().repro_bcsr_spmm(
            sp.data.data_ptr(), sp.row_ptr.data_ptr(),
            sp.block_cols.data_ptr(), Bp.data_ptr(), out.data_ptr(),
            call.T, sp.m, sp.nblocks, sp.nnzb, sp.bs, call.k,
            call.data_member_stride, call.b_member_stride, call.stream())
    _build.check(rc, "bcsr_spmm")
    _launches += 1
    return call.shape_out(out)
