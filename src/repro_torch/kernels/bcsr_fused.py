"""bcsr_xa_xta — (X_t @ B1, X_t^T @ B2) on a BCSR tensor in one pass, as a
CUDA kernel for Hopper.

Replaces ``src/repro/kernels/bcsr_fused.py:bcsr_xa_xta``, the Pallas
kernel behind every sparse MU iteration (``core/sparse.py:269``, B1 = B2
= A).  Source: ``csrc/bcsr_fused.cu``.

Bound on an H100: memory.  Each stored block is read once for both
products (m * nnzb * bs^2 * 4 bytes per member) at ~4k flop per value,
far below the fp32 ridge at the sweep's ranks; the floor is those bytes
plus the B reads and the two output writes over 3.35 TB/s.  Design:
persistent CTAs take (slice, block-row) units balanced by stored blocks;
a producer thread streams the stored blocks through a ring of shared
memory with bulk copies, and the B tiles beside them; each stored value
is read from shared memory once, into registers that feed both products.
XA accumulates in registers over a block-row and is written once
(deterministic); each block's X^T tile is reduced inside the CTA and
added into XTB with one vector fp32 atomic per four outputs, so XTB is
NOT deterministic run to run at rounding level.  XTB is allocated with
``torch.zeros``, its rows padded to a multiple of 4 columns (the vector
adds) and cropped to k, so block-columns with no stored block stay
exactly zero.

The copies land B in shared memory as it lies in device memory, so the
wrapper hands the kernel B in its layout (``operand_tiles``): slices of
``kc`` columns (4 for k <= 4, else 8; k > 8 runs one pass per slice),
zero-padded, with the 16-byte slots of each (bs, kc) row tile swizzled.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_bcsr_xa_xta``); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import functools

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


def slice_width(k: int) -> int:
    """Columns of B per kernel pass: the kernel's 4- or 8-column build."""
    return 4 if k <= 4 else 8


@functools.lru_cache(maxsize=None)
def _swizzle(slots: int, device: str) -> torch.Tensor:
    s = torch.arange(slots)
    return (s ^ ((s >> 3) & 7)).to(device)


def operand_tiles(B: torch.Tensor, bs: int, n_pad: int,
                  kc: int) -> torch.Tensor:
    """B ([r,] n, k) -> (ceil(k / kc), r or 1, n_pad, kc): the kernel's
    operand layout.  Zero-padded to n_pad rows and to whole slices of kc
    columns, slices outermost; in every (bs, kc) row tile, the 16-byte
    slot s (row * kc / 4 + the row's slot) is stored at s ^ ((s >> 3) &
    7), so that the kernel's shared-memory reads of B hit distinct
    banks."""
    Bm = B if B.dim() == 3 else B.unsqueeze(0)
    members, n, k = Bm.shape
    slices = -(-k // kc)
    padded = Bm.new_zeros((members, n_pad, slices * kc))
    padded[:, :n, :k] = Bm
    slots = bs * kc // 4
    tiles = padded.reshape(members, n_pad // bs, bs, slices, kc) \
        .permute(3, 0, 1, 2, 4).reshape(slices, members, n_pad // bs,
                                         slots, 4)
    tiles = tiles[:, :, :, _swizzle(slots, str(B.device))]
    return tiles.reshape(slices, members, n_pad, kc)


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
    kc = slice_width(call.k)
    B1t = operand_tiles(B1, sp.bs, sp.n_pad, kc)
    B2t = B1t if B2 is B1 else operand_tiles(B2, sp.bs, sp.n_pad, kc)
    b_member_stride = B1t.stride(1) if B1.dim() == 3 else 0
    kt = -(-call.k // 4) * 4       # XTB's rows padded for vector adds
    xa = call.empty()
    xtb = call.empty(zero=True, cols=kt)
    with torch.cuda.device(sp.data.device):
        rc = _build.library().repro_bcsr_xa_xta(
            sp.data.data_ptr(), sp.row_ptr.data_ptr(),
            sp.block_cols.data_ptr(), B1t.data_ptr(), B2t.data_ptr(),
            xa.data_ptr(), xtb.data_ptr(), call.T, sp.m, sp.nblocks,
            sp.nnzb, sp.bs, call.k, kt, kc, call.data_member_stride,
            b_member_stride, B1t.stride(0), call.stream())
    _build.check(rc, "bcsr_xa_xta")
    _launches += 1
    return call.shape_out(xa), call.shape_out(xtb[..., :call.k])
