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
XA accumulates in registers over a block-row and is written once; each
block's X^T tile is reduced inside the CTA and stored to a workspace
(T, nnzb, bs, kc), and a second kernel sums each block-column's tiles in
block-row order (the transposed index ``BCSR.col_index``, built once per
pattern on the card) into XTB, zeros for a block-column with no stored
block.  Both outputs are bit-identical from call to call.  XTB's rows are
padded to a multiple of 4 columns (the vector stores) and cropped to k.

The copies land B in shared memory as it lies in device memory, so the
kernel takes B in its layout (``operand_tiles``): slices of ``kc``
columns (4 for k <= 4, else 8; k > 8 runs one pass per slice),
zero-padded, with the 16-byte slots of each (bs, kc) row tile swizzled.
A call tiles B1 and B2 itself, unless it is handed ``Operands`` that
``prepare`` built once for several calls on the same B: the sliced MU
body's m calls of an iteration, whose A^(j) and A^(i) do not change
between slices.  ``tiling_count`` counts the tilings made.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_bcsr_xa_xta``); on a CUDA tensor it launches the
kernel or raises; on meta tensors it runs up to the launch and returns
outputs of the right shapes (``launch.step_costs``: each of the three
counts the launch's ``cost`` and the wrapper's own aten work).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.sparse import BCSR, product_shape
from repro_torch.launch import step_costs

from . import _build
from ._launch import Launch, members
from .ref import ref_bcsr_xa_xta

_launches = 0
_tilings = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def tiling_count() -> int:
    """Operand tilings made in this process: one per distinct B that a
    call without ``Operands``, or a ``prepare``, lays out.  On a CPU
    operand, where the plain version stands in and tiles nothing, the
    tilings the card would make; none on meta tensors."""
    return _tilings


def _count_tilings(B1: torch.Tensor, B2: torch.Tensor) -> None:
    global _tilings
    _tilings += 1 if B2 is B1 else 2


def slice_width(k: int) -> int:
    """Columns of B per kernel pass: the kernel's 4- or 8-column build."""
    return 4 if k <= 4 else 8


@functools.lru_cache(maxsize=None)
def _swizzle(slots: int, device: str) -> torch.Tensor:
    with step_costs.uncounted():         # built once per device
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


@dataclasses.dataclass(frozen=True, eq=False)
class Operands:
    """B1 and B2 in the kernel's layout, with the tensors and the blocking
    they were made from: ``prepare``'s result, for the ``bcsr_xa_xta``
    calls that share them.  On a CPU operand the plain version reads B as
    it is, and the tiles are None."""
    B1: torch.Tensor
    B2: torch.Tensor
    bs: int
    n_pad: int
    kc: int
    B1t: torch.Tensor | None
    B2t: torch.Tensor | None     # B1t itself when B2 is B1

    @property
    def b_member_stride(self) -> int:
        """Floats between the members of a tile slice, 0 without a member
        axis."""
        return self.B1t.stride(1) if self.B1.dim() == 3 else 0

    def check(self, sp: BCSR, B1: torch.Tensor, B2: torch.Tensor) -> None:
        """Raises ``ValueError`` unless these were made from B1 and B2
        themselves (identity, not values) for ``sp``'s blocking."""
        if self.B1 is not B1 or self.B2 is not B2:
            raise ValueError("bcsr_xa_xta: the operands were prepared from "
                             "other B tensors")
        if (self.bs, self.n_pad) != (sp.bs, sp.n_pad):
            raise ValueError(f"bcsr_xa_xta: the operands were prepared for "
                             f"bs={self.bs}, n_pad={self.n_pad}, not "
                             f"bs={sp.bs}, n_pad={sp.n_pad}")


def _tile(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor) -> Operands:
    """The card's tiling of B1 and of B2 (B1's tiles when B2 is B1)."""
    kc = slice_width(B1.shape[-1])
    B1t = operand_tiles(B1, sp.bs, sp.n_pad, kc)
    B2t = B1t if B2 is B1 else operand_tiles(B2, sp.bs, sp.n_pad, kc)
    if not B1.is_meta:
        _count_tilings(B1, B2)
    return Operands(B1, B2, sp.bs, sp.n_pad, kc, B1t, B2t)


def plain_operands(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor
                   ) -> Operands:
    """``prepare`` on a CPU operand: no tiles, since the plain version
    reads B as it is; counted as the card's tilings."""
    _count_tilings(B1, B2)
    return Operands(B1, B2, sp.bs, sp.n_pad, slice_width(B1.shape[-1]),
                    None, None)


def prepare(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor) -> Operands:
    """B1 and B2 ([r,] n, k) tiled once for every ``bcsr_xa_xta`` call
    on ``sp``'s blocking (any of its relation slices) that takes these
    same two tensors.  Checked as a call is; on a CPU operand the plain
    ``plain_operands`` stands in (``step_costs.as_card``)."""
    if all(x.device.type == "cpu" for x in (sp.data, B1, B2)):
        return step_costs.as_card(prepare, plain_operands, sp, B1, B2)
    Launch("bcsr_xa_xta", sp, B1, B2)
    return _tile(sp, B1, B2)


def cost(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor) -> tuple[int, int]:
    """(flops, bytes) of one call's own work: every stored value read once
    for both products, 4k flop per value and slice of each member; B1 and
    B2 read once, XA and XTB written once."""
    k = B1.shape[-1]
    T = members(sp.batch_shape, B1.shape[:-2]) * sp.m
    flops = T * sp.nnzb * sp.bs * sp.bs * 4 * k
    nbytes = 4 * (sp.data.numel() + B1.numel() + B2.numel()
                  + 2 * T * sp.n * k)
    return flops, nbytes


def bcsr_xa_xta(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor, *,
                operands: Operands | None = None):
    """sp: BCSR ([r,] m, nnzb, bs, bs) with row-major blocks; B1, B2
    ([r,] n, k) -> (X @ B1, X^T @ B2), each ([r,] m, n, k), in one pass
    over the stored blocks.  ``operands``: B1 and B2 already tiled
    (``prepare``), else the call tiles them.  nnzb == 0 returns zeros
    without a launch; bs not dividing n pads the operands and crops the
    outputs."""
    global _launches
    if operands is not None:
        operands.check(sp, B1, B2)
    if all(x.device.type == "cpu" for x in (sp.data, B1, B2)):
        if operands is None and sp.nnzb:
            _count_tilings(B1, B2)
        return step_costs.as_card(bcsr_xa_xta, ref_bcsr_xa_xta, sp, B1, B2,
                                  operands=operands)
    call = Launch("bcsr_xa_xta", sp, B1, B2)
    if sp.nnzb == 0:
        shape = product_shape(sp, B1)
        return (torch.zeros(shape, dtype=B1.dtype, device=B1.device),
                torch.zeros(shape, dtype=B1.dtype, device=B1.device))
    tiled = _tile(sp, B1, B2) if operands is None else operands
    kc = tiled.kc
    kt = -(-call.k // 4) * 4       # XTB's rows padded for vector stores
    xa = call.empty()
    xtb = call.empty(cols=kt)
    part = torch.empty(call.T * sp.nnzb * sp.bs * kc, dtype=torch.float32,
                       device=sp.data.device)
    with step_costs.uncounted():         # built once per pattern
        col_ptr, col_z = sp.col_index()
    if call.meta:
        step_costs.launched("bcsr_xa_xta", cost, sp, B1, B2)
        return call.shape_out(xa), call.shape_out(xtb[..., :call.k])
    with torch.cuda.device(sp.data.device):
        rc = _build.library().repro_bcsr_xa_xta(
            sp.data.data_ptr(), sp.row_ptr.data_ptr(),
            sp.block_cols.data_ptr(), col_ptr.data_ptr(), col_z.data_ptr(),
            tiled.B1t.data_ptr(), tiled.B2t.data_ptr(), xa.data_ptr(),
            xtb.data_ptr(), part.data_ptr(), call.T, sp.m, sp.nblocks,
            sp.nnzb, sp.bs, call.k, kt, kc, call.data_member_stride,
            tiled.b_member_stride, tiled.B1t.stride(0), call.stream())
    _build.check(rc, "bcsr_xa_xta")
    _launches += 1
    step_costs.launched("bcsr_xa_xta", cost, sp, B1, B2)
    return call.shape_out(xa), call.shape_out(xtb[..., :call.k])
