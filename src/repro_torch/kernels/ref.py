"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py:22,53``).

Each ``ref_*`` computes the same function as its kernel with tensor ops.
The CPU tests run them against ``repro``; ``chip_smoke.py`` holds each
kernel against them on the card; the wrappers use them for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import (BCSR, block_tiles, crop_blocks,
                                     segment_sum, spmm, zeros_product)


def ref_bcsr_xa_xta(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor):
    """(X @ B1, X^T @ B2) for shared ([r,] n, k) operands: both tile
    products from one read of the stored blocks, reduced by ONE combined
    segment sum (XA segments = block_rows, XTB segments = block_cols
    offset by nb)."""
    if sp.nnzb == 0:
        z = zeros_product(sp, B1)
        return z, z.clone()
    nb = sp.nblocks
    prod = torch.cat(
        [sp.data @ block_tiles(sp, B1, sp.block_cols),
         sp.data.transpose(-1, -2) @ block_tiles(sp, B2, sp.block_rows)],
        dim=-3)
    segs = torch.cat([sp.block_rows, sp.block_cols + nb])
    out = segment_sum(prod, segs, 2 * nb)          # (..., m, 2nb, bs, k)
    return (crop_blocks(out[..., :nb, :, :], sp.n),
            crop_blocks(out[..., nb:, :, :], sp.n))


def ref_bcsr_spmm(sp: BCSR, B: torch.Tensor) -> torch.Tensor:
    """X @ B for all t: the plain segment sum of core/sparse.py."""
    return spmm(sp, B)
