"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py:15,22,53,57`` and ``repro/kernels/score_topk.py:138``).

Each ``ref_*`` computes the same function as its kernel with tensor ops.
The CPU tests run them against ``repro``; ``chip_smoke.py`` holds each
kernel against them on the card; the wrappers use them for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.rescal import x_times, xt_times
from repro_torch.core.sparse import (BCSR, block_tiles, crop_blocks,
                                     segment_sum, spmm, zeros_product)


def ref_fused_xa_xtb(X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor):
    """(X_t @ B1, X_t^T @ B2_t) as two batched products: X ([r,] m, n1,
    n2), B1 ([r,] n2, k), B2 ([r,] m, n1, k) -> (([r,] m, n1, k),
    ([r,] m, n2, k)).  Reads X twice; the kernel reads it once."""
    return x_times(X, B1), xt_times(X, B2)


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


# score_topk's panel length (repro/kernels/score_topk.py:DEFAULT_PN)
DEFAULT_PN = 2048
_LANE = 128


def effective_pn(n: int, pn: int = DEFAULT_PN) -> int:
    """The panel length shrunk to the 128-aligned cover of n."""
    return max(_LANE, min(pn, -(-n // _LANE) * _LANE))


def _best(scores: torch.Tensor, idx: torch.Tensor, topk: int):
    """The first ``topk`` columns of each row by descending score.  The
    sort is stable, so equal scores keep their column order; callers lay
    candidates out in ascending index order, which gives ties to the
    lowest index (``torch.topk`` does not promise any order among ties)."""
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :topk], torch.gather(idx, 1, pos[:, :topk])


def _pad_topk(s: torch.Tensor, i: torch.Tensor, topk: int):
    """Pad (b, t) results to (b, topk) with (-inf, -1)."""
    short = topk - s.shape[1]
    if short <= 0:
        return s, i
    b = s.shape[0]
    return (torch.cat([s, s.new_full((b, short), -torch.inf)], dim=1),
            torch.cat([i, i.new_full((b, short), -1)], dim=1))


def ref_score_topk(V: torch.Tensor, A: torch.Tensor, topk: int):
    """The materializing oracle of score_topk: the whole (b, n) score
    matrix, then a stable sort.  f32 scores and int32 indices, both
    (b, topk), in descending score, ties to the lowest index, slots past
    n as (-inf, -1).  ``+ 0.0`` makes every zero +0.0, so -0.0 and 0.0
    tie as they do in the kernel's comparisons."""
    scores = V.float() @ A.float().T + 0.0
    idx = torch.arange(A.shape[0], dtype=torch.int32, device=A.device)
    s, i = _best(scores, idx.expand_as(scores), topk)
    return _pad_topk(s, i, topk)


def ref_score_topk_stream(V: torch.Tensor, A: torch.Tensor, topk: int,
                          pn: int = DEFAULT_PN):
    """score_topk without the (b, n) score matrix: (pn, k) row panels of A
    are scored in turn and merged into a running (b, topk) best with a
    stable sort over [running | panel], whose indices ascend among equal
    scores.  The same contract as ``ref_score_topk``."""
    Vf = V.float()
    b, n = V.shape[0], A.shape[0]
    pn = effective_pn(n, pn)
    run_s = torch.full((b, topk), -torch.inf, device=V.device)
    run_i = torch.full((b, topk), -1, dtype=torch.int32, device=V.device)
    for p0 in range(0, n, pn):
        panel = A[p0:p0 + pn].float()
        sp = Vf @ panel.T + 0.0
        gidx = torch.arange(p0, p0 + panel.shape[0], dtype=torch.int32,
                            device=V.device).expand_as(sp)
        run_s, run_i = _best(torch.cat([run_s, sp], dim=1),
                             torch.cat([run_i, gidx], dim=1), topk)
    return run_s, run_i
