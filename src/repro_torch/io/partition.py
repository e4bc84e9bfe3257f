"""COO to BCSR: one global tensor, or balanced shards on the (g, g) grid
(port of ``repro/io/partition.py``).

  1. blockify: COO coordinates -> (bs, bs) block ids, the pattern shared
     across the m relation slices (``coo_to_bcsr``, one global BCSR);
  2. balance: a greedy assignment of block-slabs (a block-row and its
     mirror block-column: rows and columns are the same entities, so one
     permutation serves both) to the g grid rows, weighted by stored-block
     counts (``balanced_partition``), or the contiguous assignment
     (``identity_partition``) the virtual generators use;
  3. shard: every (i, j) shard's blocks in shard-local coordinates,
     row-major, front-padded with zero blocks at (0, 0) to a common
     ``z_max``, stacked into the (g, g, m, z_max, bs, bs) operand of
     ``ShardedBCSR`` (``partition_coo``, ``partition_dense``).

The index work is ``repro``'s, byte for byte, in numpy on the host: the
block keys, the greedy balance, the padding and the order within a shard.
The stored values are scattered on the device (``index_put_`` with
``accumulate``); the host never holds the stored blocks.  A factorization
of the sharded tensor lives in the permuted entity space:
``BlockPartition.permute_factor`` / ``unpermute_factor`` translate factors
in and out (X_perm = P X P^T, A_perm = P A).  Traced as
``ingest/blockify``, ``ingest/balance`` and ``ingest/shard`` spans.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.sparse import BCSR, cdiv
from repro_torch.core.sparse import to_dense as bcsr_to_dense
from repro_torch.dist.elastic import choose_grid
from repro_torch.obs import trace as obs

from .triples import COOTensor

__all__ = ["BlockPartition", "CellShard", "ShardedBCSR", "balanced_partition",
           "choose_grid", "coo_to_bcsr", "identity_partition",
           "partition_coo", "partition_dense"]


def _index(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def coo_to_bcsr(coo: COOTensor, bs: int = 128, *, device=None) -> BCSR:
    """COO -> one BCSR in the original entity order, built on ``device``
    (default ``cuda``).  Blocks are row-major sorted; the pattern is the
    union over relation slices.  The block pattern is found on the host;
    the values are scattered into the (m, nnzb, bs, bs) data on the
    device, so the host never holds the stored blocks.  Memory is
    O(nnzb * bs^2), never O(n^2)."""
    dev = _device.resolve(device)
    with obs.span("ingest/blockify", n=coo.n, bs=bs):
        nb = cdiv(coo.n, bs)
        brow = coo.rows // bs
        bcol = coo.cols // bs
        ukeys, z = np.unique(brow * nb + bcol, return_inverse=True)
        nnzb = ukeys.shape[0]
        data = torch.zeros((coo.m, nnzb, bs, bs), dtype=torch.float32,
                           device=dev)
        flat = (((coo.rels * nnzb + z) * bs + coo.rows % bs) * bs
                + coo.cols % bs)
        data.view(-1).index_put_((_index(flat, dev),),
                                 torch.from_numpy(coo.vals).to(dev),
                                 accumulate=True)
        return BCSR(data=data,
                    block_rows=_index((ukeys // nb).astype(np.int32), dev),
                    block_cols=_index((ukeys % nb).astype(np.int32), dev),
                    n=coo.n)


# ---------------------------------------------------------------------------
# The block-slab partition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """Block-granular entity permutation onto a (g, g) grid.

    ``perm[slot] = global block id`` (-1 for padding slots); ``pos`` is its
    inverse.  Grid row i owns slots [i * nb_loc, (i+1) * nb_loc); the same
    assignment serves the column axis (square grid, one entity
    permutation)."""
    n: int                    # logical entities
    bs: int
    grid: int                 # g (square)
    nb: int                   # real blocks = ceil(n / bs)
    nb_loc: int               # block slots per grid row
    perm: np.ndarray          # (g * nb_loc,) int64, -1 = padding slot
    pos: np.ndarray           # (nb,) int64 slot of each global block

    @property
    def n_loc(self) -> int:
        return self.nb_loc * self.bs

    @property
    def n_pad(self) -> int:
        return self.grid * self.n_loc

    def owner(self, block: np.ndarray) -> np.ndarray:
        """Grid row owning each global block id."""
        return self.pos[block] // self.nb_loc

    def local(self, block: np.ndarray) -> np.ndarray:
        """Block index within the owner's slab."""
        return self.pos[block] % self.nb_loc

    def slot_rows(self) -> np.ndarray:
        """(n,) int64: the permuted (padded) row of every entity."""
        e = np.arange(self.n)
        return self.pos[e // self.bs] * self.bs + e % self.bs

    # -- factor translation --------------------------------------------------

    def permute_factor(self, A):
        """A (n, k) in original order -> (n_pad, k) in permuted slot order
        (padding slots zero).  numpy in, numpy out; a tensor stays a
        tensor on its device."""
        sel = self.slot_rows()
        if torch.is_tensor(A):
            out = A.new_zeros((self.n_pad,) + tuple(A.shape[1:]))
            out[torch.from_numpy(sel).to(A.device)] = A
            return out
        A = np.asarray(A)
        out = np.zeros((self.n_pad,) + A.shape[1:], A.dtype)
        out[sel] = A
        return out

    def unpermute_factor(self, A_perm):
        """(n_pad, k) in slot order -> (n, k) in original entity order."""
        sel = self.slot_rows()
        if torch.is_tensor(A_perm):
            return A_perm[torch.from_numpy(sel).to(A_perm.device)]
        return np.asarray(A_perm)[sel]


def balanced_partition(weights: np.ndarray, g: int, *, n: int, bs: int
                       ) -> BlockPartition:
    """Greedy nnzb balancing: heaviest block-slab first, to the least
    loaded grid row with free slots.  Every grid row gets exactly
    ``nb_loc = ceil(nb / g)`` slots (equal A-shard sizes); short rows are
    padded with empty slots."""
    nb = int(weights.shape[0])
    nb_loc = cdiv(nb, g)
    loads = np.zeros(g)
    counts = np.zeros(g, np.int64)
    groups: list[list[int]] = [[] for _ in range(g)]
    for b in np.argsort(-weights, kind="stable"):
        free = np.flatnonzero(counts < nb_loc)
        tgt = free[np.argmin(loads[free])]
        groups[int(tgt)].append(int(b))
        loads[tgt] += weights[b]
        counts[tgt] += 1
    perm = np.full(g * nb_loc, -1, np.int64)
    pos = np.full(nb, -1, np.int64)
    for i, grp in enumerate(groups):
        grp.sort()            # keep the original order within a slab
        for s, b in enumerate(grp):
            slot = i * nb_loc + s
            perm[slot] = b
            pos[b] = slot
    return BlockPartition(n=n, bs=bs, grid=g, nb=nb, nb_loc=nb_loc,
                          perm=perm, pos=pos)


def identity_partition(n: int, bs: int, g: int) -> BlockPartition:
    """Contiguous (unpermuted) assignment: the virtual generators lay out
    their own blocks, so no reshuffle is needed."""
    nb = cdiv(n, bs)
    nb_loc = cdiv(nb, g)
    perm = np.full(g * nb_loc, -1, np.int64)
    perm[:nb] = np.arange(nb)
    pos = np.arange(nb, dtype=np.int64)
    return BlockPartition(n=n, bs=bs, grid=g, nb=nb, nb_loc=nb_loc,
                          perm=perm, pos=pos)


# ---------------------------------------------------------------------------
# Sharded BCSR — the grid operand
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellShard:
    """What one grid cell holds of a ShardedBCSR: its local BCSR (n =
    n_loc, shard-local block coordinates, front-padded), the partition
    and its cell (i, j), so the grid sweep can refuse a layout made for
    another grid."""
    sp: BCSR
    part: BlockPartition
    i: int
    j: int
    nnzb: int                 # real (unpadded) stored blocks

    @property
    def m(self) -> int:
        return self.sp.m

    @property
    def n_pad(self) -> int:
        return self.part.n_pad

    @property
    def device(self) -> torch.device:
        return self.sp.device


@dataclasses.dataclass(frozen=True)
class ShardedBCSR:
    """Per-cell BCSR shards stacked into the grid engine's operand layout.

    ``data`` (g, g, m, z_max, bs, bs) with ``rows``/``cols`` (g, g, z_max)
    int32 in shard-local block coordinates, row-major per shard, all on
    one device.  Shards are front-padded with zero blocks at (0, 0) to
    the common z_max (zero data: products unaffected, order preserved);
    ``nnzb`` (g, g) numpy records each shard's real stored-block
    count."""
    part: BlockPartition
    data: torch.Tensor       # (g, g, m, z_max, bs, bs)
    rows: torch.Tensor       # (g, g, z_max) int32
    cols: torch.Tensor       # (g, g, z_max) int32
    nnzb: np.ndarray         # (g, g) int64

    @property
    def g(self) -> int:
        return self.data.shape[0]

    @property
    def m(self) -> int:
        return self.data.shape[2]

    @property
    def bs(self) -> int:
        return self.data.shape[-1]

    @property
    def z_max(self) -> int:
        return self.data.shape[3]

    @property
    def n(self) -> int:
        return self.part.n

    @property
    def n_loc(self) -> int:
        return self.part.n_loc

    @property
    def n_pad(self) -> int:
        return self.part.n_pad

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnzb_total(self) -> int:
        return int(self.nnzb.sum())

    @property
    def balance(self) -> float:
        """max shard nnzb / ideal (total / g^2); 1.0 is perfect."""
        total = self.nnzb_total
        if total == 0:
            return 1.0
        return float(self.nnzb.max() * self.g * self.g / total)

    @property
    def resident_bytes(self) -> int:
        """Bytes stored across all shards (data + indices)."""
        return (self.data.numel() * self.data.element_size()
                + self.rows.numel() * 4 + self.cols.numel() * 4)

    def shard(self, i: int, j: int) -> BCSR:
        """Cell (i, j)'s local tensor (shard-local coordinates, n =
        n_loc), a view of the stacked data."""
        return BCSR(data=self.data[i, j], block_rows=self.rows[i, j],
                    block_cols=self.cols[i, j], n=self.n_loc)

    def cell(self, i: int, j: int) -> CellShard:
        """``shard(i, j)`` with the partition and the cell it was made
        for: what the grid sweep takes."""
        return CellShard(sp=self.shard(i, j), part=self.part, i=i, j=j,
                         nnzb=int(self.nnzb[i, j]))

    def with_data(self, data: torch.Tensor) -> "ShardedBCSR":
        return dataclasses.replace(self, data=data)

    def to_bcsr(self) -> BCSR:
        """The shards merged into one global BCSR over the permuted,
        padded entity space (n = n_pad), without the padding blocks: the
        single-device operand.  The merged order is found on the host; the
        blocks are copied on the device.  A 1 x 1 grid's one shard is
        already that tensor, and comes back as a view."""
        g, nb_loc, z_max = self.g, self.part.nb_loc, self.z_max
        rows = self.rows.cpu().numpy()
        cols = self.cols.cpu().numpy()
        z0 = z_max - self.nnzb                          # front padding
        dev = self.device
        if g == 1 and z0[0, 0] == 0:
            return BCSR(data=self.data[0, 0], block_rows=self.rows[0, 0],
                        block_cols=self.cols[0, 0], n=self.n_pad)
        rows_l, cols_l = [], []
        for i in range(g):
            for j in range(g):
                rows_l.append(rows[i, j, z0[i, j]:].astype(np.int64)
                              + i * nb_loc)
                cols_l.append(cols[i, j, z0[i, j]:].astype(np.int64)
                              + j * nb_loc)
        grow = np.concatenate(rows_l)
        gcol = np.concatenate(cols_l)
        order = np.lexsort((gcol, grow))               # row-major sort
        dest = np.empty_like(order)
        dest[order] = np.arange(order.shape[0])
        data = torch.empty((self.m, order.shape[0], self.bs, self.bs),
                           dtype=self.data.dtype, device=dev)
        start = 0
        for i in range(g):
            for j in range(g):
                cnt = int(self.nnzb[i, j])
                if cnt:
                    data.index_copy_(1, _index(dest[start:start + cnt], dev),
                                     self.data[i, j, :, z0[i, j]:])
                start += cnt
        return BCSR(data=data,
                    block_rows=_index(grow[order].astype(np.int32), dev),
                    block_cols=_index(gcol[order].astype(np.int32), dev),
                    n=self.n_pad)

    def to_dense(self) -> torch.Tensor:
        """(m, n, n) dense in the ORIGINAL entity order (reference only)."""
        dense_perm = bcsr_to_dense(self.to_bcsr())
        sel = torch.from_numpy(self.part.slot_rows()).to(self.device)
        return dense_perm[:, sel][:, :, sel]


def partition_coo(coo: COOTensor, *, bs: int = 128,
                  grid: int | None = None, n_devices: int | None = None,
                  part: BlockPartition | None = None,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> ShardedBCSR:
    """COO -> balanced BCSR shards on a (g, g) grid, on ``device``
    (default ``cuda``).

    ``grid`` fixes g directly; otherwise ``choose_grid(n_devices)`` sizes
    it.  Pass ``part`` to reuse a previously computed assignment (e.g. to
    lay a second tensor out identically): its block size and entity count
    override ``bs`` and must match the COO."""
    dev = _device.resolve(device)
    if part is None:
        if grid is None:
            if n_devices is None:
                raise ValueError("need grid=, n_devices= or part=")
            grid = choose_grid(n_devices)
        nb = cdiv(coo.n, bs)
        brow = coo.rows // bs
        bcol = coo.cols // bs
        ukeys = np.unique(brow * nb + bcol)
        weights = np.zeros(nb)
        np.add.at(weights, ukeys // nb, 1.0)
        np.add.at(weights, ukeys % nb, 1.0)
        with obs.span("ingest/balance", grid=grid, bs=bs, n=coo.n):
            part = balanced_partition(weights, grid, n=coo.n, bs=bs)
    else:
        if part.n != coo.n:
            raise ValueError(f"partition was built for n={part.n}, "
                             f"tensor has n={coo.n}")
        bs = part.bs          # the reused layout fixes the block size
        brow = coo.rows // bs
        bcol = coo.cols // bs

    g, nb_loc = part.grid, part.nb_loc
    # shard and local coordinates of every entry's block
    own_r, loc_r = part.owner(brow), part.local(brow)
    own_c, loc_c = part.owner(bcol), part.local(bcol)
    # per-shard distinct blocks, row-major sorted within the shard
    ekey = ((own_r * g + own_c) * nb_loc + loc_r) * nb_loc + loc_c
    ukeys, z = np.unique(ekey, return_inverse=True)
    shard_of = ukeys // (nb_loc * nb_loc)
    nnzb = np.zeros((g, g), np.int64)
    np.add.at(nnzb.reshape(-1), shard_of, 1)
    z_max = int(nnzb.max()) if ukeys.size else 0
    z_max = max(z_max, 1)                     # >= 1 slot (all-empty shards)
    # front padding: real block u sits at slot pad(shard) + rank-in-shard
    rank = np.arange(ukeys.shape[0]) - np.concatenate(
        ([0], np.cumsum(np.bincount(shard_of,
                                    minlength=g * g))))[shard_of]
    pad = z_max - nnzb.reshape(-1)
    slot_of = pad[shard_of] + rank

    with obs.span("ingest/shard", g=g, z_max=z_max):
        m = coo.m
        data = torch.zeros((g, g, m, z_max, bs, bs), dtype=dtype,
                           device=dev)
        flat = (((((own_r * g + own_c) * m + coo.rels) * z_max
                  + slot_of[z]) * bs + coo.rows % bs) * bs + coo.cols % bs)
        data.view(-1).index_put_(
            (_index(flat, dev),),
            torch.as_tensor(coo.vals).to(device=dev, dtype=dtype),
            accumulate=True)
        rows = np.zeros((g, g, z_max), np.int32)
        cols = np.zeros((g, g, z_max), np.int32)
        sh_i, sh_j = shard_of // g, shard_of % g
        rows[sh_i, sh_j, slot_of] = ((ukeys // nb_loc)
                                     % nb_loc).astype(np.int32)
        cols[sh_i, sh_j, slot_of] = (ukeys % nb_loc).astype(np.int32)
        return ShardedBCSR(part=part, data=data, rows=_index(rows, dev),
                           cols=_index(cols, dev), nnzb=nnzb)


def partition_dense(X, *, bs: int = 128, grid: int = 1,
                    threshold: float = 0.0, device=None) -> ShardedBCSR:
    """Dense (m, n, n) -> balanced shards (test and reference
    convenience).  The operand keeps its own precision (float64 in,
    float64 stored), as in ``repro``."""
    X = X.cpu().numpy() if torch.is_tensor(X) else np.asarray(X)
    rels, rows, cols = np.nonzero(np.abs(X) > threshold)
    coo = COOTensor(rels=rels.astype(np.int64), rows=rows.astype(np.int64),
                    cols=cols.astype(np.int64), vals=X[rels, rows, cols],
                    n=X.shape[1], m=X.shape[0])
    return partition_coo(coo, bs=bs, grid=grid,
                         dtype=torch.from_numpy(X[:0]).dtype, device=device)
