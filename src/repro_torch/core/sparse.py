"""Block-sparse (BCSR) relational tensors (port of ``repro/core/sparse.py``).

Layout, shared across the m relation slices:

  data        : (m, nnzb, bs, bs) f32   stored blocks (dense)
  block_rows  : (nnzb,) int32           block-row of each stored block
  block_cols  : (nnzb,) int32           block-col of each stored block
  row_ptr     : (nb + 1,) int32         derived once: blocks of block-row i
                                        are z in [row_ptr[i], row_ptr[i+1])

Blocks are stored in row-major order (checked when a BCSR is built), so
each block-row's blocks are contiguous — the CUDA kernels walk them with
``row_ptr``.  ``data`` may carry a leading member axis, (r, m, nnzb, bs,
bs): the r perturbed copies of one ensemble share the pattern, and every
product below then also takes a member-batched operand (r, n, k).  That
axis is ``repro``'s ``vmap`` written out.

``n`` is the logical entity count and need not divide ``bs``: the tail
block is zero-padded on construction and cropped on the way out; an empty
pattern (nnzb == 0) is a valid tensor whose products are zero.

With ``KernelPolicy(use_fused=True)`` every BCSR product goes through a
kernel (``kernels/ops.py``): the MU step's pair through ``bcsr_xa_xta``,
and the single products of ``sparse_rel_error`` and the R regression
through ``bcsr_spmm``.  Without it the plain ``index_add_`` segment sums
below run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.analysis.sanitizer import sanitize_state
from repro_torch.obs.metrics import record_metrics, update_ratio

from .rescal import (EPS_DEFAULT, a_update, atxa, fit_error, gram,
                     r_update)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BCSR:
    data: torch.Tensor         # ([r,] m, nnzb, bs, bs) float32
    block_rows: torch.Tensor   # (nnzb,) int32
    block_cols: torch.Tensor   # (nnzb,) int32
    n: int                     # logical entities
    row_ptr: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.data.dim() not in (4, 5):
            raise ValueError(f"data must be ([r,] m, nnzb, bs, bs), got "
                             f"{tuple(self.data.shape)}")
        if self.data.shape[-1] != self.data.shape[-2]:
            raise ValueError("stored blocks must be square")
        for name in ("block_rows", "block_cols"):
            idx = getattr(self, name)
            if idx.dtype != torch.int32 or idx.dim() != 1:
                raise ValueError(f"{name} must be a 1-D int32 tensor")
            if idx.shape[0] != self.nnzb:
                raise ValueError(f"{name} has {idx.shape[0]} entries for "
                                 f"nnzb={self.nnzb}")
            if idx.device != self.data.device:
                raise ValueError(f"{name} is on {idx.device}, data on "
                                 f"{self.data.device}")
        nb = self.nblocks
        rows = self.block_rows.long()
        cols = self.block_cols.long()
        if self.nnzb:
            lo = int(torch.minimum(rows.min(), cols.min()))
            hi = int(torch.maximum(rows.max(), cols.max()))
            if lo < 0 or hi >= nb:
                raise ValueError(f"block coordinates outside [0, {nb})")
            order = rows * nb + cols
            if self.nnzb > 1 and not bool((order[1:] > order[:-1]).all()):
                raise ValueError("stored blocks must be in strictly "
                                 "row-major order (sorted by (row, col))")
        counts = torch.bincount(rows, minlength=nb)
        row_ptr = torch.zeros(nb + 1, dtype=torch.int32,
                              device=self.data.device)
        row_ptr[1:] = torch.cumsum(counts, 0)
        object.__setattr__(self, "row_ptr", row_ptr)

    def with_data(self, data: torch.Tensor) -> "BCSR":
        """The same pattern with other stored values (a perturbed copy or
        a member-stacked ensemble)."""
        return BCSR(data=data, block_rows=self.block_rows,
                    block_cols=self.block_cols, n=self.n)

    @property
    def m(self) -> int:
        return self.data.shape[-4]

    @property
    def nnzb(self) -> int:
        return self.data.shape[-3]

    @property
    def bs(self) -> int:
        return self.data.shape[-1]

    @property
    def nblocks(self) -> int:
        return cdiv(self.n, self.bs)

    @property
    def n_pad(self) -> int:
        """Padded entity count (nblocks * bs >= n)."""
        return self.nblocks * self.bs

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """() for one tensor, (r,) for a member-stacked ensemble."""
        return tuple(self.data.shape[:-4])

    @property
    def device(self) -> torch.device:
        return self.data.device


def pad_rows(B: torch.Tensor, n: int, n_pad: int) -> torch.Tensor:
    """Zero-pad the entity axis (-2) of B from n to n_pad."""
    if n_pad == n:
        return B
    return torch.nn.functional.pad(B, (0, 0, 0, n_pad - n))


def tail_mask(n: int, bs: int, nb: int, *, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """(nb * bs,) mask: 1 for logical entities, 0 for the padded tail."""
    return (torch.arange(nb * bs, device=device) < n).to(dtype)


def from_dense(X: torch.Tensor, bs: int = 128) -> BCSR:
    """Blockify a dense (m, n, n) tensor, keeping blocks where any slice
    has a non-zero (the pattern is the union over slices).  Runs on X's
    device."""
    m, n, _ = X.shape
    nb = cdiv(n, bs)
    if nb * bs != n:
        X = torch.nn.functional.pad(X, (0, nb * bs - n, 0, nb * bs - n))
    Xb = X.reshape(m, nb, bs, nb, bs).permute(1, 3, 0, 2, 4)  # (nb,nb,m,..)
    keep = Xb.abs().amax(dim=(2, 3, 4)) > 0
    rows, cols = torch.nonzero(keep, as_tuple=True)            # row-major
    data = Xb[rows, cols].permute(1, 0, 2, 3).contiguous()
    return BCSR(data=data, block_rows=rows.to(torch.int32),
                block_cols=cols.to(torch.int32), n=n)


def to_dense(sp: BCSR) -> torch.Tensor:
    """([r,] m, n, n) dense tensor — tests and small data only."""
    nb, bs = sp.nblocks, sp.bs
    lead = sp.batch_shape + (sp.m,)
    out = torch.zeros(lead + (nb, nb, bs, bs), dtype=sp.data.dtype,
                      device=sp.device)
    out[..., sp.block_rows.long(), sp.block_cols.long(), :, :] = sp.data
    out = out.transpose(-3, -2).reshape(lead + (nb * bs, nb * bs))
    return out[..., :sp.n, :sp.n]


def random_bcsr(rng: np.random.Generator, m: int, n: int, bs: int = 128,
                block_density: float = 0.05, *, device=None) -> BCSR:
    """Random non-negative BCSR tensor with ~block_density stored blocks
    (the diagonal always stored).  Values are drawn with numpy's ``rng``
    and the padded tail (bs not dividing n) is zero, so round trips
    through ``to_dense``/``from_dense`` are exact."""
    dev = _device.resolve(device)
    nb = cdiv(n, bs)
    keep = (rng.random((nb, nb)) < block_density) | np.eye(nb, dtype=bool)
    rows, cols = np.nonzero(keep)
    data = rng.random((m, rows.shape[0], bs, bs), dtype=np.float32)
    if nb * bs != n:
        mask = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
        data *= mask[rows][None, :, :, None] * mask[cols][None, :, None, :]
    return BCSR(data=torch.from_numpy(data).to(dev),
                block_rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
                block_cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
                n=n)


def perturb_bcsr(sp: BCSR, noise: torch.Tensor) -> BCSR:
    """Alg. 4 for sparse data: multiply the stored blocks by ``noise``
    (uniform in [1 - delta, 1 + delta], same shape as the data), keeping
    the pattern (paper §4.2).  The noise comes from a draw source
    (selection/draws.py)."""
    if noise.shape != sp.data.shape:
        raise ValueError(f"noise {tuple(noise.shape)} does not match data "
                         f"{tuple(sp.data.shape)}")
    return sp.with_data(sp.data * noise)


# ---------------------------------------------------------------------------
# Plain products (index_add_ segment sums; the kernels' plain versions)
# ---------------------------------------------------------------------------

def block_tiles(sp: BCSR, B: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row tiles B[index[z]] of the padded operand: (..., n, k) ->
    (..., 1, nnzb, bs, k), broadcastable against the (m, nnzb) data."""
    nb, bs = sp.nblocks, sp.bs
    k = B.shape[-1]
    Bb = pad_rows(B, sp.n, nb * bs).reshape(B.shape[:-2] + (nb, bs, k))
    return Bb.index_select(-3, index.long()).unsqueeze(-4)


def segment_sum(prod: torch.Tensor, index: torch.Tensor,
                 segments: int) -> torch.Tensor:
    """Sum (..., m, nnzb, bs, k) products into (..., m, segments, bs, k)
    by block index."""
    shape = prod.shape[:-3] + (segments,) + prod.shape[-2:]
    out = torch.zeros(shape, dtype=prod.dtype, device=prod.device)
    return out.index_add_(prod.dim() - 3, index.long(), prod)


def crop_blocks(out: torch.Tensor, n: int) -> torch.Tensor:
    """(..., m, nb, bs, k) -> (..., m, n, k)."""
    lead = out.shape[:-3]
    return out.reshape(lead + (-1, out.shape[-1]))[..., :n, :]


def spmm(sp: BCSR, B: torch.Tensor) -> torch.Tensor:
    """X_t @ B for all t.  B: ([r,] n, k) -> ([r,] m, n, k)."""
    if sp.nnzb == 0:
        return zeros_product(sp, B)
    prod = sp.data @ block_tiles(sp, B, sp.block_cols)
    return crop_blocks(segment_sum(prod, sp.block_rows, sp.nblocks), sp.n)


def spmm_t(sp: BCSR, B: torch.Tensor) -> torch.Tensor:
    """X_t^T @ B for all t (block transpose: swap row/col and transpose
    the tiles).  B: ([r,] n, k) -> ([r,] m, n, k)."""
    if sp.nnzb == 0:
        return zeros_product(sp, B)
    prod = sp.data.transpose(-1, -2) @ block_tiles(sp, B, sp.block_rows)
    return crop_blocks(segment_sum(prod, sp.block_cols, sp.nblocks), sp.n)


def product_shape(sp: BCSR, B: torch.Tensor) -> tuple[int, ...]:
    """Shape of X @ B: the member axis of either operand, then (m, n, k)."""
    lead = torch.broadcast_shapes(sp.batch_shape, tuple(B.shape[:-2]))
    return tuple(lead) + (sp.m, sp.n, B.shape[-1])


def zeros_product(sp: BCSR, B: torch.Tensor) -> torch.Tensor:
    return torch.zeros(product_shape(sp, B), dtype=B.dtype, device=B.device)


def sqnorm(sp: BCSR) -> torch.Tensor:
    """||X||_F^2 (per member when the data is member-stacked)."""
    return (sp.data * sp.data).sum(dim=(-4, -3, -2, -1))


# ---------------------------------------------------------------------------
# Sparse MU step
# ---------------------------------------------------------------------------

def _fused(policy) -> bool:
    return policy is not None and policy.use_fused


def sparse_products(sp: BCSR, B1: torch.Tensor, B2: torch.Tensor, *,
                    policy=None):
    """Both X-sided products (X @ B1, X^T @ B2) — the hot pair of every
    sparse MU iteration.  A fused ``policy`` (kernels.KernelPolicy) routes
    them through ``kernels.ops.bcsr_xa_xta`` (one pass over the stored
    blocks); otherwise the two plain segment sums run."""
    if _fused(policy):
        from repro_torch.kernels import ops
        return ops.bcsr_xa_xta(sp, B1, B2, impl=policy.impl)
    return spmm(sp, B1), spmm_t(sp, B2)


def single_product(sp: BCSR, B: torch.Tensor, *, policy=None):
    """X @ B alone, through ``kernels.ops.bcsr_spmm`` under a fused
    policy."""
    if _fused(policy):
        from repro_torch.kernels import ops
        return ops.bcsr_spmm(sp, B, impl=policy.impl)
    return spmm(sp, B)


def sparse_mu_step(sp: BCSR, A: torch.Tensor, R: torch.Tensor,
                   eps: float = EPS_DEFAULT, *, policy=None,
                   sanitize: bool = False, trace_metrics: bool = False):
    """One batched MU iteration on a BCSR tensor: the dense step's algebra
    with the X products from ``sparse_products``.  A ([r,] n, k), R ([r,]
    m, k, k); a member-stacked ``sp`` updates all r members at once."""
    A_in = A
    G = gram(A)
    XA, XTA = sparse_products(sp, A, A, policy=policy)
    R = r_update(R, atxa(A, XA), G, eps)
    A = a_update(A, XA, XTA, R, G, eps)
    A, R = sanitize_state(A, R, where="core.sparse.sparse_mu_step",
                          enabled=sanitize)
    if trace_metrics:
        record_metrics("core.sparse.sparse_mu_step",
                       rel_error=sparse_rel_error(sp, A, R, policy=policy),
                       a_norm=torch.linalg.vector_norm(A, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(A_in, A))
    return A, R


def sparse_rel_error(sp: BCSR, A: torch.Tensor, R: torch.Tensor, *,
                     policy=None) -> torch.Tensor:
    """Relative error on a BCSR tensor; needs only X @ A (``bcsr_spmm``
    under a fused policy).  Member-batched A/R give one error each."""
    return fit_error(sqnorm(sp), atxa(A, single_product(sp, A,
                                                        policy=policy)),
                     A, R)


# ---------------------------------------------------------------------------
# R regression with A fixed (the per-k reduction on BCSR operands)
# ---------------------------------------------------------------------------

def sparse_update_R(sp: BCSR, A: torch.Tensor, R: torch.Tensor,
                    G: torch.Tensor, eps: float = EPS_DEFAULT, *,
                    policy=None) -> torch.Tensor:
    """R_t <- R_t * (A^T X_t A) / (G R_t G + eps)."""
    return r_update(R, atxa(A, single_product(sp, A, policy=policy)), G,
                    eps)


def sparse_regress_R(sp: BCSR, A: torch.Tensor, R0: torch.Tensor, *,
                     iters: int = 100, eps: float = EPS_DEFAULT,
                     policy=None) -> torch.Tensor:
    """Solve for R (m, k, k) >= 0 with A fixed, from the initial ``R0``
    (``repro`` draws it from PRNGKey(17); here a draw source supplies it,
    selection/draws.py).  X @ A does not change across the iterations, so
    it is formed once."""
    G = gram(A)
    ATXA = atxa(A, single_product(sp, A, policy=policy))
    R = R0
    for _ in range(iters):
        R = r_update(R, ATXA, G, eps)
    return R
