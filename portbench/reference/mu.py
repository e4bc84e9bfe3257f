"""Plain reference of one non-negative RESCAL MU iteration (paper Alg. 3),
slice by slice, in float32 with TF32 off.

The batched and the per-slice schedule compute the same arithmetic (the
R update of slice t uses the Gram matrix of the old A, and its A-update
terms use the new R_t), so one loop over the slices is the reference of
both.  A leading member axis rides along: X ([r,] m, n, n) or a BCSR
operand with values ([r,] m, nnzb, bs, bs), A ([r,] n, k), R ([r,] m, k,
k).  Plain torch only: nothing of the program is imported here.
"""
from __future__ import annotations

import contextlib

import torch

EPS = 1e-16


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Run the enclosed products in float32 (``tf32=False``) or with
    TF32 allowed (the lower precision a control runs in)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Dense:
    """A dense operand: slice t's products X_t A and X_t^T A."""

    def __init__(self, X: torch.Tensor):
        self.X = X
        self.m = X.shape[-3]

    def products(self, t: int, A: torch.Tensor):
        Xt = self.X[..., t, :, :]
        return Xt @ A, Xt.transpose(-1, -2) @ A

    def sqnorm(self) -> torch.Tensor:
        """||X||^2 per member, slice by slice."""
        total = 0
        for t in range(self.m):
            Xt = self.X[..., t, :, :]
            total = total + (Xt * Xt).sum(dim=(-2, -1))
        return total


class Blocks:
    """A block-sparse operand: ``data`` ([r,] m, nnzb, bs, bs) at block
    coordinates ``rows``, ``cols`` over nb * bs entities."""

    def __init__(self, data: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor, nb: int):
        self.data, self.nb = data, nb
        self.rows, self.cols = rows.long(), cols.long()
        self.m = data.shape[-4]

    def _sum(self, prod: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """Sum per-block products (..., nnzb, bs, k) into block rows
        (..., nb * bs, k) by ``index``."""
        lead, (bs, k) = prod.shape[:-3], prod.shape[-2:]
        out = torch.zeros(lead + (self.nb, bs, k), dtype=prod.dtype,
                          device=prod.device)
        out.index_add_(len(lead), index, prod)
        return out.reshape(lead + (self.nb * bs, k))

    def products(self, t: int, A: torch.Tensor):
        bs, k = self.data.shape[-1], A.shape[-1]
        tiles = A.reshape(A.shape[:-2] + (self.nb, bs, k))
        Dt = self.data[..., t, :, :, :]
        XA = self._sum(Dt @ tiles.index_select(-3, self.cols), self.rows)
        XTA = self._sum(Dt.transpose(-1, -2)
                        @ tiles.index_select(-3, self.rows), self.cols)
        return XA, XTA

    def sqnorm(self) -> torch.Tensor:
        return (self.data * self.data).sum(dim=(-4, -3, -2, -1))


def mu_iteration(op, A: torch.Tensor, R: torch.Tensor, eps: float = EPS):
    """One MU iteration of A and R on ``op`` (``Dense`` or ``Blocks``):

      G = A^T A
      for t: R_t <- R_t * (A^T X_t A) / (G R_t G + eps)
             num += (X_t A) R_t^T + (X_t^T A) R_t
             S   += R_t G R_t^T + R_t^T G R_t
      A <- A * num / (A S + eps)
    """
    G = A.transpose(-1, -2) @ A
    R = R.clone()
    num = torch.zeros_like(A)
    S = torch.zeros_like(G)
    for t in range(op.m):
        XA, XTA = op.products(t, A)
        Rt = R[..., t, :, :]
        Rt = Rt * (A.transpose(-1, -2) @ XA) / (G @ Rt @ G + eps)
        R[..., t, :, :] = Rt
        RtT = Rt.transpose(-1, -2)
        num = num + XA @ RtT + XTA @ Rt
        S = S + Rt @ G @ RtT + RtT @ G @ Rt
    return A * num / (A @ S + eps), R


def atxa(op, A: torch.Tensor) -> torch.Tensor:
    """A^T X_t A for every slice: ([r,] m, k, k)."""
    return torch.stack([A.transpose(-1, -2) @ op.products(t, A)[0]
                        for t in range(op.m)], dim=-3)


def rel_error(op, A: torch.Tensor, R: torch.Tensor,
              x2: torch.Tensor | None = None) -> torch.Tensor:
    """||X - A R A^T|| / ||X|| by the expansion ||X||^2 - 2 <A^T X A, R>
    + <G, R G R^T>, with ||X||^2 given or taken from ``op``."""
    if x2 is None:
        x2 = op.sqnorm()
    G = A.transpose(-1, -2) @ A
    cross = (atxa(op, A) * R).sum(dim=(-3, -2, -1))
    Gt = G.unsqueeze(-3)
    fit = (Gt * (R @ Gt @ R.transpose(-1, -2))).sum(dim=(-3, -2, -1))
    return torch.sqrt((x2 - 2.0 * cross + fit).clamp_min(0.0)) / \
        torch.sqrt(x2)
