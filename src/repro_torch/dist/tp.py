"""Tensor parallelism over an LM grid's "model" axis: the three
collectives of a Megatron layer, as autograd functions.

``repro`` writes ``constrain(x, ...)`` and lets GSPMD place the
collectives; here a forward makes them by hand, and so must its
backward.  The residual stream is replicated over "model" (every model
rank holds the same activations; ``repro`` keeps it sequence-sharded
between blocks, which gives the same values), and each rank computes the
same loss.  The rule that keeps the gradients exact: a tensor that every
model rank holds whole carries its whole gradient on every rank, and a
rank's share of a split computation carries only that share's.

  * ``split_use(x)``: x, whole on every rank, is about to be used in a
    split computation (a column-parallel product, a subset of heads).
    Forward: identity.  Backward: the ranks' partial gradients summed
    over "model" (an all-reduce).
  * ``reduce(x)``: each rank holds a partial sum (a row-parallel
    product, a vocab shard's lookup).  Forward: all-reduce over "model".
    Backward: identity.
  * ``gather(x, dim)``: each rank holds one block along ``dim``; every
    rank gets the whole.  Forward: all-gather.  Backward: this rank's
    block of the (whole) gradient.

One more for the batch axes (``global_sum``): a sum over the cells
that hold different rows of the batch (the MoE's balance-loss sums,
which ``repro`` takes over the global batch), whose gradient is summed
over them too: every cell adds the same global value to its loss share,
so each local term's gradient is the sum of the shares'.

Every call makes its collective, counted on the grid's
``collectives``; the forward's run in the forward and the backward's in
the backward (and again in the backward's recomputation under
``remat``), in the same order on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from .sharding import MODEL_AXIS, AxisGroup, Grid


class _SplitUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.psum(g, MODEL_AXIS), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return grid.psum(x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, dim):
        ctx.dim, ctx.n, ctx.j = dim, x.shape[dim], grid.j
        return grid.all_gather(x, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.j * ctx.n, ctx.n), None, None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.psum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum(g), None


def global_sum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """x summed over ``group`` (an axis of the grid), forward and
    backward (module docstring)."""
    return _GlobalSum.apply(x, group)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The "model" axis of an LM grid and its three collectives (module
    docstring)."""
    grid: Grid

    @property
    def size(self) -> int:
        return self.grid.cols

    @property
    def index(self) -> int:
        return self.grid.j

    def block(self, n: int) -> tuple[int, int]:
        """(start, length) of this rank's block of n features."""
        per = n // self.size
        return self.index * per, per

    def split_use(self, x: torch.Tensor) -> torch.Tensor:
        return _SplitUse.apply(x, self.grid)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.grid)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.grid, dim)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over "model" (no gradient)."""
        return self.grid.pmax(x.detach(), MODEL_AXIS)
