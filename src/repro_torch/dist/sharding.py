"""The RESCAL 2D process grid and its collectives (port of the RESCAL half
of ``repro/dist/sharding.py:286-385``).

``repro`` runs the paper's grid as a ``shard_map`` over a ("pod", "data",
"model") mesh: "data" is the paper's row index i, "model" the column
index j, and ``psum(x, "data")`` sums over i for a fixed (pod, j).  Here
the grid is a set of ``torch.distributed`` process groups, one process
per grid cell, and ``Grid`` holds this process's groups:

  * the **row-axis group** (``ROW_AXIS``): the ranks of one (pod, j),
    i = 0..rows-1 — what ``psum(..., ROW_AXIS)`` sums over;
  * the **col-axis group** (``COL_AXIS``): the ranks of one (pod, i);
  * the **pod group** (``POD_AXIS``): the ranks of one (i, j) across pods.

The global rank of cell (pod, i, j) is ``pod * rows * cols + i * cols +
j``, the device order of ``repro``'s mesh.  Every collective is issued
even on a group of one (a 1 x 1 grid on one card) and counted on
``Grid.collectives``, and every rank issues the same collectives in the
same order.

Local-block slicing takes the place of ``repro``'s PartitionSpecs
(``factor_specs``, ``ensemble_factor_specs``, ``ensemble_member_specs``):
X^(i,j) = X[:, i-block, j-block], A^(i) is row block i (replicated over
j), R is replicated, and the ensemble's members split evenly over pods
(X replicated across pods).  The grid must be square (the diagonal
broadcasts need rows == cols, as the paper's p_r = p_c), n must divide by
it, and r by the pods; ``Grid`` refuses anything else.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

ROW_AXIS = "data"
COL_AXIS = "model"
POD_AXIS = "pod"


def check_shape(pods: int, rows: int, cols: int) -> None:
    """Refuse a grid ``repro``'s RESCAL mesh would refuse."""
    if min(pods, rows, cols) < 1:
        raise ValueError(f"grid sizes must be >= 1, got pods={pods} "
                         f"rows={rows} cols={cols}")
    if rows != cols:
        raise ValueError(f"the RESCAL grid must be square (the diagonal "
                         f"broadcasts need rows == cols), got {rows} x "
                         f"{cols}")


def group_ranks(pods: int, rows: int, cols: int) -> list[tuple[str, list]]:
    """Every group of the grid as (axis, ranks), in the one order in which
    every process must create them."""
    cell = rows * cols

    def rank(p, i, j):
        return p * cell + i * cols + j

    out = []
    for p in range(pods):
        for j in range(cols):
            out.append((ROW_AXIS, [rank(p, i, j) for i in range(rows)]))
    for p in range(pods):
        for i in range(rows):
            out.append((COL_AXIS, [rank(p, i, j) for j in range(cols)]))
    for i in range(rows):
        for j in range(cols):
            out.append((POD_AXIS, [rank(p, i, j) for p in range(pods)]))
    return out


@dataclasses.dataclass
class Grid:
    """This process's place on the (pods, rows, cols) grid and its groups.

    ``groups`` maps each axis to a process group (``None`` for a grid
    that only slices, as ``convert`` uses).  ``collectives`` counts the
    collectives issued through this object."""
    pods: int
    rows: int
    cols: int
    pod: int
    i: int
    j: int
    device: torch.device
    groups: dict | None = None
    owns_default_group: bool = False
    collectives: int = 0

    def __post_init__(self):
        check_shape(self.pods, self.rows, self.cols)
        if not (0 <= self.pod < self.pods and 0 <= self.i < self.rows
                and 0 <= self.j < self.cols):
            raise ValueError(f"cell ({self.pod}, {self.i}, {self.j}) is "
                             f"not on a {self.pods} x {self.rows} x "
                             f"{self.cols} grid")

    @classmethod
    def at_rank(cls, rank: int, pods: int, rows: int, cols: int,
                device, groups: dict | None = None, **kw) -> "Grid":
        pod, rest = divmod(rank, rows * cols)
        i, j = divmod(rest, cols)
        return cls(pods=pods, rows=rows, cols=cols, pod=pod, i=i, j=j,
                   device=torch.device(device), groups=groups, **kw)

    @property
    def rank(self) -> int:
        return self.pod * self.rows * self.cols + self.i * self.cols + self.j

    @property
    def linear_index(self) -> int:
        """i * cols + j: the cell's index within its pod (``repro``'s
        per-shard noise seed)."""
        return self.i * self.cols + self.j

    @property
    def shape(self) -> dict[str, int]:
        return {POD_AXIS: self.pods, ROW_AXIS: self.rows,
                COL_AXIS: self.cols}

    # -- local blocks -------------------------------------------------------

    def block_size(self, n: int) -> int:
        if n % self.rows:
            raise ValueError(f"n={n} must divide the ({self.rows}, "
                             f"{self.cols}) grid")
        return n // self.rows

    def row_block(self, A: torch.Tensor) -> torch.Tensor:
        """Row block i along axis -2: A^(i) of a global (..., n, k)."""
        nb = self.block_size(A.shape[-2])
        return A[..., self.i * nb:(self.i + 1) * nb, :]

    def x_block(self, X: torch.Tensor) -> torch.Tensor:
        """X^(i,j) = X[..., i-block, j-block] of a global (..., n, n)."""
        nb = self.block_size(X.shape[-1])
        return X[..., self.i * nb:(self.i + 1) * nb,
                 self.j * nb:(self.j + 1) * nb]

    def pod_members(self, r: int) -> range:
        """The member ids this pod runs: an even, contiguous split of r."""
        if r % self.pods:
            raise ValueError(f"r={r} members are not divisible by "
                             f"pods={self.pods} (members split evenly "
                             f"over pods)")
        per = r // self.pods
        return range(self.pod * per, (self.pod + 1) * per)

    # -- collectives --------------------------------------------------------

    def _group(self, axis: str):
        if self.groups is None:
            raise RuntimeError("this Grid has no process groups (made for "
                               "slicing only)")
        return self.groups[axis]

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over ``axis`` (a new tensor; x is not changed)."""
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self._group(axis))
        self.collectives += 1
        return y

    def psum_cast(self, x: torch.Tensor, axis: str,
                  comm_dtype: str | None = None) -> torch.Tensor:
        """all_reduce with the payload cast to ``comm_dtype`` on the wire
        and back to x's dtype (``repro``'s psum_cast)."""
        if comm_dtype is None:
            return self.psum(x, axis)
        y = x.to(getattr(torch, comm_dtype), copy=True,
                 memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self._group(axis))
        self.collectives += 1
        return y.to(x.dtype)

    def diag_row_to_col(self, Ai: torch.Tensor,
                        comm_dtype: str | None = None) -> torch.Tensor:
        """A^(j) from the diagonal cells: every cell contributes A^(i) iff
        i == j, then a psum over the row axis delivers block j to column
        j (paper Alg. 3 line 23)."""
        contrib = Ai if self.i == self.j else torch.zeros_like(Ai)
        return self.psum_cast(contrib, ROW_AXIS, comm_dtype)

    def diag_col_to_row(self, Zj: torch.Tensor,
                        comm_dtype: str | None = None) -> torch.Tensor:
        """The inverse: a column-indexed Z^(j) (equal within column j) ->
        the row-indexed Z^(i) (Alg. 3 line 13)."""
        contrib = Zj if self.i == self.j else torch.zeros_like(Zj)
        return self.psum_cast(contrib, COL_AXIS, comm_dtype)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The blocks of ``axis`` in group order, concatenated on ``dim``:
        row blocks over ``ROW_AXIS`` give the global rows, member groups
        over ``POD_AXIS`` give all members."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=self._group(axis))
        self.collectives += 1
        return torch.cat(parts, dim=dim)

    def destroy(self) -> None:
        """Destroy this grid's groups, and the default group when
        ``make_grid`` created it."""
        if self.groups is None:
            return
        for g in dict.fromkeys(self.groups.values()):
            dist.destroy_process_group(g)
        self.groups = None
        if self.owns_default_group and dist.is_initialized():
            dist.destroy_process_group()
