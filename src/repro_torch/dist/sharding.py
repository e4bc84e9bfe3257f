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
same order.  Traced (``obs.trace``), each collective is a
``grid/<kind>`` span (``grid/all-reduce``, ``grid/broadcast``,
``grid/all-gather``) around the payload's copy or cast and the call.
``Grid.agree`` takes the maximum of a few numbers over every cell (the
row, column and pod groups in turn): the sweep scheduler's decisions
(restores, attempt outcomes, unit times), which ``repro``'s single
controller makes once for its whole mesh.

Local-block slicing takes the place of ``repro``'s PartitionSpecs
(``factor_specs``, ``ensemble_factor_specs``, ``ensemble_member_specs``):
X^(i,j) = X[:, i-block, j-block], A^(i) is row block i (replicated over
j), R is replicated, and the ensemble's members split evenly over pods
(X replicated across pods).  The grid must be square (the diagonal
broadcasts need rows == cols, as the paper's p_r = p_c), n must divide by
it, and r by the pods; ``Grid`` refuses anything else.

The LM half (port of ``repro/dist/sharding.py:33-283``) answers the same
question for the LM zoo: ``logical_spec`` maps (shape, logical axes) onto
the grid's axes with ``repro``'s divisibility fallbacks, and
``param_specs`` / ``opt_state_specs`` / ``cache_specs`` give whole-tree
placements (Megatron tensor parallelism over "model", ZeRO-1 moments
over "data", the decode cache's batch over the data axes and its
sequence over "model").  A placement is a ``Spec``, a plain tuple with
one entry per dim (None, an axis name, or a tuple of axis names), in
place of ``PartitionSpec``.  The rules are pure functions of names and
shapes: a tree is a dict from ``repro``'s "/"-joined parameter path
(``layers/attn/wq``, ``embed/table``) to a shape, with the layer stack's
leading L axis (``stacked_param_shapes`` builds it from the port's
model).  ``LMPlacement`` maps those specs to the port's unstacked
parameters (``layers.{i}.attn.wq``): each layer's parameter takes the
stacked spec without its L entry, and a "data" entry on L (ZeRO-1 at
L % data == 0) gives layer i's moments, whole, to data rank
i // (L / data).

An LM grid (``Grid(lm=True)``, ``launch.mesh.make_lm_grid``) takes any
(pods, data, model) shape: ``repro``'s LM meshes are not square.  It
has one more group per model index, ``BATCH_AXIS``: the ranks of one j
over every (pod, i), the data-parallel group of the batch (``repro``'s
("pod", "data") axes).  ``Grid.axis(name)`` is one axis as an
``AxisGroup`` (its size, this rank's index on it, its collectives).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch import step_costs
from repro_torch.obs import trace as obs

ROW_AXIS = "data"
COL_AXIS = "model"
POD_AXIS = "pod"
DATA_AXIS = ROW_AXIS
MODEL_AXIS = COL_AXIS
# the LM grid's data-parallel group: ("pod", "data") for one model index
BATCH_AXIS = "batch"

# Logical tensor axes (resolved against a grid by logical_spec).  BATCH
# spreads over every data-parallel axis (pod + data); SEQ / MODEL / EXPERT
# compete for the tensor-parallel axis, the first that divides wins.
BATCH = "batch"
SEQ = "seq"
MODEL = "model_dim"
EXPERT = "expert"


def check_shape(pods: int, rows: int, cols: int, square: bool = True
                ) -> None:
    """Refuse a grid ``repro``'s RESCAL mesh would refuse (``square``), or
    any grid with an axis below 1."""
    if min(pods, rows, cols) < 1:
        raise ValueError(f"grid sizes must be >= 1, got pods={pods} "
                         f"rows={rows} cols={cols}")
    if square and rows != cols:
        raise ValueError(f"the RESCAL grid must be square (the diagonal "
                         f"broadcasts need rows == cols), got {rows} x "
                         f"{cols}")


def group_ranks(pods: int, rows: int, cols: int, lm: bool = False
                ) -> list[tuple[str, list]]:
    """Every group of the grid as (axis, ranks), in the one order in which
    every process must create them; ``lm`` adds the batch groups."""
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
    if lm:
        for j in range(cols):
            out.append((BATCH_AXIS, [rank(p, i, j) for p in range(pods)
                                     for i in range(rows)]))
    return out


@dataclasses.dataclass
class Grid:
    """This process's place on the (pods, rows, cols) grid and its groups.

    ``groups`` maps each axis to a process group (``None`` for a grid
    that only slices, as ``convert`` uses).  ``collectives`` counts the
    collectives made through this object.  ``lm`` makes an LM grid:
    any (pods, data, model) shape, and the batch groups.  ``record``
    makes a grid that needs no process group: each collective is
    counted (kind, axis, payload bytes, group size, on an active step
    counter) instead of communicated, and returns a tensor of the right
    shape on the input's device (a sum or maximum of this cell's values
    alone, a gather of this cell's block and empty ones); with
    ``Grid.at_rank(rank, pods, rows, cols, "meta", record=True)`` a
    step runs for any rank of a production grid with nothing allocated
    (``launch.step_costs``, ``launch.dryrun``).  Live or recorded, every
    collective is reported to an active ``step_costs.StepCounter``."""
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
    lm: bool = False
    record: bool = False

    def __post_init__(self):
        check_shape(self.pods, self.rows, self.cols, square=not self.lm)
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

    @property
    def mesh(self) -> "MeshShape":
        """The grid as the LM specs read a mesh: its axis names and sizes,
        "pod" only on a grid of several pods (``repro``'s production and
        debug meshes name it only then)."""
        if self.pods > 1:
            return MeshShape((POD_AXIS, DATA_AXIS, MODEL_AXIS),
                             {POD_AXIS: self.pods, DATA_AXIS: self.rows,
                              MODEL_AXIS: self.cols})
        return MeshShape((DATA_AXIS, MODEL_AXIS),
                         {DATA_AXIS: self.rows, MODEL_AXIS: self.cols})

    @property
    def size(self) -> int:
        return self.pods * self.rows * self.cols

    def axis(self, name: str) -> "AxisGroup":
        """One axis of the grid ("pod", "data", "model" or, on an LM
        grid, "batch") as an ``AxisGroup``."""
        if name == BATCH_AXIS and not self.lm:
            raise ValueError("the batch axis is an LM grid's "
                             "(Grid(lm=True))")
        return AxisGroup(self, name)

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

    def pod_members(self, members: int | Sequence[int]) -> Sequence[int]:
        """The members this pod runs: an even, contiguous split of
        ``members`` (the ids themselves, or r for ids 0..r-1)."""
        if isinstance(members, int):
            members = range(members)
        r = len(members)
        if r % self.pods:
            raise ValueError(f"r={r} members are not divisible by "
                             f"pods={self.pods} (members split evenly "
                             f"over pods)")
        per = r // self.pods
        return members[self.pod * per:(self.pod + 1) * per]

    # -- collectives --------------------------------------------------------

    def _group(self, axis: str):
        if self.groups is None:
            raise RuntimeError("this Grid has no process groups (made for "
                               "slicing only)")
        return self.groups[axis]

    def axis_size(self, axis: str) -> int:
        return {POD_AXIS: self.pods, ROW_AXIS: self.rows,
                COL_AXIS: self.cols,
                BATCH_AXIS: self.pods * self.rows}[axis]

    def axis_index(self, axis: str) -> int:
        return {POD_AXIS: self.pod, ROW_AXIS: self.i, COL_AXIS: self.j,
                BATCH_AXIS: self.pod * self.rows + self.i}[axis]

    def axis_rank(self, axis: str, index: int) -> int:
        """The global rank of the cell at ``index`` on ``axis`` that shares
        this cell's other coordinates."""
        pod, i, j = self.pod, self.i, self.j
        if axis == POD_AXIS:
            pod = index
        elif axis == ROW_AXIS:
            i = index
        elif axis == COL_AXIS:
            j = index
        else:
            pod, i = divmod(index, self.rows)
        return pod * self.rows * self.cols + i * self.cols + j

    def _issued(self, kind: str, axis: str, result: torch.Tensor) -> None:
        """Count one collective whose result is ``result``: on
        ``collectives`` and on an active step counter."""
        nbytes = result.numel() * result.element_size()
        g = self.axis_size(axis)
        self.collectives += 1
        step_costs.collective(kind, axis, nbytes, g)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Maximum of x over ``axis`` (a new tensor)."""
        with obs.span("grid/all-reduce"):
            y = x.clone(memory_format=torch.contiguous_format)
            if not self.record:
                dist.all_reduce(y, op=dist.ReduceOp.MAX,
                                group=self._group(axis))
        self._issued("all-reduce", axis, y)
        return y

    def broadcast(self, x: torch.Tensor, axis: str, index: int) -> None:
        """x of the cell at ``index`` on ``axis`` into every cell's x of
        that group, in place (x must be contiguous)."""
        with obs.span("grid/broadcast"):
            if not self.record:
                dist.broadcast(x, src=self.axis_rank(axis, index),
                               group=self._group(axis))
        self._issued("broadcast", axis, x)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over ``axis`` (a new tensor; x is not changed)."""
        with obs.span("grid/all-reduce"):
            y = x.clone(memory_format=torch.contiguous_format)
            if not self.record:
                dist.all_reduce(y, op=dist.ReduceOp.SUM,
                                group=self._group(axis))
        self._issued("all-reduce", axis, y)
        return y

    def psum_cast(self, x: torch.Tensor, axis: str,
                  comm_dtype: str | None = None) -> torch.Tensor:
        """all_reduce with the payload cast to ``comm_dtype`` on the wire
        and back to x's dtype (``repro``'s psum_cast)."""
        if comm_dtype is None:
            return self.psum(x, axis)
        with obs.span("grid/all-reduce"):
            y = x.to(getattr(torch, comm_dtype), copy=True,
                     memory_format=torch.contiguous_format)
            if not self.record:
                dist.all_reduce(y, op=dist.ReduceOp.SUM,
                                group=self._group(axis))
            out = y.to(x.dtype)
        self._issued("all-reduce", axis, y)
        return out

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
        with obs.span("grid/all-gather"):
            x = x.contiguous()
            parts = [torch.empty_like(x)
                     for _ in range(self.axis_size(axis))]
            if self.record:
                parts[self.axis_index(axis)] = x
            else:
                dist.all_gather(parts, x, group=self._group(axis))
            out = torch.cat(parts, dim=dim)
        self._issued("all-gather", axis, out)
        return out

    def agree(self, values: Sequence[float]) -> list[float]:
        """The maximum of each of a few numbers over every cell of the
        grid (all-reduced over the row, the column, then the pod axis),
        so that every cell gets the same values: the sweep's decisions (a
        restore, an attempt's outcome, a unit's time) go through here.
        The values travel as float64, exact for flags and counts.
        Counted on ``collectives`` like every other collective (3 per
        call); a recording grid returns this cell's values."""
        x = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        for axis in (ROW_AXIS, COL_AXIS, POD_AXIS):
            with obs.span("grid/all-reduce"):
                if not self.record:
                    dist.all_reduce(x, op=dist.ReduceOp.MAX,
                                    group=self._group(axis))
            self._issued("all-reduce", axis, x)
        return [float(v) for v in values] if self.record else x.tolist()

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


# ---------------------------------------------------------------------------
# The LM half: logical axes, whole-tree placements, an axis's collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the LM specs read it: axis names and sizes (``repro``'s
    ``Mesh.axis_names`` and ``Mesh.shape``; no devices)."""
    axis_names: tuple
    shape: dict


class Spec(tuple):
    """A placement: one entry per dim, None (replicated), an axis name, or
    a tuple of axis names (``repro``'s ``PartitionSpec`` entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _mesh(mesh):
    return mesh.mesh if isinstance(mesh, Grid) else mesh


def _axis_size(mesh, names: Sequence[str]) -> int:
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def _batch_candidates(mesh) -> Iterable[tuple[str, ...]]:
    names = tuple(mesh.axis_names)
    if POD_AXIS in names and DATA_AXIS in names:
        yield (POD_AXIS, DATA_AXIS)
    if DATA_AXIS in names:
        yield (DATA_AXIS,)


def _candidates(mesh, logical) -> Iterable[tuple[str, ...]]:
    if logical == BATCH:
        yield from _batch_candidates(mesh)
    elif logical in (SEQ, MODEL, EXPERT):
        if MODEL_AXIS in tuple(mesh.axis_names):
            yield (MODEL_AXIS,)


def logical_spec(mesh, shape: Sequence[int], axes: Sequence[Any]) -> Spec:
    """Logical axes onto the mesh's axes, as ``repro``'s: dims resolve left
    to right and each mesh axis is used at most once; the first logical
    axis whose candidate divides the dim claims it; a dim that does not
    divide stays replicated and leaves the axis for later dims; BATCH
    prefers ("pod", "data") when there is a pod axis, else "data"."""
    mesh = _mesh(mesh)
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    used: set[str] = set()
    entries: list[Any] = []
    for dim, logical in zip(shape, axes):
        entry = None
        if logical is not None:
            for cand in _candidates(mesh, logical):
                if any(a in used for a in cand):
                    continue
                size = _axis_size(mesh, cand)
                if size > 1 and dim > 0 and dim % size == 0:
                    used.update(cand)
                    entry = cand[0] if len(cand) == 1 else tuple(cand)
                    break
        entries.append(entry)
    return Spec(*entries)


# Projection into the sharded feature space: shard the output features
# (last dim), Megatron column parallel.
_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "w1", "w3", "wq_up",
                 "wq_down", "wkv_up", "wkv_down", "router"}
# Projection out of the sharded feature space: shard the input features
# (second-to-last dim), Megatron row parallel.
_ROW_PARALLEL = {"wo", "w2"}
# Vocab-parallel embedding tables: shard the vocab rows.
_VOCAB_PARALLEL = {"table", "embedding", "wte"}


def _param_leaf_spec(mesh, path: str, shape: Sequence[int]) -> Spec:
    shape = tuple(shape)
    nd = len(shape)
    none = [None] * nd
    msize = dict(mesh.shape).get(MODEL_AXIS, 1)
    if nd < 2 or MODEL_AXIS not in tuple(mesh.axis_names) or msize <= 1:
        return Spec(*none)
    keys = path.split("/")
    name = keys[-1]
    entries = list(none)
    # expert-stacked leaves (moe, not the shared MLP): the expert dim when
    # it divides, else the 2D rules on the trailing (in, out) dims
    in_moe = "moe" in keys[:-1] and "shared" not in keys
    if in_moe and nd >= 3 and name in (_COL_PARALLEL | _ROW_PARALLEL):
        if shape[nd - 3] % msize == 0:
            entries[nd - 3] = MODEL_AXIS
            return Spec(*entries)
    if name in _VOCAB_PARALLEL:
        if shape[0] % msize == 0:
            entries[0] = MODEL_AXIS
        return Spec(*entries)
    if name in _ROW_PARALLEL and shape[nd - 2] % msize == 0:
        entries[nd - 2] = MODEL_AXIS
    elif name in _COL_PARALLEL and shape[nd - 1] % msize == 0:
        entries[nd - 1] = MODEL_AXIS
    return Spec(*entries)


def param_specs(mesh, shapes: dict) -> dict[str, Spec]:
    """Tensor-parallel specs of a parameter tree ({"/"-path: shape}, the
    layer stacks with their leading L axis): name-based Megatron rules,
    right-aligned so the L axis is transparent; other leaves replicate."""
    mesh = _mesh(mesh)
    return {path: _param_leaf_spec(mesh, path, shape)
            for path, shape in shapes.items()}


def opt_state_specs(mesh, shapes: dict) -> dict[str, Spec]:
    """ZeRO-1 moment placement: each parameter's tensor-parallel spec with
    the first remaining dim that divides spread over "data", so the fp32
    moments never replicate across the data-parallel ranks."""
    mesh = _mesh(mesh)
    dsize = dict(mesh.shape).get(DATA_AXIS, 1)
    out = {}
    for path, spec in param_specs(mesh, shapes).items():
        entries = list(spec)
        if dsize > 1:
            for i, (dim, e) in enumerate(zip(shapes[path], entries)):
                if e is None and dim > 0 and dim % dsize == 0:
                    entries[i] = DATA_AXIS
                    break
        out[path] = Spec(*entries)
    return out


def cache_specs(mesh, cache: dict) -> dict[str, Spec]:
    """Decode-cache placement ({name: shape or tensor}, leaves stacked
    (L, B, spatial...)): the layer axis replicates, batch spreads over the
    data axes, and "model" takes the first trailing dim it divides
    (sequence if it can, else heads, else features); the
    sequence-sharded decode combine (``models.attention.
    decode_attention(group=)``) relies on this."""
    mesh = _mesh(mesh)
    msize = dict(mesh.shape).get(MODEL_AXIS, 1)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        nd = len(shape)
        entries: list[Any] = [None] * nd
        if nd >= 2:
            bdim = 1
            for cand in _batch_candidates(mesh):
                size = _axis_size(mesh, cand)
                if size > 1 and shape[bdim] % size == 0:
                    entries[bdim] = cand[0] if len(cand) == 1 else tuple(cand)
                    break
            if msize > 1:
                for i in range(bdim + 1, nd):
                    if shape[i] % msize == 0:
                        entries[i] = MODEL_AXIS
                        break
        out[name] = Spec(*entries)
    return out


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(grid: Grid, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This cell's block of a global tensor placed by ``spec`` (a view):
    each sharded dim cut into equal blocks in the axes' order (pod major,
    as ``repro``'s meshes lay out ("pod", "data"))."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            size = grid.axis_size(a)
            n, idx = n * size, idx * size + grid.axis_index(a)
        per = x.shape[dim] // n
        x = x.narrow(dim, idx * per, per)
    return x


def cache_shardings(grid: Grid, cache: dict) -> dict[str, torch.Tensor]:
    """A global decode cache placed on the grid: this cell's blocks per
    ``cache_specs``, as contiguous tensors on the grid's device."""
    specs = cache_specs(grid, cache)
    return {name: local_block(grid, leaf, specs[name]).to(
        grid.device, copy=True).contiguous()
        for name, leaf in cache.items()}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis of a grid: its size, this cell's index on it, and its
    collectives (counted on the grid's ``collectives``)."""
    grid: Grid
    axis: str

    @property
    def size(self) -> int:
        return self.grid.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.grid.axis_index(self.axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.grid.psum(x, self.axis)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.grid.pmax(x, self.axis)


# ---------------------------------------------------------------------------
# The port's unstacked parameters on an LM grid
# ---------------------------------------------------------------------------

_STACKS = ("layers", "enc_layers")


def repro_path(name: str) -> tuple[str, int | None]:
    """A port parameter's ``repro`` path and layer index:
    ``layers.3.attn.wq`` -> ("layers/attn/wq", 3), ``embed`` ->
    ("embed/table", None); the experts' fused ``moe.wgi`` keeps its name
    (``stacked_shapes`` splits it)."""
    parts = name.split(".")
    if parts[0] in _STACKS and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    if name == "embed":
        return "embed/table", None
    return "/".join(parts), None


def stacked_shapes(shapes: dict) -> dict[str, tuple]:
    """``repro``'s parameter tree ({"/"-path: shape}, layer stacks with a
    leading L axis) from the port's ({name: shape}): the per-layer
    parameters stacked, ``embed`` as ``embed/table``, and the experts'
    fused ``wgi`` (E, d, 2 d_ff) as ``repro``'s ``wg`` and ``wi`` (E, d,
    d_ff) each."""
    out: dict[str, tuple] = {}
    depth: dict[str, int] = {}
    for name, shape in shapes.items():
        path, layer = repro_path(name)
        shape = tuple(shape)
        if path.endswith("/moe/wgi"):
            half = (*shape[:-1], shape[-1] // 2)
            base = path[:-len("wgi")]
            items = [(base + "wg", half), (base + "wi", half)]
        else:
            items = [(path, shape)]
        for p, s in items:
            out[p] = s
            if layer is not None:
                depth[p] = max(depth.get(p, 0), layer + 1)
    return {p: ((depth[p], *s) if p in depth else s) for p, s in out.items()}


@dataclasses.dataclass(frozen=True)
class ParamPlacement:
    """One port parameter on an LM grid: its global shape, its
    tensor-parallel spec, its moments' spec (without a layer axis), and
    ``owner``, the data index that holds this layer's moments whole when
    ZeRO-1 put "data" on the layer stack (else None).  ``halves``: the
    experts' fused ``wgi``, ``repro``'s ``wg`` and ``wi`` side by side on
    the last dim, each placed by ``repro``'s ``wg`` spec."""
    name: str
    shape: tuple
    spec: Spec
    moment: Spec
    owner: int | None
    halves: bool = False

    def dim_of(self, spec: Spec, axis: str) -> int | None:
        return next((d for d, e in enumerate(spec) if e == axis), None)


class LMPlacement:
    """Where each parameter of a model lives on an LM grid, from
    ``param_specs`` / ``opt_state_specs`` on ``repro``'s stacked tree
    (``shapes``: the port's {name: global shape}), and the operations
    that follow it: a parameter's local block, the part of it whose
    moments this cell holds, and the collectives that bring an update or
    a checkpoint to the cells that need it."""

    def __init__(self, grid: Grid, shapes: dict):
        self.grid = grid
        stacked = stacked_shapes(shapes)
        pspecs = param_specs(grid, stacked)
        ospecs = opt_state_specs(grid, stacked)
        self.params: dict[str, ParamPlacement] = {}
        for name, shape in shapes.items():
            path, layer = repro_path(name)
            fused = path.endswith("/moe/wgi")
            if fused:
                path = path[:-len("wgi")] + "wg"
            spec, moment, owner = pspecs[path], ospecs[path], None
            if layer is not None:
                L = stacked[path][0]
                if moment[0] == DATA_AXIS:
                    owner = layer // (L // grid.rows)
                spec, moment = Spec(*spec[1:]), Spec(*moment[1:])
            self.params[name] = ParamPlacement(
                name, tuple(shape), spec, moment, owner,
                halves=fused and spec[-1] == MODEL_AXIS)

    def __getitem__(self, name: str) -> ParamPlacement:
        return self.params[name]

    def local_shape(self, name: str) -> tuple:
        pp = self.params[name]
        return tuple(n // self.grid.axis_size(MODEL_AXIS)
                     if e == MODEL_AXIS else n
                     for n, e in zip(pp.shape, pp.spec))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """The block of a parameter's global value this cell holds (for
        ``wgi`` split on d_ff, this cell's block of wg beside its block
        of wi: a copy)."""
        pp = self.params[name]
        if pp.halves:
            return torch.cat([local_block(self.grid, h, pp.spec)
                              for h in full.chunk(2, dim=-1)], dim=-1)
        return local_block(self.grid, full, pp.spec)

    def model_sharded(self, name: str) -> bool:
        return MODEL_AXIS in self.params[name].spec

    def data_sharded(self, name: str) -> bool:
        """Whether the data ranks hold different parts of the moments
        (a layer owner, or a "data" dim), not each a copy."""
        pp = self.params[name]
        return pp.owner is not None or DATA_AXIS in pp.moment

    def owned(self, name: str, local: torch.Tensor) -> torch.Tensor | None:
        """The part of a local block (a view) whose moments, and update,
        this cell holds; None where another data rank holds them all."""
        pp = self.params[name]
        if pp.owner is not None:
            return local if self.grid.i == pp.owner else None
        d = pp.dim_of(pp.moment, DATA_AXIS)
        if d is None:
            return local
        per = local.shape[d] // self.grid.rows
        return local.narrow(d, self.grid.i * per, per)

    def sync(self, name: str, local: torch.Tensor) -> None:
        """After each data rank updated its owned part of ``local`` in
        place, give every data rank the whole updated block: a broadcast
        from the layer's owner, or the parts gathered over "data"."""
        pp = self.params[name]
        if pp.owner is not None:
            self.grid.broadcast(local, DATA_AXIS, pp.owner)
            return
        d = pp.dim_of(pp.moment, DATA_AXIS)
        if d is not None:
            local.copy_(self.grid.all_gather(self.owned(name, local),
                                             DATA_AXIS, d))

    def gather_param(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """A parameter's global value from the local blocks (over
        "model")."""
        pp = self.params[name]
        d = pp.dim_of(pp.spec, MODEL_AXIS)
        if d is None:
            return local
        if pp.halves:
            return torch.cat([self.grid.all_gather(h, MODEL_AXIS, d)
                              for h in local.chunk(2, dim=-1)], dim=-1)
        return self.grid.all_gather(local, MODEL_AXIS, d)

    def gather_moment(self, name: str, part: torch.Tensor | None,
                      like: torch.Tensor) -> torch.Tensor:
        """A moment's global value from the owned parts (``part``, None on
        a data rank that holds none; ``like``: the local parameter block,
        for its shape and device), over "data" then "model"."""
        pp = self.params[name]
        if pp.owner is not None:
            block = (part.contiguous() if part is not None else
                     torch.empty(like.shape, dtype=torch.float32,
                                 device=like.device))
            self.grid.broadcast(block, DATA_AXIS, pp.owner)
        else:
            d = pp.dim_of(pp.moment, DATA_AXIS)
            block = (part if d is None else
                     self.grid.all_gather(part, DATA_AXIS, d))
        return self.gather_param(name, block)

    def place_owned(self, name: str, full: torch.Tensor
                    ) -> torch.Tensor | None:
        """The owned part of a global moment (a restored checkpoint's), or
        None where this cell holds none."""
        part = self.owned(name, self.local(name, full))
        return None if part is None else part.contiguous()


def batch_shardings(grid: Grid, batch: dict) -> dict[str, Spec]:
    """A batch's placement ({key: tensor or shape}; ``repro``'s
    ``batch_shardings``): the leading dim over the data axes (BATCH), the
    rest replicated."""
    shapes = {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
              for k, v in batch.items()}
    return {k: logical_spec(grid, s, (BATCH,) + (None,) * (len(s) - 1))
            for k, s in shapes.items()}


def shard_batch(grid: Grid, batch: dict) -> dict:
    """This cell's rows of a global batch ({key: tensor}), per
    ``batch_shardings``."""
    specs = batch_shardings(grid, batch)
    return {k: local_block(grid, v, specs[k]) for k, v in batch.items()}
