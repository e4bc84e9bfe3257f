"""Per-device costs of one of the port's steps, counted op by op (the
counterpart of ``repro/launch/hlo_costs.py`` and ``repro/launch/
hlo_stats.py``).

``repro`` reads its three roofline numerators and an op histogram from
the compiled program's HLO text, with loop trip counts.  The port runs
eagerly, so it counts what a step dispatches instead: ``StepCounter`` is
a ``TorchDispatchMode`` that sees every aten op the step runs, every
kernel launch (each kernel wrapper reports its own entry) and every
collective (``dist.sharding.Grid`` reports each one), with ``repro``'s
conventions (``hlo_costs.py:8-20``):

  flops       2 * prod(result) * prod(contracting dims) per matmul-family
              op (``torch.utils.flop_counter.flop_registry``'s shape
              rules: mm, bmm, addmm, baddbmm, convolution, attention);
              1 per output element of an elementwise op (the ``pointwise``
              tag, copies and casts aside); prod(operand) per reduction
              (the ``reduction`` tag); a kernel launch adds its module's
              ``cost``: the function's own work
  bytes       operands plus results of each op that materializes a tensor
              (each operand's addressed elements: a broadcast dim of
              stride 0 counts once); views and allocations (``empty``)
              count 0; a kernel launch adds its ``cost``'s bytes, each
              operand read once and each output written once
  collectives count, result bytes and wire bytes per kind, the wire bytes
              per device under ring algorithms (``wire_bytes``, ``repro``'s
              ``hlo_stats._wire_bytes``, and "broadcast", which ``repro``'s
              programs do not issue); ``by_axis`` beside them
  ops         a histogram by aten op name, plus one ``kernel:<name>`` per
              kernel launch; a composite op (matmul, einsum, reshape) is
              counted as the ops it decomposes into, also under inference
              mode, where it reaches the counter whole

Eager runs every loop iteration, so no trip count is needed.  The same
step gives the same numbers on the card, on the CPU and on the meta
device, where nothing is allocated: on the CPU a kernel wrapper runs its
plain version uncounted and counts what the card would run, by running
its card path on meta stand-ins of its arguments (``as_card``); on meta
the wrapper runs its card path up to the launch, reports the entry and
launches nothing.  Counters are per thread; nested, each counts all
that runs in its scope.  Ops outside the ``aten`` namespace (``c10d``'s) are
not counted: the grid reports its collectives itself.

Usage::

    with StepCounter() as c:
        step(...)
    c.summary()    # {"flops", "bytes", "collectives", "ops", and the
                   #  flops and bytes by op name}
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["StepCounter", "active", "as_card", "collective", "launched",
           "meta_like", "nbytes", "uncounted", "wire_bytes"]

# no bytes: what only names or allocates memory
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
             "detach", "set_", "resize_", "_local_scalar_dense"}
# no flops: pointwise-tagged copies and casts
_NO_FLOPS = {"clone", "_to_copy", "copy_", "copy", "fill_", "fill",
             "zero_", "contiguous"}

_local = threading.local()     # each thread's counters, innermost last


def _stack() -> list["StepCounter"]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one device sends for a collective of ``result_bytes`` over a
    group of ``g``, ring algorithms (``repro/launch/hlo_stats.py:64-77``);
    a broadcast: the root's payload forwarded once around the ring,
    (g - 1) / g of it per device."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(kind)


def nbytes(x: torch.Tensor) -> int:
    """Bytes of the elements ``x`` addresses: a dim of stride 0 (a
    broadcast) counts once."""
    if x.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(x.shape, x.stride()) if st != 0)
    return n * x.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts the flops, bytes, collectives and ops of what runs under it
    in this thread (module docstring); ``flops_by_op`` and
    ``bytes_by_op`` split the flops and bytes by op name."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no step is compiled under a counter; left True, torch wraps
        # __torch_dispatch__ in a dynamo guard whose first call imports
        # torch._dynamo (seconds), at the exit of every traced CLI run
        return False

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.collectives: dict[str, dict] = {}
        self.by_axis: dict[str, dict] = {}
        self._quiet = 0

    def __enter__(self):
        _stack().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _stack().remove(self)
        return super().__exit__(*exc)

    # -- aten ops ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._quiet and func.overloadpacket not in flop_registry:
            # a composite op (matmul, einsum, reshape: under inference
            # mode they reach the mode whole) is counted as the ops it
            # decomposes into, as outside inference mode
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._quiet or func.namespace != "aten":
            return out
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        flops = self._flops(func, name, args, kwargs, out)
        self.flops += flops
        self.flops_by_op[name] += flops
        if not (func.is_view or name in _NO_BYTES):
            moved = (sum(nbytes(t) for t in _tensors((args, kwargs)))
                     + sum(nbytes(t) for t in _tensors(out)))
            self.bytes += moved
            self.bytes_by_op[name] += moved
        return out

    @staticmethod
    def _flops(func, name, args, kwargs, out) -> int:
        rule = flop_registry.get(func.overloadpacket)
        if rule is not None:
            return int(rule(*args, **kwargs, out_val=out))
        tags = func.tags
        if torch.Tag.pointwise in tags and name not in _NO_FLOPS:
            return sum(t.numel() for t in _tensors(out))
        if torch.Tag.reduction in tags:
            ins = _tensors(args)
            return ins[0].numel() if ins else 0
        return 0

    # -- what the wrappers and the grid report -----------------------------

    def kernel(self, name: str, flops: int, nbytes_: int) -> None:
        if self._quiet:
            return
        self.ops[f"kernel:{name}"] += 1
        self.flops += int(flops)
        self.flops_by_op[f"kernel:{name}"] += int(flops)
        self.bytes_by_op[f"kernel:{name}"] += int(nbytes_)
        self.bytes += int(nbytes_)

    def collective(self, kind: str, axis: str, result_bytes: int,
                   g: int) -> None:
        if self._quiet:
            return
        wire = wire_bytes(kind, result_bytes, g)
        slot = self.collectives.setdefault(
            kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        slot["count"] += 1
        slot["result_bytes"] += result_bytes
        slot["wire_bytes"] += wire
        ax = self.by_axis.setdefault(
            axis, {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        ax["count"] += 1
        ax["payload_bytes"] += result_bytes
        ax["wire_bytes"] += wire

    # -- results -----------------------------------------------------------

    def collectives_summary(self) -> dict:
        """``repro``'s shape (``hlo_costs.analyze``): the total, then
        {count, wire_bytes} per kind; ``by_axis`` beside them."""
        total = {"count": sum(s["count"] for s in self.collectives.values()),
                 "result_bytes": sum(s["result_bytes"]
                                     for s in self.collectives.values()),
                 "wire_bytes": sum(s["wire_bytes"]
                                   for s in self.collectives.values())}
        kinds = {k: {"count": s["count"], "wire_bytes": s["wire_bytes"]}
                 for k, s in sorted(self.collectives.items())}
        return {"total": total, **kinds, "by_axis": dict(self.by_axis)}

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives_summary(),
                "ops": dict(sorted(self.ops.items())),
                "flops_by_op": dict(sorted(self.flops_by_op.items())),
                "bytes_by_op": dict(sorted(self.bytes_by_op.items()))}


def active() -> StepCounter | None:
    """This thread's innermost counter, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def uncounted():
    """Nothing run inside is counted (set-up a call caches, such as a
    pattern's transposed index, and a plain version standing in for a
    kernel)."""
    stack = list(_stack())
    for c in stack:
        c._quiet += 1
    try:
        yield
    finally:
        for c in stack:
            c._quiet -= 1


def launched(name: str, cost: Callable[..., tuple[int, int]], *args,
             **kwargs) -> None:
    """A kernel wrapper's entry at its launch point: ``cost(*args,
    **kwargs)`` is its module's (flops, bytes), computed only when a
    counter is active (the launch path pays nothing else)."""
    stack = _stack()
    if stack:
        work = cost(*args, **kwargs)
        for c in stack:
            c.kernel(name, *work)


def collective(kind: str, axis: str, result_bytes: int, g: int) -> None:
    """One collective, as ``Grid`` issues (or records) it."""
    for c in _stack():
        c.collective(kind, axis, result_bytes, g)


def meta_like(x: Any, _memo: dict | None = None) -> Any:
    """``x`` with every tensor (a BCSR's too, and a dataclass record's)
    replaced by an empty meta tensor of its shape, strides and dtype; one
    object given twice gives one stand-in (a wrapper that tests ``B2 is
    B1``, or a record's tensors against the call's, sees it)."""
    from repro_torch.core.sparse import BCSR
    memo = {} if _memo is None else _memo
    if isinstance(x, (torch.Tensor, BCSR)):
        if id(x) not in memo:
            memo[id(x)] = (x.on_meta() if isinstance(x, BCSR) else
                           torch.empty_strided(x.shape, x.stride(),
                                               dtype=x.dtype, device="meta"))
        return memo[id(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        # a record of tensors (a kernel's prepared operands)
        return dataclasses.replace(x, **{
            f.name: meta_like(getattr(x, f.name), memo)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: meta_like(v, memo) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(meta_like(v, memo) for v in x)
    return x


def as_card(card: Callable, plain: Callable, *args, **kwargs):
    """``plain(*args, **kwargs)``, counted as the card runs the call: when
    a counter is active, ``card`` (the kernel's wrapper) runs on meta
    stand-ins of the arguments (counted: its own aten work and its
    launch's entry) and ``plain`` runs uncounted."""
    c = active()
    if c is None or c._quiet:
        return plain(*args, **kwargs)
    with uncounted():
        memo: dict = {}
        margs, mkw = meta_like(args, memo), meta_like(kwargs, memo)
    card(*margs, **mkw)
    with uncounted():
        return plain(*args, **kwargs)
