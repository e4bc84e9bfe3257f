"""Deterministic, seeded fault injection (port of
``repro/resilience/faults.py``): the seam registry of the port.

A :class:`FaultPlan` maps named *seams* (fixed code points listed in
:data:`SEAMS`) to :class:`FaultSpec` entries.  Each seam's call site
probes the installed plan with :func:`probe`; the plan counts probes per
seam ("hits") and a spec fires on exactly the hit indices it names
(``at``) or on every hit (``always``), so a plan replays identically run
after run.  Byte-level randomness (corrupt offsets, NaN positions) comes
from ``random.Random(spec.seed)``, never from global state, so a plan
corrupts the same bytes and poisons the same positions as it does under
``repro``.  Plans are ``repro``'s JSON: a plan written by either package
loads in the other.

Fault kinds:

    raise-transient      raise :class:`TransientError` (retryable)
    raise-deterministic  raise :class:`DeterministicFault` (fail fast)
    truncate-file        truncate ``path`` to ``fraction`` of its bytes
    corrupt-bytes        XOR ``nbytes`` seeded positions of ``path``
    nan-poison           write NaN into one seeded entry of each float
                         array or tensor passed as ``arrays=`` (numpy
                         arrays, or torch tensors on any device, in place)
    delay                ``time.sleep(seconds)`` (a straggler)
    budget-overflow      no side effect; the kernel dispatcher
                         (``kernels/ops.py``) runs the plain version for
                         that call and counts it as a fallback

The registry is ``repro``'s tuple, name for name and in order.  The probe
sites of the port call :func:`probe`, not ``fire``: the seam lint rule
(``repro/analysis/rules/resilience_seams.py``) counts every call of a
``*faults.fire`` against the registry, and each seam must fire at exactly
one call site (``repro``'s).  The port's sites are ``ckpt/read`` and
``ckpt/write`` (``ckpt/checkpoint.py``), ``ingest/chunk``
(``io/triples.py`` ``COOBuilder.add``), ``kernel/dispatch``
(``kernels/ops.py``), ``sched/unit`` (``selection/scheduler.py``) and
``serve/request`` (``serve/engine.py``) and ``train/step``
(``train/loop.py``).

Zero-cost-off: with no plan installed, :func:`probe` is one module-level
``None`` check.  Every firing emits a ``fault/inject`` instant through
``obs.trace`` and is appended to ``plan.fired``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import time
from typing import Any, Iterator

from repro_torch.obs import trace as obs

__all__ = [
    "SEAMS", "KINDS", "DeterministicFault", "FaultPlan", "FaultSpec",
    "TransientError", "active", "current", "install", "probe",
]

SEAMS = (
    "ckpt/read",        # ckpt.checkpoint.restore, before loading a step
    "ckpt/write",       # ckpt.checkpoint._write_step, after the atomic writes
    "ingest/chunk",     # io.triples.COOBuilder.add, once per ingest chunk
    "kernel/dispatch",  # kernels.ops._dispatch, at impl resolution
    "sched/unit",       # selection.scheduler, before each unit attempt
    "serve/request",    # serve.engine.ServeEngine.query, at admission
    "train/step",       # train.loop.train_loop, before each step
)

KINDS = ("raise-transient", "raise-deterministic", "truncate-file",
         "corrupt-bytes", "nan-poison", "delay", "budget-overflow")


class TransientError(RuntimeError):
    """A retryable failure (lost rank, flaky I/O, preempted host): the
    RetryPolicy backs off and replays it."""


class DeterministicFault(RuntimeError):
    """An injected non-transient failure: replaying it would only burn the
    retry budget, so the policy fails fast."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One seeded fault: fires on the hit indices in ``at`` (0-based count
    of probes of its seam) or on every hit with ``always=True``."""
    kind: str
    at: tuple[int, ...] = ()
    always: bool = False
    seed: int = 0
    fraction: float = 0.5       # truncate-file: keep this share of bytes
    nbytes: int = 64            # corrupt-bytes: positions to flip
    seconds: float = 0.01       # delay: sleep length
    message: str = ""           # raise-*: extra context in the exception

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))

    def matches(self, hit: int) -> bool:
        return self.always or hit in self.at

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _poison(arrays: Any, rng: random.Random) -> None:
    """NaN into one seeded entry of each float array or tensor, in place:
    the flat position ``rng.randrange(size)``, as ``repro`` draws it."""
    import numpy as np
    import torch
    items = arrays.values() if isinstance(arrays, dict) else [arrays]
    for arr in items:
        if torch.is_tensor(arr):
            if arr.numel() == 0 or not arr.is_floating_point():
                continue
            pos = np.unravel_index(rng.randrange(arr.numel()),
                                   tuple(arr.shape))
            arr[tuple(int(i) for i in pos)] = float("nan")
            continue
        arr = np.asarray(arr)
        if arr.size == 0 or not np.issubdtype(arr.dtype, np.floating):
            continue
        arr.reshape(-1)[rng.randrange(arr.size)] = np.nan


class FaultPlan:
    """Seam -> [FaultSpec] with per-seam hit counters and a fired log.
    The counters live on the plan, so a fresh process (or plan) replays
    the same schedule."""

    def __init__(self, specs: dict[str, list[FaultSpec]] | None = None):
        self.specs: dict[str, list[FaultSpec]] = {}
        for seam, entries in (specs or {}).items():
            self.add(seam, *entries)
        self.hits: dict[str, int] = {}
        self.fired: list[dict[str, Any]] = []

    def add(self, seam: str, *entries: FaultSpec) -> "FaultPlan":
        if seam not in SEAMS:
            raise ValueError(f"unknown seam {seam!r}; registered seams: "
                             f"{SEAMS}")
        self.specs.setdefault(seam, []).extend(entries)
        return self

    def fire(self, seam: str, *, path: str | None = None,
             arrays: Any | None = None, **ctx: Any) -> str | None:
        """Count one probe of ``seam``; perform and record any fault due
        on this hit.  Returns the fired kind (raise-* kinds raise
        instead), or None when nothing fired."""
        hit = self.hits.get(seam, 0)
        self.hits[seam] = hit + 1
        fired_kind: str | None = None
        for spec in self.specs.get(seam, ()):
            if not spec.matches(hit):
                continue
            self.fired.append({"seam": seam, "kind": spec.kind, "hit": hit,
                               **ctx})
            obs.event("fault/inject", seam=seam, kind=spec.kind, hit=hit,
                      **{k: v for k, v in ctx.items()
                         if isinstance(v, (str, int, float, bool))})
            self._act(spec, seam, hit, path=path, arrays=arrays)
            fired_kind = spec.kind
        return fired_kind

    @staticmethod
    def _act(spec: FaultSpec, seam: str, hit: int, *, path, arrays) -> None:
        tail = f" at {seam} (hit {hit})" + \
            (f": {spec.message}" if spec.message else "")
        if spec.kind == "raise-transient":
            raise TransientError("injected transient fault" + tail)
        if spec.kind == "raise-deterministic":
            raise DeterministicFault("injected deterministic fault" + tail)
        if spec.kind == "delay":
            time.sleep(spec.seconds)
        elif spec.kind in ("truncate-file", "corrupt-bytes"):
            if path is None:
                raise ValueError(f"{spec.kind}{tail} needs a path= at the "
                                 f"seam's call site")
            size = os.path.getsize(path)
            if spec.kind == "truncate-file":
                os.truncate(path, int(size * spec.fraction))
                return
            rng = random.Random(spec.seed)
            with open(path, "r+b") as f:
                for _ in range(min(spec.nbytes, size)):
                    off = rng.randrange(size)
                    f.seek(off)
                    byte = f.read(1)
                    f.seek(off)
                    f.write(bytes([byte[0] ^ 0xFF]))
        elif spec.kind == "nan-poison":
            if arrays is None:
                raise ValueError(f"nan-poison{tail} needs arrays= at the "
                                 f"seam's call site")
            _poison(arrays, random.Random(spec.seed))
        # budget-overflow: the dispatcher reads the returned kind

    def to_json(self) -> str:
        return json.dumps({"specs": {
            seam: [s.to_dict() for s in entries]
            for seam, entries in self.specs.items()}}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        plan = cls()
        for seam, entries in (json.loads(text).get("specs") or {}).items():
            for entry in entries:
                plan.add(seam, FaultSpec(**entry))
        return plan

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def summary(self) -> str:
        n = sum(len(v) for v in self.specs.values())
        return (f"{n} fault spec(s) over {len(self.specs)} seam(s): "
                + ", ".join(f"{seam}[{len(v)}]"
                            for seam, v in sorted(self.specs.items())))


_PLAN: FaultPlan | None = None


def install(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` process-wide; returns the previous plan."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    return prev


def current() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Scoped install: the plan is live inside the block, restored after."""
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)


def probe(seam: str, *, path: str | None = None, arrays: Any | None = None,
          **ctx: Any) -> str | None:
    """Probe a seam: with no plan installed, one attribute load and a
    ``None`` check; else ``FaultPlan.fire``."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.fire(seam, path=path, arrays=arrays, **ctx)
