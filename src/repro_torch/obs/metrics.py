"""Per-iteration metrics (port of ``repro/obs/metrics.py``).

``record_metrics("core.sparse.sparse_mu_step", rel_error=..., ...)`` appends
the values to the installed ``MetricsBuffer``.  Call sites guard the call
with their ``trace_metrics`` flag, so the default path computes and
records nothing:

    if trace_metrics:
        record_metrics("core.sparse.sparse_mu_step",
                       rel_error=sparse_rel_error(sp, A, R), ...)

Layout.  ``repro``'s vmapped programs call back once per member, so an
ensemble of r members leaves r scalar records per iteration.  The port's
steps run all members at once and record one value per member along a
leading axis: a record whose values are 0-d or 1-D, with every 1-D value
of one length r, stands for r points (0-d values, such as ``step``, are
shared by them).  ``trajectory`` and ``to_arrays`` expand records that way,
so ``metrics.npz`` has ``repro``'s keys and shapes for the same sweep:
iterations x r points per trajectory.

Host syncs.  ``append`` keeps detached tensors where they are; values on
the card move to the host in bulk (one copy per device and dtype) when
``_FLUSH_EVERY`` records are pending and whenever the buffer is read, so a
traced sweep does not wait for the device every iteration.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "MetricsBuffer",
    "get_buffer",
    "install_buffer",
    "record_metrics",
    "update_ratio",
]

# records holding device tensors that may wait before one bulk copy
_FLUSH_EVERY = 1024


def _points(rec: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A record's values with a leading points axis: (r, ...) for a
    member-batched record (0-d values repeated r times), (1, ...) for any
    other."""
    lengths = {v.shape[0] for v in rec.values() if v.ndim == 1}
    if len(lengths) != 1 or any(v.ndim > 1 for v in rec.values()):
        return {name: v[None] for name, v in rec.items()}
    r = lengths.pop()
    return {name: v if v.ndim == 1 else np.broadcast_to(v, (r,))
            for name, v in rec.items()}


class MetricsBuffer:
    """Bounded ring of (seq, tag, {name: value}) records, one record per
    ``record_metrics`` call; past ``capacity`` the oldest is dropped and
    counted in ``dropped``."""

    def __init__(self, capacity: int = 200_000):
        self.capacity = int(capacity)
        self.records: list[tuple[int, str, dict[str, Any]]] = []
        self.dropped = 0
        self._seq = 0
        self._pending = 0       # records still holding tensors

    def append(self, tag: str, values: dict[str, Any]) -> None:
        rec = {name: (v.detach() if torch.is_tensor(v) else np.asarray(v))
               for name, v in values.items()}
        self.records.append((self._seq, tag, rec))
        self._seq += 1
        if any(torch.is_tensor(v) for v in rec.values()):
            self._pending += 1
        if len(self.records) > self.capacity:
            del self.records[0]
            self.dropped += 1
        if self._pending >= _FLUSH_EVERY:
            self.to_host()

    def to_host(self) -> None:
        """Replace every held tensor by a numpy array: one concatenation
        and one copy per (device, dtype), so one wait for the device."""
        groups: dict[tuple, list[tuple[dict, str, torch.Tensor]]] = {}
        for _, _, rec in self.records:
            for name, v in rec.items():
                if torch.is_tensor(v):
                    groups.setdefault((v.device, v.dtype), []).append(
                        (rec, name, v))
        for items in groups.values():
            flat = torch.cat([v.reshape(-1) for _, _, v in items]).cpu()
            flat = flat.numpy()
            off = 0
            for rec, name, v in items:
                rec[name] = flat[off:off + v.numel()].reshape(tuple(v.shape))
                off += v.numel()
        self._pending = 0

    def __len__(self) -> int:
        return len(self.records)

    def tags(self) -> list[str]:
        return sorted({tag for _, tag, _ in self.records})

    def iter_tag(self, tag: str) -> Iterator[dict[str, np.ndarray]]:
        """The points of ``tag`` in arrival order, one dict per member
        (records are kept in arrival order)."""
        self.to_host()
        for _, t, rec in self.records:
            if t != tag:
                continue
            pts = _points(rec)
            for i in range(max(map(len, pts.values()), default=0)):
                yield {name: v[i] for name, v in pts.items()}

    def trajectory(self, tag: str, name: str) -> np.ndarray:
        """All recorded values of `name` under `tag`, in arrival order,
        one entry per point along a leading axis."""
        return self.to_arrays().get(f"{tag}.{name}", np.empty((0,)))

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flatten to `{tag}.{name}` arrays (the metrics.npz layout)."""
        self.to_host()
        cols: dict[str, list[np.ndarray]] = {}
        for _, tag, rec in self.records:
            for name, v in _points(rec).items():
                cols.setdefault(f"{tag}.{name}", []).append(v)
        return {key: np.concatenate(cols[key]) for key in sorted(cols)}

    def save_npz(self, path: str) -> None:
        np.savez(path, **self.to_arrays())

    def summarize(self) -> str:
        lines = [f"{'metric':<44} {'points':>6} {'last':>12}"]
        for key, arr in sorted(self.to_arrays().items()):
            last = (float(np.asarray(arr[-1]).ravel()[0]) if arr.size
                    else float("nan"))
            lines.append(f"{key:<44} {len(arr):>6} {last:>12.6g}")
        if self.dropped:
            lines.append(f"(ring buffer dropped {self.dropped} oldest "
                         f"records)")
        return "\n".join(lines)


# -- module-global channel (mirrors analysis.sanitizer / obs.trace) ---------

_BUFFER: MetricsBuffer | None = None


def install_buffer(buf: MetricsBuffer | None) -> MetricsBuffer | None:
    """Install the process-wide buffer; returns the previous one."""
    global _BUFFER
    prev, _BUFFER = _BUFFER, buf
    return prev


def get_buffer() -> MetricsBuffer | None:
    return _BUFFER


def record_metrics(tag: str, **values: Any) -> None:
    """Append `values` under `tag` to the installed buffer (a no-op with
    none installed).  Only the ``trace_metrics=True`` path calls it."""
    buf = _BUFFER
    if buf is not None:
        buf.append(tag, {k: v for k, v in values.items() if v is not None})


def update_ratio(old: torch.Tensor, new: torch.Tensor,
                 eps: float = 1e-30) -> torch.Tensor:
    """Mean multiplicative step magnitude |new - old| / |old| over the
    last two axes (one value per member) — the "mu-ratio" trajectory
    (-> 0 as MU converges to a fixed point)."""
    return ((new - old).abs() / (old.abs() + eps)).mean(dim=(-2, -1))
