"""Per-iteration metrics (port of ``repro/obs/metrics.py``, host side).

Call sites guard ``record_metrics`` with their ``trace_metrics`` flag, so
the default path computes and records nothing.  With a ``MetricsBuffer``
installed, each call copies its values to the host (a device sync) and
appends one record; with none installed the call is a no-op.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MetricsBuffer", "install_buffer", "record_metrics",
           "update_ratio"]


class MetricsBuffer:
    """Host-side list of (seq, tag, {name: ndarray}) records."""

    def __init__(self):
        self.records: list[tuple[int, str, dict[str, np.ndarray]]] = []

    def append(self, tag: str, values: dict) -> None:
        rec = {name: (v.detach().cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v)) for name, v in values.items()}
        self.records.append((len(self.records), tag, rec))


_buffer: MetricsBuffer | None = None


def install_buffer(buf: MetricsBuffer | None) -> MetricsBuffer | None:
    """Install ``buf`` as the process's metrics sink; returns the previous
    one so callers can restore it."""
    global _buffer
    prev, _buffer = _buffer, buf
    return prev


def record_metrics(tag: str, **values) -> None:
    if _buffer is not None:
        _buffer.append(tag, values)


def update_ratio(A_old: torch.Tensor, A_new: torch.Tensor) -> torch.Tensor:
    """||A_new - A_old|| / ||A_old|| over the last two axes."""
    num = torch.linalg.vector_norm(A_new - A_old, dim=(-2, -1))
    return num / torch.linalg.vector_norm(A_old, dim=(-2, -1)).clamp_min(
        1e-30)
