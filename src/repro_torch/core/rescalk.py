"""RESCALk, the model-selection sweep (paper Alg. 1; port of
``repro/core/rescalk.py:78``): a thin entry point over
``selection.SweepScheduler``.

``rescalk(X, cfg)`` runs the sweep on one device, on a dense (m, n, n)
tensor, a BCSR or a ShardedBCSR (merged once), in the ``mode`` of
``repro``'s (batched, loop, or the cross-k grid in chunks of
``grid_chunk`` cells); ``rescalk(X, cfg, grid=grid)`` runs the sweep on
the 2D process grid, the counterpart of ``repro``'s ``rescalk(X, cfg,
mesh=mesh)``: every cell calls it with its dense block X^(i,j) or its
``CellShard`` of a ShardedBCSR, and every cell gets the same result.
``ckpt_dir``, ``n_pods`` and ``retry`` reach the scheduler either way.
``repro``'s custom ``member_runner`` loop is not ported.
"""
from __future__ import annotations

from repro_torch.selection.scheduler import SweepScheduler
from repro_torch.selection.types import RescalkConfig, RescalkResult

__all__ = ["rescalk"]


def rescalk(X, cfg: RescalkConfig, *, mode: str = "batched",
            grid_chunk: int | None = None, grid=None, draws=None,
            criterion: str = "threshold", ckpt_dir: str | None = None,
            n_pods: int = 1, retry=None,
            report_path: str | None = None) -> RescalkResult:
    """The sweep on X: a dense tensor, a ``core.sparse.BCSR`` or a
    ``ShardedBCSR`` without ``grid``; this cell's dense block or
    ``CellShard`` with it.  ``draws`` defaults to
    ``TorchDraws(cfg.seed)`` on X's device; ``retry`` to two attempts."""
    return SweepScheduler(cfg, mode=mode, grid_chunk=grid_chunk,
                          criterion=criterion, draws=draws, grid=grid,
                          ckpt_dir=ckpt_dir, n_pods=n_pods, retry=retry,
                          report_path=report_path).run(X)
