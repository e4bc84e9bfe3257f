"""RESCALk, the model-selection sweep (paper Alg. 1; port of
``repro/core/rescalk.py:78``): a thin entry point over
``selection.SweepScheduler``.

``rescalk(X, cfg)`` runs the BCSR sweep on one device;
``rescalk(X, cfg, grid=grid)`` runs the dense sweep on the 2D process
grid, the counterpart of ``repro``'s ``rescalk(X, cfg, mesh=mesh)``: every
cell calls it with its block X^(i,j), and every cell gets the same
result.  ``repro``'s custom ``member_runner`` loop, ``mode`` and
``ckpt_dir`` are not ported.
"""
from __future__ import annotations

from repro_torch.selection.scheduler import SweepScheduler
from repro_torch.selection.types import RescalkConfig, RescalkResult

__all__ = ["rescalk"]


def rescalk(X, cfg: RescalkConfig, *, grid=None, draws=None,
            criterion: str = "threshold",
            report_path: str | None = None) -> RescalkResult:
    """The sweep on X: a ``core.sparse.BCSR`` without ``grid``, this
    cell's dense block with it.  ``draws`` defaults to
    ``TorchDraws(cfg.seed)`` on X's device."""
    return SweepScheduler(cfg, criterion=criterion, draws=draws, grid=grid,
                          report_path=report_path).run(X)
