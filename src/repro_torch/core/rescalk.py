"""RESCALk, the model-selection sweep (paper Alg. 1; port of
``repro/core/rescalk.py``): a thin entry point over
``selection.SweepScheduler``.

``rescalk(X, cfg)`` runs the sweep on one device, on a dense (m, n, n)
tensor, a BCSR or a ShardedBCSR (merged once), in the ``mode`` of
``repro``'s (batched, loop, or the cross-k grid in chunks of
``grid_chunk`` cells); ``rescalk(X, cfg, grid=grid)`` runs the sweep on
the 2D process grid, the counterpart of ``repro``'s ``rescalk(X, cfg,
mesh=mesh)``: every cell calls it with its dense block X^(i,j) or its
``CellShard`` of a ShardedBCSR, and every cell gets the same result.
``ckpt_dir``, ``n_pods`` and ``retry`` reach the scheduler either way.

A custom ``member_runner`` takes ``repro``'s legacy sequential loop
(``_rescalk_loop``) on a dense X: loop mode's members (the same draws,
``selection.ensemble.runner_members``) factorized by the runner, then
the scheduler's own ``reduce_k`` per rank, so the path cannot drift from
the scheduler's.  A runner is called as ``runner(X_q, k, generator, cfg,
init=...)``: X_q the member's perturbed (m, n, n) copy, ``generator`` a
``torch.Generator`` of the member's own stream (seeded from (seed, k,
q), the stream ``TorchDraws`` draws the member's initial factors from),
``init`` the member's initial ``RescalState`` from the sweep's draw
source (its A already NNDSVD's under init="nndsvd"); it returns the
normalized ``RescalState``.  ``select_k`` keeps ``repro``'s 3-array
signature over ``selection.criteria.select_threshold``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.selection.criteria import select_threshold
from repro_torch.selection.types import KResult, RescalkConfig, RescalkResult

from .nndsvd import nndsvd_init_A
from .rescal import RescalState, init_factors, rescal

__all__ = ["KResult", "RescalkConfig", "RescalkResult",
           "default_member_runner", "rescalk", "select_k"]


def default_member_runner(X_q: torch.Tensor, k: int,
                          generator: torch.Generator, cfg: RescalkConfig,
                          init: RescalState | None = None) -> RescalState:
    """Factorize one perturbed tensor X_q (m, n, n): cfg.rescal_iters MU
    iterations of cfg.schedule under cfg.kernel, normalized.  Without
    ``init`` the initial factors are drawn from ``generator``, A replaced
    by X_q's NNDSVD under init="nndsvd" (paper §6.1.3 option 2: it
    anchors every member in one basin)."""
    if init is None:
        m, n, _ = X_q.shape
        init = init_factors(n, m, k, generator=generator, device=X_q.device,
                            dtype=X_q.dtype)
        if cfg.init == "nndsvd":
            init = RescalState(A=nndsvd_init_A(X_q, k).to(X_q.dtype),
                               R=init.R, step=init.step)
    state, _ = rescal(X_q, k, iters=cfg.rescal_iters, schedule=cfg.schedule,
                      init=init, sanitize=cfg.sanitize,
                      trace_metrics=cfg.trace_metrics, policy=cfg.kernel)
    return state


def select_k(ks: Sequence[int], s_min, rel_err,
             sil_threshold: float = 0.75) -> int:
    """``repro``'s 3-array entry point for the paper's threshold rule
    (``selection.criteria.select_threshold``, with its stability x fit
    fallback)."""
    return select_threshold(np.asarray(ks), np.asarray(s_min), None,
                            np.asarray(rel_err), sil_threshold=sil_threshold)


def rescalk(X, cfg: RescalkConfig,
            member_runner: Callable = default_member_runner,
            verbose: bool = False, *, mode: str = "batched",
            grid_chunk: int | None = None, grid=None, draws=None,
            criterion: str = "threshold", ckpt_dir: str | None = None,
            n_pods: int = 1, retry=None,
            report_path: str | None = None) -> RescalkResult:
    """The sweep on X: a dense tensor, a ``core.sparse.BCSR`` or a
    ``ShardedBCSR`` without ``grid``; this cell's dense block or
    ``CellShard`` with it.  ``draws`` defaults to
    ``TorchDraws(cfg.seed)`` on X's device; ``retry`` to two attempts.  A
    non-default ``member_runner`` runs the legacy per-member loop."""
    if member_runner is not default_member_runner:
        # the legacy loop has no scheduler: combining a custom runner with
        # scheduler-only features would silently drop them, so refuse
        dropped = [name for name, val, default in [
            ("mode", mode, "batched"), ("criterion", criterion, "threshold"),
            ("grid", grid, None), ("ckpt_dir", ckpt_dir, None),
            ("grid_chunk", grid_chunk, None), ("n_pods", n_pods, 1),
            ("retry", retry, None), ("report_path", report_path, None)]
            if val != default]
        if dropped:
            raise ValueError(
                f"custom member_runner uses the legacy sequential loop, "
                f"which does not support {dropped}; drop the runner or use "
                f"repro_torch.selection.SweepScheduler directly")
        return _rescalk_loop(X, cfg, member_runner, verbose, draws)
    from repro_torch.selection.scheduler import SweepScheduler
    return SweepScheduler(cfg, mode=mode, grid_chunk=grid_chunk,
                          criterion=criterion, draws=draws, grid=grid,
                          ckpt_dir=ckpt_dir, n_pods=n_pods, retry=retry,
                          report_path=report_path, verbose=verbose).run(X)


def _rescalk_loop(X: torch.Tensor, cfg: RescalkConfig,
                  member_runner: Callable, verbose: bool = False,
                  draws=None) -> RescalkResult:
    """The sequential double loop, kept for custom runners: loop mode's
    members and the scheduler's per-k reduction."""
    from repro_torch.selection.draws import TorchDraws
    from repro_torch.selection.ensemble import runner_members
    from repro_torch.selection.scheduler import reduce_k
    if not torch.is_tensor(X):
        raise TypeError("a custom member_runner factorizes a dense (m, n, "
                        "n) tensor")
    draws = draws if draws is not None else TorchDraws(cfg.seed, X.device)
    ks = cfg.ks
    members = tuple(range(cfg.n_perturbations))
    per_k: dict[int, KResult] = {}
    for k in ks:
        ens = runner_members(X, k, members, cfg, draws, member_runner)
        per_k[k] = reduce_k(X, cfg, k, ens.A, ens.R,
                            ens.errors.cpu().numpy(), draws)
        if verbose:
            r = per_k[k]
            print(f"[rescalk] k={k:3d} s_min={r.s_min:6.3f} "
                  f"s_mean={r.s_mean:6.3f} err={r.rel_err:7.4f}")
    s_min = np.array([per_k[k].s_min for k in ks])
    s_mean = np.array([per_k[k].s_mean for k in ks])
    rel = np.array([per_k[k].rel_err for k in ks])
    k_opt = select_k(ks, s_min, rel, cfg.sil_threshold)
    return RescalkResult(ks=np.asarray(ks), s_min=s_min, s_mean=s_mean,
                         rel_err=rel, k_opt=k_opt, per_k=per_k)
