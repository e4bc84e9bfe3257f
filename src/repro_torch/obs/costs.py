"""Cost accounting — the paper's complexity model vs what actually ran
(port of ``repro/obs/costs.py``).

Three ingredients, joined per sweep unit:

* **model**: leading-order per-iteration FLOP / HBM-byte counts for one MU
  iteration of one ensemble member (`dense_mu_cost`, `bcsr_mu_cost`) — the
  paper's O(m n^2 k) dense / O(nnz k) sparse complexity claims, written
  down as numbers;
* **counted**: the port's own one-iteration, one-member MU step
  (`mu_program`) run on the operand under
  ``launch.step_costs.StepCounter`` (`measure_mu_costs`), ``repro``'s
  XLA cost analysis of its AOT-compiled program in the port: every aten
  op, every kernel launch's own work, the same on the card, the CPU and
  meta tensors (where nothing is allocated);
* **wall-clock**: the scheduler's measured per-unit seconds.

`cost_table` produces one row per executed unit with achieved GFLOP/s
(model flops / measured seconds) and the model-vs-counted flop ratio —
the check that the implementation concurs with the theoretical
complexities.  The counted columns keep ``repro``'s names (``xla_gflop``,
``model_vs_xla``, ``xla_GF``, ``mdl/xla``): in the port they hold the
counted step.  Everything here runs on the host after the sweep.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = [
    "bcsr_mu_cost",
    "cost_table",
    "dense_mu_cost",
    "format_cost_table",
    "measure_mu_costs",
    "mu_program",
    "operand_mu_cost",
    "unit_ks",
]


def dense_mu_cost(n: int, m: int, k: int,
                  dtype_bytes: int = 4) -> dict[str, float]:
    """Leading-order cost of ONE dense MU iteration for ONE member.

    The X-sided contractions dominate: the batched step reads X three times
    (XA for update_R, XA + X^T A for update_A), each 2·m·n²·k flops; the
    k-sided Gram/regression terms add O(m·n·k²).
    """
    flops = 6.0 * m * n * n * k + 8.0 * m * n * k * k
    bytes_ = 3.0 * m * n * n * dtype_bytes
    return {"flops": flops, "bytes": bytes_}


def bcsr_mu_cost(m: int, nnzb: int, bs: int, k: int,
                 dtype_bytes: int = 4) -> dict[str, float]:
    """Leading-order cost of ONE BCSR MU iteration for ONE member: three
    passes over the stored blocks (two in one with the fused kernel, but we
    model work, not passes), each 2·m·nnzb·bs²·k flops."""
    flops = 6.0 * m * nnzb * bs * bs * k
    bytes_ = 3.0 * m * nnzb * bs * bs * dtype_bytes
    return {"flops": flops, "bytes": bytes_}


def operand_mu_cost(operand: Any, k: int,
                    dtype_bytes: int = 4) -> dict[str, float]:
    """Dispatch the model on the operand type (dense tensor vs BCSR)."""
    if hasattr(operand, "nnzb"):  # BCSR duck type
        return bcsr_mu_cost(operand.m, operand.nnzb, operand.bs, k,
                            dtype_bytes)
    m, n = operand.shape[0], operand.shape[1]
    return dense_mu_cost(n, m, k, dtype_bytes)


def mu_program(operand: Any, k: int, *, eps: float | None = None,
               policy=None) -> Callable[[], Any]:
    """The one-iteration, one-member MU step at rank ``k`` (``repro``'s
    ``aot_mu_program``): a callable that runs it on ``operand``, with
    its factors allocated on the operand's device.  On a meta operand
    (``BCSR.on_meta()``, a meta tensor) nothing is allocated; on the card
    it runs one iteration and counts the same (``launch.step_costs``)
    with no meta op, whose Python kernels import ``torch._dynamo`` and
    sympy (seconds, once per process).  A dense operand ([r,] m, n, n)
    runs ``core.rescal.mu_step_batched``, a BCSR
    ``core.sparse.sparse_mu_step`` (the first member of a member stack
    each), both under ``policy`` (default: the fused kernels, the card's
    path)."""
    import torch

    from repro_torch.core.rescal import EPS_DEFAULT, RescalState, \
        mu_step_batched
    from repro_torch.core.sparse import BCSR, sparse_mu_step
    from repro_torch.kernels.policy import KernelPolicy

    policy = policy or KernelPolicy(use_fused=True)
    eps = EPS_DEFAULT if eps is None else eps
    if isinstance(operand, BCSR):
        sp = operand.with_data(operand.data[0]) if operand.batch_shape \
            else operand
        dt, m, n, dev = sp.data.dtype, sp.m, sp.n, sp.data.device

        def step():
            A = torch.empty((n, k), dtype=dt, device=dev)
            R = torch.empty((m, k, k), dtype=dt, device=dev)
            return sparse_mu_step(sp, A, R, eps, policy=policy)
        return step
    m, n = operand.shape[-3], operand.shape[-1]
    X = operand if operand.dim() == 3 else operand.reshape(-1, m, n, n)[0]
    dt, dev = X.dtype, X.device

    def step():
        state = RescalState(A=torch.empty((n, k), dtype=dt, device=dev),
                            R=torch.empty((m, k, k), dtype=dt, device=dev),
                            step=0)
        return mu_step_batched(X, state, eps, policy=policy)
    return step


def measure_mu_costs(operand: Any, ks: list[int], *,
                     eps: float | None = None,
                     policy=None) -> dict[int, dict[str, float]]:
    """The counted cost of `mu_program` per rank, ``repro``'s keys:
    {k: {"flops", "bytes accessed"}}; {} for a rank the card's kernels
    refuse under a policy that reaches them (k above ``MAX_K``, or a BCSR
    block size they do not take), as ``repro`` leaves a rank without an
    analysis, and callers treat the column as optional."""
    from repro_torch.kernels._launch import MAX_K, block_size_ok
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.step_costs import StepCounter

    policy = policy or KernelPolicy(use_fused=True)
    bs = getattr(operand, "bs", None)
    on_kernels = policy.use_fused and policy.impl != "ref"
    refused = on_kernels and bs is not None and not block_size_ok(bs)
    out: dict[int, dict[str, float]] = {}
    for k in ks:
        if refused or (on_kernels and k > MAX_K):
            out[k] = {}
            continue
        step = mu_program(operand, k, eps=eps, policy=policy)
        with StepCounter() as c:
            step()
        out[k] = {"flops": float(c.flops), "bytes accessed": float(c.bytes)}
    return out


def unit_ks(rec: Any) -> list[int]:
    """Ranks of every (k, q) cell a unit record covers (grid chunks carry
    explicit cells; per-k units repeat k per member)."""
    cells = getattr(rec, "cells", None)
    if cells:
        return [int(c[0]) for c in cells]
    return [int(rec.k)] * len(rec.members)


def cost_table(records: list[Any], operand: Any, *, iters: int,
               measured: dict[int, dict[str, float]] | None = None,
               dtype_bytes: int = 4) -> list[dict[str, Any]]:
    """One row per unit record: model flops/bytes for all its cells over
    all iterations, achieved GFLOP/s from measured seconds, and (when
    `measured` has per-rank flops, `measure_mu_costs`) the model-vs-counted
    ratio."""
    rows: list[dict[str, Any]] = []
    for rec in records:
        ks = unit_ks(rec)
        model_flops = sum(
            operand_mu_cost(operand, k, dtype_bytes)["flops"] for k in ks
        ) * iters
        model_bytes = sum(
            operand_mu_cost(operand, k, dtype_bytes)["bytes"] for k in ks
        ) * iters
        xla_flops = None
        if measured:
            per_cell = [measured.get(k, {}).get("flops") for k in ks]
            if all(v is not None for v in per_cell):
                xla_flops = sum(per_cell) * iters
        seconds = float(rec.seconds)
        achieved = model_flops / seconds / 1e9 if seconds > 0 else None
        rows.append({
            "uid": rec.uid,
            "cells": len(ks),
            "seconds": seconds,
            "reused": bool(rec.reused),
            "model_gflop": model_flops / 1e9,
            "model_gbyte": model_bytes / 1e9,
            "xla_gflop": None if xla_flops is None else xla_flops / 1e9,
            "achieved_gflops": achieved,
            "model_vs_xla": (model_flops / xla_flops
                             if xla_flops else None),
        })
    return rows


def format_cost_table(rows: list[dict[str, Any]]) -> str:
    """Human-readable achieved-vs-theoretical utilization table."""
    hdr = (f"{'unit':<26} {'cells':>5} {'sec':>8} {'model_GF':>9} "
           f"{'xla_GF':>9} {'GF/s':>8} {'mdl/xla':>7}")
    lines = [hdr, "-" * len(hdr)]

    def fmt(v, spec):
        return format(v, spec) if v is not None else "-"

    for r in rows:
        sec = "reused" if r["reused"] else f"{r['seconds']:.3f}"
        lines.append(
            f"{r['uid']:<26} {r['cells']:>5} {sec:>8} "
            f"{r['model_gflop']:>9.3f} {fmt(r['xla_gflop'], '9.3f'):>9} "
            f"{fmt(None if r['reused'] else r['achieved_gflops'], '8.2f'):>8} "
            f"{fmt(r['model_vs_xla'], '7.2f'):>7}")
    return "\n".join(lines)
