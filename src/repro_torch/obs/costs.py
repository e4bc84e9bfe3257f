"""Cost accounting — the paper's complexity model vs what actually ran
(port of ``repro/obs/costs.py``, the model half).

Two ingredients, joined per sweep unit:

* **model**: leading-order per-iteration FLOP / HBM-byte counts for one MU
  iteration of one ensemble member (`dense_mu_cost`, `bcsr_mu_cost`) — the
  paper's O(m n^2 k) dense / O(nnz k) sparse complexity claims, written
  down as numbers;
* **wall-clock**: the scheduler's measured per-unit seconds.

`cost_table` produces one row per executed unit with achieved GFLOP/s
(model flops / measured seconds).  ``repro``'s third ingredient, XLA's
cost analysis of a compiled one-iteration program (``measure_mu_costs``),
has no counterpart yet: the port compiles no XLA program, so the table's
``xla_GF`` and ``mdl/xla`` columns print "-".  Everything here runs on the
host after the sweep.
"""
from __future__ import annotations

from typing import Any

__all__ = [
    "bcsr_mu_cost",
    "cost_table",
    "dense_mu_cost",
    "format_cost_table",
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
    `measured` has per-rank flops) the model-vs-measured ratio."""
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
