"""Multi-pod dry run: one rank's memory plan and counted step costs for
every (architecture x input shape) cell on the production grids (the
port of ``repro/launch/dryrun.py``).

``repro`` lowers and compiles each cell on a 256- or 512-device mesh of
``ShapeDtypeStruct``s and reads XLA's memory and cost analyses.  The port
compiles no program, so it plans and counts instead: each cell is laid
out for one rank of the production grid (``launch.mesh.PRODUCTION``: 16 x
16, or 2 x 16 x 16 with ``--multi-pod``) by ``Grid.at_rank(rank, pods,
16, 16, "meta")``, with no process group and nothing allocated.  The
plan counts the bytes that rank holds from the port's own code:

RESCAL cells (``--arch rescal-*``, one MU iteration of ``dist/engine.py``
under the fused kernel policy, ``--rescal-schedule`` and
``--rescal-comm-dtype`` as ``repro``'s):

  argument   the local operand (a dense X^(i,j) (m, n/g, n/g), or the
             balanced BCSR shard of nnzb_loc = max(int(nb^2 density) //
             g^2, 1) blocks with its block_rows, block_cols and row_ptr),
             A^(i) and R; with ``--multi-pod`` this pod's share of the
             ``ENSEMBLE_R`` members (a member axis of 1)
  output     the new A^(i) and R
  temp       the rest of the step's peak: every buffer the body for the
             operand and schedule (``_mu_iter_batched``, ``_mu_iter_sliced``,
             ``_mu_iter_batched_sparse``, ``_mu_iter_sliced_sparse``)
             holds there, statement by statement (``rescal_ledger``),
             with the kernels' own scratch: ``fused_xa_xtb``'s workspace
             (``fused_bilinear.workspace_floats``: the split factor
             fragments and the fixed-order partials) fp32 and
             ``bcsr_xa_xta``'s (T, nnzb, bs, kc) partials, T =
             members x slices in the launch, and B's operand tiles:
             the batched call's own, or the sliced body's, tiled once
             before the slices and held through them
  collectives the count and payload bytes per MU iteration that the body
             issues through ``Grid`` (6 batched, 2 + 4m sliced): the
             counted step's must be the same

LM cells (``--arch`` of the zoo, ``--shape`` of ``SHAPES``): a cell
``cfg.supports`` refuses is ``skipped`` with its reason, as ``repro``'s;
a cell the port's ``GridTransformer`` refuses (its ``GridRefusal`` from
``check_rows`` or ``init_cache``'s multiple of the model axis) is
``refused`` with its message; any other error is raised.  Otherwise, for the largest rank (ZeRO-1 gives the data ranks
different moments):

  params     every parameter's block (``LMPlacement.local_shape``)
  grads      train: the same blocks, in the parameters' dtype
  moments    train: the fp32 AdamW moments of the part this rank owns
             (``opt_state_specs``, ``LMPlacement.owned``), twice; with
             microbatches, the fp32 accumulator of that part
  cache      decode: the cache's block (``GridTransformer.init_cache``,
             ``cache_specs``), counted once: it is updated in place
             (``alias``), as ``repro`` counts its donated cache
  batch      this rank's rows of the batch (``batch_shardings``), token
             ids int64 as the port feeds them
  temp       an estimate of the step's largest transient, per local
             microbatch of b rows, S positions, a bytes per activation:
             train   (accumulator +) L b S d a (``--remat``'s block
                     inputs) + max(grads + one layer, the loss), where
                     one layer is the chunked attention's saved tiles
                     (three fp32 (b, H_l, 256, 1024) score tiles and the
                     fp32 K and V tiles per visited tile pair, and one
                     score tile's gradient in the backward) plus its
                     projections and MLP, b S ((4 d + (H_l + 2 Hkv_l) D
                     + 3 F_l) a), and the loss's backward b S V_l 5 x 4
                     (the saved fp32 logits, and its exp, difference,
                     product and scattered target gradient, fp32, before
                     any parameter's gradient exists); without
                     ``--remat`` L layers + max(grads, the loss)
             prefill one layer's projections and MLP (the kernel keeps
                     no scores)
             decode  one layer's fp32 cache casts and scores, b (2 S_l
                     Hkv_l D + 2 H_l S_l) 4, and the logits b V 4
             with experts, the MoE's buffers of one layer by
             ``--moe-impl``: einsum T E C_g a 2 + E_l C G (d + 2 F) a,
             scatter E_l C (d + 2 F) a, dense T E_l 2 F a (T tokens, C
             the capacity, G groups)

The step itself runs for that rank on meta tensors and a recording grid
(``Grid(record=True)``) under ``launch.step_costs.StepCounter``:
``count_rescal`` (one MU iteration of the fused engine at the share's
shapes; its collectives must equal the ledger's, or the cell raises) and
``count_lm`` (the train step with gradients, AdamW and ZeRO-1, the
prefill, or one decode step of ``GridTransformer``; counted on a few
layers with trip counts, ``layer_kinds``).  They fill ``repro``'s
loop-aware fields: ``flops_per_device``, ``bytes_per_device``, ``ops``
(the op histogram, kernel launches as ``kernel:<name>``) and
``collectives`` (``repro``'s shape: the total's count, result and wire
bytes, each kind's count and wire bytes, with the port's ``by_axis`` and
``per``), and ``count_s``.  An LM step that cannot run on meta leaves
them null with ``count_error``, never 0.

Each cell's JSON has ``repro``'s keys.  ``memory`` holds argument,
output, temp, alias, peak and total (total = argument + output + temp -
alias = peak), and the fit: ``fits_h100_80gb`` against ``card_bytes``
(``launch.mesh.CARD_HBM_BYTES``), true only when the total with
``fit_margin`` on top fits, false when the total alone does not, and
null (unestablished) between.  An LM cell's margin is how far the plan
fell short of a measured peak of its kind (``LM_PLAN_SHORTFALL``); a
RESCAL cell's is 0 (its plan is held to the card's peak within 1%,
output and temp to its step's own allocations).  What only XLA can give
is null, never 0: ``compile_s``, ``xla_flops_raw`` and
``xla_bytes_raw``.  ``model_flops_global`` is ``repro``'s formula
(``rescal_model_flops``; ``models.model.model_flops``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch rescal-dense-3tb --multi-pod
  python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import multiprocessing
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

from repro_torch.configs import (ARCHS, RESCAL_CONFIGS, SHAPES, RescalConfig,
                                 ShapeSpec, get_config, input_specs)
from repro_torch.core.sparse import BCSR
from repro_torch.dist.engine import DistRescalConfig, make_mu_step
from repro_torch.dist.sharding import (COL_AXIS, ROW_AXIS, Grid,
                                       batch_shardings, cache_specs,
                                       local_block)
from repro_torch.kernels import fused_bilinear
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch.mesh import CARD_HBM_BYTES, CARD_NAME, PRODUCTION
from repro_torch.launch.step_costs import StepCounter
from repro_torch.models import model as model_lib
from repro_torch.models.moe import capacity, tokens_per_group
from repro_torch.models.transformer import (READONLY, TRAIN_Q_CHUNK,
                                            GridRefusal, GridTransformer,
                                            Transformer, head_dim,
                                            lm_placement)
from repro_torch.optim import AdamW
from repro_torch.train.serve_step import (make_prefill_step, make_serve_step,
                                          params_shardings)
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          zero1_moments)

RESCAL_SHAPE = ShapeSpec("mu_iter", "rescal", 0, 0)
ENSEMBLE_R = 2            # repro's ensemble members on the multi-pod grid
FIT_KEY = "fits_h100_80gb"
META = torch.device("meta")
F32 = 4
KV_CHUNK = 1024           # the chunked attention's key tile
LOSS_F32 = 5              # fp32 (tokens, V_l) buffers at the loss's backward
XLA_ONLY = ("compile_s", "xla_flops_raw", "xla_bytes_raw")
COUNTED = ("flops_per_device", "bytes_per_device", "ops", "collectives")
# How far the LM plan may fall short of a step's peak, by step kind: the
# largest shortfall measured, with room.  Train: llama3.2-1b at 4 x 4096
# with --remat (the loss's backward the peak) 55.46 GB planned against
# 55.86 GB on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phases
# 13 and 17); cells whose chunked-attention tiles are the peak up to 1.4%
# short of the CPU live-bytes count (tests/test_torch_dryrun.py).
# Serve, on that card (phases 8, 14 and 17): llama3.2-1b 4.19 / 4.28 GB,
# deepseek-moe-16b 39.04 / 41.25 GB; decode was measured only inside
# those runs and takes their margin.
LM_PLAN_SHORTFALL = {"train": 0.05, "prefill": 0.06, "decode": 0.06}


def grid_shape(multi_pod: bool) -> tuple[int, int, int]:
    """(pods, data, model) of the production grid."""
    pods, data, model = PRODUCTION[multi_pod]
    return pods or 1, data, model


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nbytes(shape, itemsize: int) -> int:
    return math.prod(shape) * itemsize


# ---------------------------------------------------------------------------
# RESCAL cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RescalShare:
    """What one rank of a RESCAL cell holds: the operand and the factors'
    local shapes (``members`` None: no member axis)."""
    operand: str              # "dense" | "bcsr"
    schedule: str
    m: int
    nl: int                   # local rows n / g
    k: int
    members: int | None
    bs: int = 0
    nnzb: int = 0             # stored blocks per slice (bcsr)

    @property
    def r(self) -> int:
        return self.members or 1

    @property
    def nb(self) -> int:
        return _cdiv(self.nl, self.bs) if self.bs else 0

    @property
    def n_pad(self) -> int:
        return self.nb * self.bs if self.bs else self.nl

    @property
    def a_bytes(self) -> int:
        return self.r * self.nl * self.k * F32

    def arguments(self) -> dict[str, int]:
        """The local operand and factors, by term."""
        out = {}
        if self.operand == "dense":
            out["X block"] = _nbytes((self.m, self.nl, self.nl), F32)
        else:
            out["BCSR data"] = _nbytes((self.m, self.nnzb, self.bs,
                                        self.bs), F32)
            out["BCSR index"] = (2 * self.nnzb + self.nb + 1) * 4
        out["A^(i)"] = self.a_bytes
        out["R"] = _nbytes((self.r, self.m, self.k, self.k), F32)
        return out

    def outputs(self) -> dict[str, int]:
        return {"A^(i) new": self.a_bytes,
                "R new": _nbytes((self.r, self.m, self.k, self.k), F32)}


def rescal_share(rcfg: RescalConfig, g: int, pods: int = 1
                 ) -> RescalShare:
    """One rank's share of ``rcfg`` on a (pods, g, g) grid, as ``repro``'s
    ``lower_rescal_cell`` shapes it: with pods > 1 the ensemble's members
    split over the pods (a member axis); the sparse operand is the
    balanced shard of ``max(int(nb^2 density) // g^2, 1)`` blocks."""
    if rcfg.n % g:
        raise ValueError(f"{rcfg.name}: n={rcfg.n} does not divide the "
                         f"{g} x {g} grid")
    members = None
    if pods > 1:
        if ENSEMBLE_R % pods:
            raise ValueError(f"{ENSEMBLE_R} members do not split over "
                             f"{pods} pods")
        members = ENSEMBLE_R // pods
    nl = rcfg.n // g
    if not rcfg.sparse:
        return RescalShare("dense", rcfg.schedule, rcfg.m, nl, rcfg.k,
                           members)
    bs = rcfg.block_size
    nb = rcfg.n // bs
    nnzb_total = max(int(nb * nb * rcfg.block_density), g * g)
    return RescalShare("bcsr", rcfg.schedule, rcfg.m, nl, rcfg.k, members,
                       bs=bs, nnzb=max(nnzb_total // (g * g), 1))


class Ledger:
    """The live bytes of one rank's step, statement by statement, as
    Python frees them: a statement's temporaries die when it ends, and a
    rebound name's old value once the statement has made the new one.
    Records the peak, what was live there, and every collective."""

    def __init__(self):
        self.vars: dict[str, int] = {}
        self.tmps: dict[str, int] = {}
        self.pending: dict[str, int] = {}
        self.live = self.peak = 0
        self.at: dict[str, int] = {}
        self.collectives: list[tuple[str, int]] = []

    def _grow(self, label: str, nbytes: int) -> None:
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live
            self.at = {**self.vars, **self.tmps}
            for name, b in self.pending.items():
                self.at[f"{name} (new)"] = b
            self.at[label] = self.at.get(label, 0) + nbytes

    def tmp(self, label: str, nbytes: int) -> None:
        """A temporary of the current statement."""
        self._grow(label, nbytes)
        self.tmps[label] = self.tmps.get(label, 0) + nbytes

    def scratch(self, label: str, nbytes: int) -> None:
        """Allocated and freed inside a call (a kernel's workspace)."""
        self._grow(label, nbytes)
        self.live -= nbytes

    def release(self, label: str) -> None:
        """A temporary freed before its statement ends (a callee's
        local)."""
        self.live -= self.tmps.pop(label)

    def new(self, name: str, nbytes: int) -> None:
        """A result of the current statement, bound to ``name`` at its
        end."""
        self._grow(f"{name} (new)", nbytes)
        self.pending[name] = nbytes

    def end(self, **binds: int) -> None:
        """Ends the statement: ``binds`` made last, then the temporaries
        and the rebound names' old values freed."""
        for name, nbytes in binds.items():
            self.new(name, nbytes)
        self.live -= sum(self.tmps.values())
        self.tmps = {}
        for name, nbytes in self.pending.items():
            self.live -= self.vars.pop(name, 0)
            self.vars[name] = nbytes
        self.pending = {}

    def psum(self, name: str | None, nbytes: int, axis: str,
             comm_bytes: int | None, contrib: bool = False) -> None:
        """``Grid.psum_cast`` of an ``nbytes`` fp32 tensor: a copy (on the
        wire in the comm dtype, then cast back), bound to ``name`` at the
        statement's end (None: a temporary of the statement).
        ``contrib``: the diagonal broadcasts' zero contribution of an
        off-diagonal cell, one more temporary."""
        if contrib:
            self.tmp(f"{name or axis} zero contribution", nbytes)
        wire = nbytes if comm_bytes is None else nbytes // F32 * comm_bytes
        if comm_bytes is not None:
            self.tmp(f"{name or axis} on the wire", wire)
        self.collectives.append((axis, wire))
        if name is None:
            self.tmp(f"{axis} psum", nbytes)
        else:
            self.new(name, nbytes)


def _tiles(sh: RescalShare, kc: int) -> int:
    """``bcsr_fused.operand_tiles``'s output: (ceil(k / kc), r, n_pad,
    kc) fp32."""
    return _cdiv(sh.k, kc) * sh.r * sh.n_pad * kc * F32


def _operand_tiles(L: Ledger, sh: RescalShare, bind: bool) -> None:
    """B1's and B2's operand tiles (``bcsr_fused.operand_tiles``), each
    gathered by the swizzle from a zero-padded copy, through a permuted
    copy of it when k takes more than one column slice, all alive at the
    gather: temporaries of a call, or with ``bind`` the results of the
    sliced body's ``prepare_products``."""
    kc = 4 if sh.k <= 4 else 8
    tiles = _tiles(sh, kc)
    n_copies = 2 if _cdiv(sh.k, kc) > 1 else 1
    for name in ("B1 tiles", "B2 tiles"):
        copies = f"{name}' padded and permuted copies"
        L.tmp(copies, n_copies * tiles)
        (L.new if bind else L.tmp)(name, tiles)
        L.release(copies)


def _bcsr_call(L: Ledger, sh: RescalShare, m: int, xa: str, xtb: str,
               tiled: bool) -> None:
    """``bcsr_xa_xta`` on ``m`` slices (kernels/bcsr_fused.py): B's
    operand tiles unless the call was handed them (``tiled``), then XA
    (T, n_pad, k), XTB (T, n_pad, kt) and the (T, nnzb, bs, kc) partials,
    T = r m; the call's tiles and partials die with it."""
    kc = 4 if sh.k <= 4 else 8
    T = sh.r * m
    kt = _cdiv(sh.k, 4) * 4
    if not tiled:
        _operand_tiles(L, sh, bind=False)
    L.new(xa, T * sh.n_pad * sh.k * F32)
    L.new(xtb, T * sh.n_pad * kt * F32)
    L.tmp("XTB partials", T * sh.nnzb * sh.bs * kc * F32)
    L.end()


def _fused_call(L: Ledger, sh: RescalShare, m: int, xa: str,
                xtb: str) -> None:
    """``fused_xa_xtb`` on ``m`` slices: XA and XTB (T, n, k), then its
    workspace (``fused_bilinear.workspace_floats``: B1 = A^(j) per member,
    B2 = A^(i) per member and shared by the slices)."""
    T = sh.r * m
    L.new(xa, T * sh.nl * sh.k * F32)
    L.new(xtb, T * sh.nl * sh.k * F32)
    L.scratch("fused_xa_xtb workspace", F32 * fused_bilinear.workspace_floats(
        T, sh.nl, sh.nl, sh.k, b1_groups=sh.r, b2_groups=sh.r))
    L.end()


def rescal_ledger(sh: RescalShare, *, diagonal: bool,
                  comm_dtype: str | None = None) -> Ledger:
    """One MU iteration of the fused engine body for ``sh``'s operand and
    schedule, on a diagonal cell (i == j) or not, statement by statement
    (``dist/engine.py``)."""
    L = Ledger()
    cb = None if comm_dtype is None else \
        torch.empty((), dtype=getattr(torch, comm_dtype)).element_size()
    A = sh.a_bytes
    KK = sh.r * sh.k * sh.k * F32
    MKK = sh.m * KK
    M = sh.m * A
    off = not diagonal
    sparse = sh.operand == "bcsr"

    L.psum("Aj", A, ROW_AXIS, cb, contrib=off)          # diag_row_to_col
    L.end()
    L.tmp("gram", KK)
    L.psum("G", KK, ROW_AXIS, cb)
    L.end()
    if sh.schedule == "batched":
        if sparse:
            _bcsr_call(L, sh, sh.m, "XA_loc", "XTA_loc", tiled=False)
        else:
            _fused_call(L, sh, sh.m, "XA_loc", "XTA_loc")
        L.psum("XA", M, COL_AXIS, cb)
        L.end()
        L.tmp("A^T XA", MKK)
        L.psum("ATXA", MKK, ROW_AXIS, cb)
        L.end()
        L.tmp("R update terms", 3 * MKK)    # R ATXA, G R, G R G
        L.release("R update terms")
        L.tmp("R update parts", 2 * MKK)    # R ATXA, G R G + eps
        L.end(R=MKK)
        L.tmp("XA permuted for xart", M)                # einsum's copies
        L.tmp("R permuted for xart", MKK)
        L.end(XART=A)
        L.tmp("XTA permuted for the contraction", M)
        L.tmp("R permuted for the contraction", MKK)
        L.tmp("XTA R", A)
        L.release("XTA permuted for the contraction")   # einsum's own
        L.release("R permuted for the contraction")
        L.psum("XTAR_j", A, ROW_AXIS, cb)
        L.end()
        L.psum("XTAR", A, COL_AXIS, cb, contrib=off)    # diag_col_to_row
        L.end()
        L.end(num=A)
        L.tmp("S terms", KK + 2 * MKK)      # one sum, R G, R G R^T
        L.release("S terms")
        L.tmp("S parts", 2 * KK)
        L.end(S=KK)
    else:
        L.end(R=MKK, num=A, S=KK)                       # clone, zeros
        if sparse:                  # held through the slices
            _operand_tiles(L, sh, bind=True)
            L.end()
        for _ in range(sh.m):
            if sparse:
                _bcsr_call(L, sh, 1, "XA_loc", "XTA_loc", tiled=True)
            else:
                _fused_call(L, sh, 1, "XA_loc", "XTA_loc")
            L.psum("XA", A, COL_AXIS, cb)
            L.end()
            L.tmp("A^T XA", KK)
            L.psum("ATXA", KK, ROW_AXIS, cb)
            L.end()
            # the old Rt lives on in RtT until the new one is made
            L.tmp("Rt terms", 3 * KK)           # Rt ATXA, G Rt, G Rt G
            L.release("Rt terms")
            L.tmp("Rt parts", 2 * KK)
            L.end(Rt=KK)
            L.end(XART=A)
            L.tmp("XTA Rt", A)
            L.psum("XTAR_j", A, ROW_AXIS, cb)
            L.end()
            L.psum("XTAR", A, COL_AXIS, cb, contrib=off)
            L.end()
            L.tmp("num + XART", A)
            L.end(num=A)
            L.tmp("S terms", 3 * KK)            # S + Rt G Rt^T, Rt^T G, ..
            L.release("S terms")
            L.tmp("S parts", 2 * KK)
            L.end(S=KK)
    L.end(A_new=A)                                      # mu_update_a
    return L


def rescal_model_flops(rcfg: RescalConfig) -> float:
    """Useful FLOPs of one MU iteration (``repro``'s formula: both X-sided
    products dominate)."""
    n, m, k = rcfg.n, rcfg.m, rcfg.k
    if rcfg.sparse:
        nb = n // rcfg.block_size
        nnz = int(nb * nb * rcfg.block_density) * rcfg.block_size ** 2
        x_terms = 4.0 * m * nnz * k
    else:
        x_terms = 4.0 * m * float(n) * n * k
    small = 8.0 * m * n * k * k + 6.0 * m * k ** 3
    return x_terms + small


def fits(total: int, margin: float) -> bool | None:
    """True when ``total`` with ``margin`` on top fits the card, False
    when ``total`` alone does not, None (unestablished) between."""
    if total > CARD_HBM_BYTES:
        return False
    return True if total * (1 + margin) <= CARD_HBM_BYTES else None


def _memory(argument: int, output: int, temp: int, alias: int = 0,
            margin: float = 0.0) -> dict:
    total = argument + output + temp - alias
    return {"argument": argument, "output": output, "temp": temp,
            "alias": alias, "peak": total, "total": total,
            "peak_estimated": True, FIT_KEY: fits(total, margin),
            "fit_margin": margin, "card": CARD_NAME,
            "card_bytes": CARD_HBM_BYTES}


def plan_rescal(rcfg: RescalConfig, g: int, pods: int = 1, *,
                comm_dtype: str | None = None) -> dict:
    """The plan of one MU iteration of ``rcfg`` for the largest rank of a
    (pods, g, g) grid: ``memory``, its ``terms`` at the peak,
    ``collectives`` per MU iteration, the local shapes and that rank."""
    sh = rescal_share(rcfg, g, pods)
    args, outs = sh.arguments(), sh.outputs()
    best = None
    # a diagonal cell (rank 0) and, on a grid of several, an off-diagonal
    # one (rank 1), whose diagonal broadcasts add a zero contribution
    for rank in ((0, 1) if g > 1 else (0,)):
        cell = Grid.at_rank(rank, pods, g, g, META)
        led = rescal_ledger(sh, diagonal=cell.i == cell.j,
                            comm_dtype=comm_dtype)
        if best is None or led.peak > best[1].peak:
            best = (rank, led)
    rank, led = best
    output = sum(outs.values())
    argument = sum(args.values())
    temp = led.peak - output
    by_axis: dict[str, dict] = {}
    for axis, nbytes in led.collectives:
        e = by_axis.setdefault(axis, {"count": 0, "payload_bytes": 0})
        e["count"] += 1
        e["payload_bytes"] += nbytes
    return {
        "rank": rank,
        "memory": _memory(argument, output, temp),
        "terms": {**args, **{f"temp: {k}": v for k, v in led.at.items()}},
        "collectives": {"count": len(led.collectives),
                        "payload_bytes": sum(b for _, b in led.collectives),
                        "by_axis": by_axis, "per": "MU iteration"},
        "local": dataclasses.asdict(sh) | {"n_pad": sh.n_pad},
    }


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _meta_like(x: torch.Tensor, dtype: torch.dtype | None = None):
    return torch.empty(x.shape, dtype=dtype or x.dtype, device=META)


def _lm_batch(cfg, spec: ShapeSpec, grid: Grid) -> dict[str, torch.Tensor]:
    """This cell's rows of the batch (``batch_shardings``), token ids in
    the port's int64."""
    specs = input_specs(cfg, spec)
    batch = specs["batch"] if "batch" in specs else {"tokens":
                                                     specs["tokens"]}
    placed = batch_shardings(grid, batch)
    out = {}
    for key, x in batch.items():
        dt = torch.int64 if x.dtype == torch.int32 else x.dtype
        out[key] = _meta_like(local_block(grid, x, placed[key]), dt)
    return out


def _attn_pairs(S: int, q_chunk: int = TRAIN_Q_CHUNK,
                chunk: int = KV_CHUNK) -> int:
    """(q tile, kv tile) pairs the causal chunked attention visits."""
    chunk, q_chunk = min(chunk, S), min(q_chunk, S)
    return sum(min(_cdiv(q0 + min(q_chunk, S - q0), chunk), _cdiv(S, chunk))
               for q0 in range(0, S, q_chunk))


def _moe_temp(cfg, gm: GridTransformer, tokens: int, moe_impl: str,
              a: int) -> int:
    """One MoE layer's buffers (the module docstring's formula)."""
    E, k, d, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    M = gm.tp.size
    E_l = E // M if gm.moe_plan.experts == "expert" else E
    F_l = F // M if gm.moe_plan.experts == "ff" else F
    if moe_impl == "dense":
        return tokens * E_l * 2 * F_l * a
    if moe_impl == "scatter":
        C = capacity(tokens, k, E, 1.25)
        return E_l * C * (d + 2 * F_l) * a
    gs = tokens_per_group(tokens)
    C = capacity(gs, k, E, 1.25)
    groups = tokens // gs
    return tokens * E * C * a * 2 + E_l * C * groups * (d + 2 * F_l) * a


def _lm_temp(cfg, gm: GridTransformer, kind: str, b: int, S: int, *,
             remat: bool, moe_impl: str, cache_positions: int = 0,
             grads: int = 0) -> int:
    """The step's largest transient beside the state (the module
    docstring's formulas); ``grads``: the gradients' bytes (train)."""
    a = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    M = gm.tp.size
    d, L = cfg.d_model, cfg.n_layers
    H = cfg.n_heads
    D = head_dim(cfg) if H else 0
    H_l = H // M if H and H % M == 0 else H
    Hkv_l = cfg.n_kv // M if cfg.n_kv and cfg.n_kv % M == 0 else cfg.n_kv
    F = cfg.d_ff
    F_l = F // M if gm.mlp_sharded else F
    V = cfg.padded_vocab
    V_l = V // M if gm.vocab_sharded else V
    tokens = b if kind == "decode" else b * S
    moe = (_moe_temp(cfg, gm, tokens, moe_impl, a) if cfg.n_experts
           else 0)
    proj = tokens * (4 * d + (H_l + 2 * Hkv_l) * D + 3 * F_l) * a + moe
    if kind == "decode":
        S_l = cache_positions
        return (b * (2 * S_l * Hkv_l * D + 2 * H_l * S_l) * F32
                + b * V * F32 + proj)
    if kind == "prefill":
        return proj
    qc = min(TRAIN_Q_CHUNK, S)
    kc = min(KV_CHUNK, S)
    # the saved tiles of every visited pair, and the gradient of the one
    # the backward is working on
    tiles = (_attn_pairs(S) * b * (3 * H_l * qc * kc + 2 * kc * H_l * D)
             + b * H_l * qc * kc) * F32
    layer = (tiles if H else 0) + proj
    loss = tokens * V_l * LOSS_F32 * F32
    saved = L * tokens * d * a
    if remat:
        return saved + max(grads + layer, loss)
    return L * layer + max(grads, loss)


def _param_bytes(model: Transformer) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _owned_bytes(cfg, grid: Grid, model: Transformer) -> int:
    """fp32 elements of the parameter parts whose moments this cell owns
    (ZeRO-1), in bytes of one fp32 copy."""
    pl = lm_placement(grid, cfg)
    total = 0
    for name, p in model.named_parameters():
        part = pl.owned(name, p.detach())
        if part is not None:
            total += part.numel() * F32
    return total


def plan_lm(cfg, spec: ShapeSpec, pods: int, data: int, model: int, *,
            remat: bool = True, moe_impl: str = "einsum") -> dict:
    """The plan of one ``spec`` step of ``cfg`` for the largest rank of a
    (pods, data, model) LM grid: ``memory`` and its ``terms``, or
    ``refused`` with the port's message."""
    grid0 = Grid.at_rank(0, pods, data, model, META, lm=True)
    mdl = params_shardings(grid0, Transformer(cfg, device=META))
    gm = GridTransformer(mdl, grid0)
    batch = _lm_batch(cfg, spec, grid0)
    B = spec.global_batch
    mb = (cfg.train_microbatches or 1) if spec.kind == "train" else 1
    if B % mb:          # the train step's own refusal (make_train_step)
        return {"refused": f"batch {B} does not split into {mb} "
                           f"microbatches"}
    # the decoder's positions (enc-dec: seq_len // dec_ratio tokens
    # beside seq_len frames; a VLM's patches and tokens: seq_len)
    S = (max(spec.seq_len // cfg.dec_ratio, 1)
         if cfg.family == "encdec" else spec.seq_len)
    cache = None
    try:
        gm.check_rows(B // mb)
        if spec.kind == "decode":
            cache = gm.init_cache(B, spec.seq_len)
        elif spec.kind == "prefill":
            # the grid prefill's cache: max_len rounded up to the model
            # axis; enc-dec's xk and xv hold the frames' positions
            cache = {n: x for n, x in gm.init_cache(
                B, _cdiv(S, model) * model).items() if n not in READONLY}
            if cfg.family == "encdec":
                L_, D = cfg.n_layers, head_dim(cfg)
                glob = {n: torch.empty((L_, B, spec.seq_len, cfg.n_kv, D),
                                       dtype=getattr(torch, cfg.dtype),
                                       device=META) for n in READONLY}
                specs = cache_specs(grid0, glob)
                cache.update({n: _meta_like(local_block(grid0, x, specs[n]))
                              for n, x in glob.items()})
    except GridRefusal as e:
        return {"refused": str(e)}
    params = _param_bytes(mdl)
    batch_b = sum(x.numel() * x.element_size() for x in batch.values())
    b_rows = next(iter(batch.values())).shape[0]
    terms = {"params": params, "batch": batch_b}
    rank = 0
    margin = LM_PLAN_SHORTFALL[spec.kind]
    act = getattr(torch, cfg.dtype)
    logits_b = _nbytes((b_rows, 1, cfg.padded_vocab), act.itemsize)
    if spec.kind == "train":
        owned = []
        for i in range(data):
            cell = Grid.at_rank(i * model, pods, data, model, META, lm=True)
            owned.append(_owned_bytes(cfg, cell, mdl))
        rank = max(range(data), key=lambda i: owned[i]) * model
        moments = 2 * max(owned)
        accum = max(owned) if mb > 1 else 0
        b = b_rows // mb
        temp = accum + _lm_temp(cfg, gm, "train", b, S, remat=remat,
                                moe_impl=moe_impl, grads=params)
        terms.update(grads=params, moments=moments, grad_accum=accum,
                     activations=temp - params - accum)
        mem = _memory(params + moments + batch_b, params + moments, temp,
                      alias=params + moments, margin=margin)
    else:
        cache_b = sum(x.numel() * x.element_size() for x in cache.values())
        positions = next((x.shape[2] for n, x in cache.items()
                          if n in ("k", "c")), 0)
        temp = _lm_temp(cfg, gm, spec.kind, b_rows, S, remat=remat,
                        moe_impl=moe_impl, cache_positions=positions)
        terms.update(cache=cache_b, logits=logits_b, activations=temp)
        if spec.kind == "prefill":
            mem = _memory(params + batch_b, cache_b + logits_b, temp,
                          margin=margin)
        else:
            mem = _memory(params + cache_b + batch_b, cache_b + logits_b,
                          temp, alias=cache_b, margin=margin)
    state = sum(v for k, v in terms.items()
                if k in ("params", "grads", "moments", "cache", "batch"))
    out = {"rank": rank, "memory": mem, "terms": terms, "state_bytes": state}
    if spec.kind == "train":
        out["moments_by_data_index"] = [2 * b for b in owned]
    return out


# ---------------------------------------------------------------------------
# The counted step (launch.step_costs)
# ---------------------------------------------------------------------------

def count_rescal(rcfg: RescalConfig, g: int, pods: int = 1, rank: int = 0,
                 *, comm_dtype: str | None = None) -> StepCounter:
    """One MU iteration of the fused engine (``dist/engine.py``) for
    ``rank`` of a (pods, g, g) grid, on meta tensors of its share's
    shapes and a recording grid, counted."""
    sh = rescal_share(rcfg, g, pods)
    grid = Grid.at_rank(rank, pods, g, g, META, record=True)
    cfg = DistRescalConfig(schedule=sh.schedule, comm_dtype=comm_dtype,
                           kernel=KernelPolicy(use_fused=True))
    lead = () if sh.members is None else (sh.members,)
    X = (torch.empty((sh.m, sh.nl, sh.nl), device=META)
         if sh.operand == "dense" else BCSR.meta(sh.m, sh.nnzb, sh.bs,
                                                 sh.nl))
    A = torch.empty(lead + (sh.nl, sh.k), device=META)
    R = torch.empty(lead + (sh.m, sh.k, sh.k), device=META)
    with StepCounter() as c:
        make_mu_step(grid, cfg)(X, A, R)
    return c


def _lm_step(cfg, spec: ShapeSpec, grid: Grid, depths: dict[str, int],
             remat: bool, moe_impl: str) -> dict:
    """The counted summary of one ``spec`` step on a model of ``cfg``
    whose layer stacks keep their first ``depths[stack]`` layers (each
    placed as in the whole model)."""
    mdl = Transformer(cfg, device=META)
    for stack, d in depths.items():
        setattr(mdl, stack, torch.nn.ModuleList(list(getattr(mdl, stack))[:d]))
    params_shardings(grid, mdl)
    specs = input_specs(cfg, spec)

    def ids(x):
        return torch.empty(x.shape, dtype=torch.int64, device=META) \
            if x.dtype == torch.int32 else x

    if spec.kind == "train":
        opt = AdamW()
        state = TrainState(params=mdl, opt=zero1_moments(grid, mdl, opt),
                           step=torch.zeros((), dtype=torch.int64))
        step = make_train_step(cfg, grid=grid, optimizer=opt, remat=remat,
                               moe_impl=moe_impl)
        args = (state, {k: ids(x) for k, x in specs["batch"].items()})
        kwargs = {}
    elif spec.kind == "prefill":
        kwargs = {k: ids(x) for k, x in specs["batch"].items()}
        step = make_prefill_step(mdl, grid=grid, moe_impl=moe_impl)
        args = (kwargs.pop("tokens"),)
    else:
        cache = GridTransformer(mdl, grid).init_cache(spec.global_batch,
                                                      spec.seq_len)
        step = make_serve_step(mdl, moe_impl=moe_impl, grid=grid)
        args = (cache, _lm_batch(cfg, spec, grid)["tokens"],
                spec.seq_len - 1)
        kwargs = {}
    with StepCounter() as c:
        step(*args, **kwargs)
    return c.summary()


def _flat(tree: dict, prefix: tuple = ()) -> dict[tuple, float]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif not isinstance(v, str):
            out[prefix + (k,)] = v
    return out


def _nest(flat: dict[tuple, float]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def layer_kinds(cfg, grid: Grid, stack: str, train: bool) -> list:
    """A key per layer of ``stack`` ("layers" or "enc_layers"): layers
    with one key cost one step the same.  They differ only in training,
    by ZeRO-1: where it gives each layer's moments to one data rank
    (``LMPlacement``'s owner), by whether this rank holds them."""
    pl = lm_placement(grid, cfg)
    keys: dict[int, list] = {}
    for name, pp in pl.params.items():
        parts = name.split(".")
        if parts[0] != stack:
            continue
        own = pp.owner == grid.i if train and pp.owner is not None else None
        keys.setdefault(int(parts[1]), []).append(own)
    return [tuple(keys[i]) for i in sorted(keys)]


def count_lm(cfg, spec: ShapeSpec, pods: int, data: int, model: int,
             rank: int = 0, *, remat: bool = True, moe_impl: str = "einsum",
             trip_counts: bool = True) -> dict:
    """The counted summary of one ``spec`` step of ``cfg`` for ``rank`` of
    a (pods, data, model) LM grid (``GridTransformer``: the train step
    with its gradients, AdamW and ZeRO-1, the prefill of the global
    batch, or one decode step at the cache's last position), on meta
    tensors and a recording grid.  Raises what the step raises on meta (a
    data-dependent shape).

    ``trip_counts``: the step is counted on its first layers only, every
    cost being one of a base and the layers' own, each layer's the same
    as its kind's (``layer_kinds``): c(1) (the base and the first layer)
    plus, for every later layer, the difference its kind's first such
    layer i makes, c(i + 1) - c(i), c counted at a depth (per stack:
    the decoder's, then the encoder's with the decoder at 1).  Equal to
    the whole count (``tests/test_torch_step_costs.py``), at a few
    layers' cost."""
    grid = Grid.at_rank(rank, pods, data, model, META, lm=True, record=True)
    stacks = [s for s in ("layers", "enc_layers")
              if getattr(cfg, "n_enc_layers" if s == "enc_layers"
                         else "n_layers")]
    if not trip_counts:
        return _lm_step(cfg, spec, grid, {}, remat, moe_impl)
    seen: dict[tuple, dict] = {}

    def at(depths: dict[str, int]) -> dict[tuple, float]:
        key = tuple(sorted(depths.items()))
        if key not in seen:
            seen[key] = _flat(_lm_step(cfg, spec, grid, depths, remat,
                                       moe_impl))
        return seen[key]

    one = {s: 1 for s in stacks}
    total = dict(at(one))
    for stack in stacks:
        kinds = layer_kinds(cfg, grid, stack, spec.kind == "train")
        for kind, n in Counter(kinds[1:]).items():
            j = kinds.index(kind, 1)
            hi, lo = at({**one, stack: j + 1}), at({**one, stack: j})
            for path in hi.keys() | lo.keys():
                total[path] = (total.get(path, 0)
                               + n * (hi.get(path, 0) - lo.get(path, 0)))
    out = _nest({p: v for p, v in total.items() if v or p[0] != "ops"})
    out.setdefault("ops", {})
    out["collectives"].setdefault("by_axis", {})
    return out


def counted_fields(s: dict, per: str) -> dict:
    """The record fields of a counted step's summary
    (``StepCounter.summary``): ``repro``'s ``flops_per_device``,
    ``bytes_per_device``, ``ops`` and ``collectives`` (``repro``'s shape,
    with the port's ``by_axis`` and ``per``)."""
    return {"flops_per_device": s["flops"], "bytes_per_device": s["bytes"],
            "ops": s["ops"], "collectives": dict(s["collectives"], per=per)}


# ---------------------------------------------------------------------------
# Cells and the CLI
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             remat: bool = True, moe_impl: str = "einsum",
             rescal_schedule: str | None = None,
             rescal_comm_dtype: str | None = None) -> dict:
    """One cell's record, with ``repro``'s keys."""
    cfg = get_config(arch)
    if rescal_schedule and isinstance(cfg, RescalConfig):
        cfg = dataclasses.replace(cfg, schedule=rescal_schedule)
    pods, data, model = grid_shape(multi_pod)
    base = {"arch": arch, "shape": shape,
            "mesh": "x".join(str(s) for s in ((pods, data, model)
                                              if multi_pod else
                                              (data, model))),
            "devices": pods * data * model, "multi_pod": multi_pod}
    t0 = time.perf_counter()
    if isinstance(cfg, RescalConfig):
        kind = RESCAL_SHAPE.kind
        plan = plan_rescal(cfg, data, pods, comm_dtype=rescal_comm_dtype)
        model_fl = rescal_model_flops(cfg)
        ledger = plan.pop("collectives")
        extra = {"schedule": cfg.schedule}

        def count_step():
            c = count_rescal(cfg, data, pods, plan["rank"],
                             comm_dtype=rescal_comm_dtype)
            n = c.collectives_summary()["total"]["count"]
            if n != ledger["count"]:
                raise RuntimeError(
                    f"{arch}: the counted step issues {n} collectives per "
                    f"MU iteration, the ledger {ledger['count']}")
            return counted_fields(c.summary(), "MU iteration")
    else:
        spec = SHAPES[shape]
        ok, reason = cfg.supports(spec)
        if not ok:
            return dict(base, skipped=reason)
        kind = spec.kind
        plan = plan_lm(cfg, spec, pods, data, model, remat=remat,
                       moe_impl=moe_impl)
        model_fl = model_lib.model_flops(cfg, spec)
        extra = {"remat": remat, "moe_impl": moe_impl}
        if "refused" in plan:
            return dict(base, skipped=False, kind=kind,
                        refused=plan["refused"],
                        model_flops_global=model_fl, memory=None,
                        **{k: None for k in XLA_ONLY + COUNTED}, **extra)

        def count_step():
            return counted_fields(
                count_lm(cfg, spec, pods, data, model, plan["rank"],
                         remat=remat, moe_impl=moe_impl), f"{kind} step")
    plan_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        counted, why = count_step(), None
    except (RuntimeError, NotImplementedError, ValueError) as e:
        if isinstance(cfg, RescalConfig):
            raise
        # a step that cannot run on meta (a data-dependent shape): no
        # count, with the reason, never 0
        counted = dict.fromkeys(COUNTED)
        why = f"{type(e).__name__}: {e}"
    out = dict(base, skipped=False, kind=kind, plan_s=round(plan_s, 3),
               count_s=round(time.perf_counter() - t1, 3),
               **{k: None for k in XLA_ONLY}, **counted,
               model_flops_global=model_fl, memory=plan.pop("memory"),
               **extra, **plan)
    if why is not None:
        out["count_error"] = why
    return out


def all_cells() -> list[tuple[str, str]]:
    cells = [(a, s) for a in ARCHS for s in SHAPES]
    cells += [(r, "mu_iter") for r in RESCAL_CONFIGS]
    return cells


def _write_cell(job, out_dir: Path, **kw) -> str:
    arch, shape, multi_pod = job
    tag = "multipod" if multi_pod else "pod"
    out = out_dir / tag / f"{arch}__{shape}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    d = run_cell(arch, shape, multi_pod=multi_pod, **kw)
    out.write_text(json.dumps(d, indent=1))
    state = ("skipped" if d.get("skipped") else
             "refused" if d.get("refused") else "ok")
    return f"{state} {arch} {shape} ({tag})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One rank's memory plan and counted step of each "
                    "(arch x shape) cell on the production grids (no "
                    "device, no process group).")
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="mu_iter")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-impl", default="einsum",
                    choices=("einsum", "scatter", "dense"))
    ap.add_argument("--rescal-schedule", default=None,
                    choices=(None, "batched", "sliced"))
    ap.add_argument("--rescal-comm-dtype", default=None)
    args = ap.parse_args(argv)
    kw = dict(remat=not args.no_remat, moe_impl=args.moe_impl,
              rescal_schedule=args.rescal_schedule,
              rescal_comm_dtype=args.rescal_comm_dtype)

    if args.all:
        out_dir = Path(args.out or "artifacts/dryrun")
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        jobs = [(a, s, mp) for mp in meshes for (a, s) in all_cells()]
        # the train steps first, the longest to count; processes:
        # counting a step on meta is Python-bound
        jobs.sort(key=lambda j: j[1] != "train_4k")
        with ProcessPoolExecutor(
                max_workers=max(args.jobs, 1),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for msg in ex.map(functools.partial(_write_cell, out_dir=out_dir,
                                                **kw), jobs):
                print(msg, flush=True)
        return 0
    if not args.arch:
        ap.error("--arch is required without --all")
    stats = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, **kw)
    js = json.dumps(stats, indent=1)
    if args.out:
        Path(args.out).write_text(js)
    print(js)
    mem = stats.get("memory")
    if mem is not None:
        print(f"\nmemory/rank {stats['rank']}: {mem['total'] / 1e9:.2f} GB "
              f"(fits {CARD_NAME}, {mem['card_bytes'] / 1e9:.0f} GB, with a "
              f"{100 * mem['fit_margin']:.1f}% margin: {mem[FIT_KEY]})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
