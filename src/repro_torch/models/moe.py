"""Mixture-of-Experts FFN with top-k routing (port of
``repro/models/moe.py``).

Three execution paths over the same parameters and router math, picked
by ``moe_apply(impl=)`` as in ``repro``:

  * "einsum" (the default, ``repro``'s production path): tokens in
    groups of up to 256, a dense (s, E, C) one-hot dispatch per group,
    and dispatch, experts and combine as batched products.  Capacity C =
    max(int(s * top_k / E * capacity_factor), 8) per group; assignments
    past it are dropped, in the order of the group's (token, k) pairs.
  * "scatter": the (token, k) assignments sorted by expert (a stable
    sort, as ``jnp.argsort``) into per-expert capacity buffers (E, C, d)
    with C over all T tokens, the experts as one batched product, the
    results added back weighted by their gates.
  * "dense": every expert on every token, gate-masked; exact (no drops),
    so scatter equals dense on a batch under capacity.

Each assignment's slot in its expert's buffer is its place in a stable
sort by (group, expert) (``slots``).  The router's top-k breaks ties
towards the lower expert id, as ``lax.top_k`` does (a stable descending
sort; ``torch.topk`` promises no order on ties).  Shared experts
(DeepSeekMoE) are one always-on SwiGLU MLP of width n_shared * d_ff.
The switch-style load-balance loss E * sum_e f_e * p_e is returned
beside the output.

``repro`` concatenates [wg, wi] on every call of the einsum path; here
the module keeps them as one (E, d, 2 * d_ff) parameter ``wgi`` (gate
columns first) with ``wg``/``wi`` as views, so a call copies no weight.
All of it is plain PyTorch on every device: ``repro`` runs it in XLA.

One device and an LM grid run the same code: on a grid (``moe_apply``'s
``plan``, ``tp`` and ``batch``; ``MoEGridPlan``, from the parameter
specs) the experts are split EXPERT-else-ff over "model" (E / M whole
experts per rank when E divides the axis, else every expert on the
rank's d_ff block), the router is column-parallel (its logits gathered
whole), and the combine's partial sums are all-reduced once.  The
tokens' groups, capacities, slots and drops, and the balance loss, are
the global batch's, as ``repro`` computes them: a group may span the
data cells, and a token's slot then counts the earlier cells'
assignments (their per-expert counts, one all-gather over the batch
axes).  One device is the plan-less case: every cell holds every row
and every expert.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import BATCH_AXIS
from repro_torch.dist.tp import global_sum

from .layers import MLP, dense_init, mlp_grid, param

CAPACITY_FACTOR = 1.25   # ``repro``'s default (einsum and scatter)


class MoE(nn.Module):
    """Routed experts (+ optional shared experts): router (d, E), wgi (E,
    d, 2 * d_ff), wo (E, d_ff, d), shared an ``MLP`` of width n_shared *
    d_ff."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 top_k: int, n_shared: int, dtype, device):
        super().__init__()
        self.d_ff, self.top_k = d_ff, top_k
        self.router = param((d_model, n_experts), dtype, device)
        self.wgi = param((n_experts, d_model, 2 * d_ff), dtype, device)
        self.wo = param((n_experts, d_ff, d_model), dtype, device)
        self.shared = (MLP(d_model, n_shared * d_ff, dtype, device)
                       if n_shared else None)

    @property
    def wg(self) -> torch.Tensor:
        return self.wgi[..., :self.d_ff]

    @property
    def wi(self) -> torch.Tensor:
        return self.wgi[..., self.d_ff:]

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        E, d, _ = self.wgi.shape
        dt, dev = self.wgi.dtype, self.wgi.device
        self.router.copy_(dense_init(gen, d, E, dt, dev, scale=0.02))
        for w in (self.wi, self.wg):
            w.copy_(torch.randn(w.shape, generator=gen, dtype=dt,
                                device=dev) * (1.0 / d) ** 0.5)
        self.wo.copy_(torch.randn(self.wo.shape, generator=gen, dtype=dt,
                                  device=dev) * (1.0 / self.d_ff) ** 0.5)
        if self.shared is not None:
            self.shared.init_parameters(gen)

    def forward(self, x: torch.Tensor, impl: str = "einsum"):
        """x (B, S, d) -> (y (B, S, d), aux loss)."""
        return moe_apply(self, x, self.top_k, impl=impl)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _balance_loss(probs: torch.Tensor, first: torch.Tensor,
                  batch=None) -> torch.Tensor:
    """E * sum_e f_e * p_e over probs (T_l, E) and each token's first
    choice (T_l,), both means over the global batch's T tokens: this
    cell's sums, summed over ``batch`` (the cells that hold the other
    rows; ``global_sum``, whose gradient reaches every cell's tokens)."""
    E = probs.shape[-1]
    sums = torch.stack([F.one_hot(first, E).float().sum(0), probs.sum(0)])
    T = probs.shape[0]
    if batch is not None:
        sums = global_sum(sums, batch)
        T *= batch.size
    return E * torch.sum((sums[0] / T) * (sums[1] / T))


def _router(p: MoE, x2d: torch.Tensor, top_k: int, *, tp=None,
            sharded: bool = False, view: tuple | None = None, batch=None):
    """x2d (T_l, d) -> gate values (T_l, k) fp32, normalized over the k;
    expert ids (T_l, k); the balance loss of the global batch
    (``_balance_loss``).  ``sharded``: the router's expert columns are
    split over ``tp``'s "model" axis, so its logits are gathered whole.
    ``view``: the shape (without E) that ``_top_k`` sees, the single
    device's groups (``RouteTape`` replays them by call)."""
    if sharded:
        logits = tp.gather(tp.split_use(x2d) @ p.router, -1)
    else:
        logits = x2d @ p.router
    probs = torch.softmax(logits.float(), dim=-1)
    T_l, E = probs.shape
    gvals, gids = _top_k(probs.reshape(*(view or (T_l,)), E), top_k)
    gvals = gvals / torch.clamp_min(gvals.sum(-1, keepdim=True), 1e-9)
    gvals, gids = gvals.reshape(T_l, top_k), gids.reshape(T_l, top_k)
    return gvals, gids, _balance_loss(probs, gids[:, 0], batch)


def _expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d), SwiGLU per expert."""
    gate, up = torch.bmm(buf, p.wgi).chunk(2, dim=-1)
    return torch.bmm(F.silu(gate) * up, p.wo)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: max(int(tokens * top_k / E * factor), 8), in
    Python floats as ``repro``."""
    return max(int(tokens * top_k / n_experts * capacity_factor), 8)


def tokens_per_group(tokens: int, limit: int = 256) -> int:
    """The einsum path's tokens per group: ``limit``, halved until it
    divides ``tokens``."""
    gs = min(limit, tokens)
    while tokens % gs:
        gs //= 2
    return gs


def slots(gids: torch.Tensor, n_experts: int, group_size: int, *,
          t0: int = 0, T: int | None = None, batch=None) -> torch.Tensor:
    """The slot of each (token, k) assignment in its expert's buffer:
    the number of its group's earlier assignments (in (token, k) order
    over the global batch) to the same expert.  gids (T_l, k): the
    tokens at global positions t0 .. t0 + T_l - 1 of T (default T_l), in
    groups of ``group_size``.  Within this cell, each assignment's place
    in a stable sort by (group, expert); where a group spans cells
    (``batch``: the cells' axis; T_l % group_size != 0), plus the earlier
    cells' counts per (group, expert), from one all-gather.  Returns
    slot (T_l, k) int64; an assignment is kept where slot < capacity."""
    T_l, k = gids.shape
    E, gs, dev = n_experts, group_size, gids.device
    T = T_l if T is None else T
    g0 = t0 // gs
    n_g = (t0 + T_l - 1) // gs - g0 + 1
    group = ((t0 + torch.arange(T_l, device=dev)) // gs
             - g0).repeat_interleave(k)
    key = group * E + gids.reshape(-1)
    counts = torch.zeros(n_g * E, dtype=torch.int64, device=dev).index_add_(
        0, key, torch.ones_like(key))
    order = torch.argsort(key, stable=True)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=dev) - first[key[order]]
    if batch is not None and T_l % gs:
        mine = counts.new_zeros((T // gs, E))
        mine[g0:g0 + n_g] = counts.view(n_g, E)
        every = batch.grid.all_gather(mine[None], BATCH_AXIS, 0)
        pos = pos + every[:batch.index].sum(0)[g0:g0 + n_g].reshape(-1)[key]
    return pos.reshape(T_l, k)


@dataclasses.dataclass(frozen=True)
class MoEGridPlan:
    """How an MoE layer splits over "model", from its parameter specs:
    ``router`` (its expert columns split, so its logits are gathered),
    ``experts`` ("expert": E / M whole experts per rank, the expert dim
    of wgi and wo split; "ff": every expert on the rank's d_ff block, as
    ``repro``'s EXPERT-else-ff rule splits them when E does not divide
    the axis; "whole": replicated, as on one device), ``shared`` (the
    shared MLP split as ``mlp_grid`` splits it), and ``n_experts``, E."""
    router: bool
    experts: str
    shared: bool
    n_experts: int


def moe_apply(p: MoE, x: torch.Tensor, top_k: int, impl: str = "einsum",
              capacity_factor: float = CAPACITY_FACTOR,
              group_size: int = 256, *, plan: MoEGridPlan | None = None,
              tp=None, batch=None):
    """The MoE FFN through ``impl`` ("einsum": ``repro``'s groups of up to
    ``group_size`` tokens of the global batch; "scatter": capacity over
    all its tokens; "dense": no capacity): x (B_l, S, d) -> (y (B_l, S,
    d), the global batch's balance loss).  On one device ``plan``,
    ``tp`` and ``batch`` are None.  On an LM grid x is this cell's rows,
    whole on every model rank, and so is y; ``p`` holds this rank's
    blocks, split as ``plan`` says over ``tp``'s "model" axis, whose
    partial sums are all-reduced once; ``batch`` is the axis the rows
    are split over (the grid's "batch" axis), or None when every cell
    holds every row."""
    if impl not in ("einsum", "scatter", "dense"):
        raise ValueError(f"moe impl must be 'einsum', 'scatter' or "
                         f"'dense', got {impl!r}")
    B_l, S, d = x.shape
    E = plan.n_experts if plan is not None else p.router.shape[1]
    T_l = B_l * S
    n, c = (batch.size, batch.index) if batch is not None else (1, 0)
    T, t0 = T_l * n, T_l * c
    split = plan is not None and plan.experts != "whole"
    x2 = x.reshape(T_l, d)
    xs = tp.split_use(x2) if split else x2
    gs = tokens_per_group(T, group_size) if impl == "einsum" else T
    # the single device's view of the probabilities (RouteTape replays
    # it): its groups where this cell holds whole groups
    view = ((T_l // gs, gs) if impl == "einsum" and T_l % gs == 0
            else (1, T_l) if impl == "einsum" else (T_l,))
    gvals, gids, aux = _router(p, x2, top_k, tp=tp,
                               sharded=plan is not None and plan.router,
                               view=view, batch=batch)
    if plan is not None and plan.experts == "expert":
        nE = p.wgi.shape[0]
        e0 = tp.index * nE
    else:
        nE, e0 = E, 0
    gv = tp.split_use(gvals) if split else gvals
    if impl == "dense":
        y = _dense(p, xs, gv.to(x.dtype), gids, E, e0, nE)
    else:
        C = capacity(gs, top_k, E, capacity_factor)
        slot = slots(gids, E, gs, t0=t0, T=T, batch=batch)
        if impl == "einsum":
            y = _einsum(p, xs, gv, gids, slot, C, E, gs, t0, e0, nE)
        else:
            y = _scatter(p, xs, gv.to(x.dtype), gids, slot, C, e0, nE)
    if split:
        y = tp.reduce(y)
    y = y.reshape(B_l, S, d)
    if p.shared is not None:
        y = y + mlp_grid(p.shared, x, tp, plan is not None and plan.shared)
    return y, aux


def _einsum(p, xs, gvals, gids, slot, C, E, gs, t0, e0, nE):
    """GShard-style grouped one-hot dispatch (``repro``'s production
    path) over this cell's part of its groups (zero rows pad the groups
    it shares with another cell), on experts e0 .. e0 + nE - 1: (T_l,
    d), a partial sum over "model" where the experts are split."""
    T_l, d = xs.shape
    o = t0 % gs
    n_g = -(-(o + T_l) // gs)
    tail = n_g * gs - o - T_l

    def grouped(t):
        pad = [0, 0] * (t.dim() - 1) + [o, tail]
        return F.pad(t, pad).reshape(n_g, gs, *t.shape[1:])

    kept = slot < C
    onehot_e = grouped(F.one_hot(gids, E).float())[..., e0:e0 + nE]
    onehot_c = grouped(F.one_hot(slot.clamp_max(C - 1), C).float()
                       * kept[..., None])
    dispatch = torch.einsum("gske,gskc->gsec", onehot_e, onehot_c)
    # a token's k experts differ, so each (e, c) cell sums one gate
    combine = torch.einsum("gske,gskc->gsec",
                           onehot_e * grouped(gvals)[..., None], onehot_c)
    xg = grouped(xs)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(xs.dtype), xg)
    gate, up = torch.einsum("gecd,edf->gecf", expert_in,
                            p.wgi).chunk(2, dim=-1)
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, p.wo)
    y = torch.einsum("gsec,gecd->gsd", combine.to(xs.dtype), out)
    return y.reshape(n_g * gs, d)[o:o + T_l]


def _scatter(p, xs, gvals, gids, slot, C, e0, nE):
    """The (token, k) assignments sorted by expert (a stable sort, as
    ``jnp.argsort``) into per-expert capacity buffers (nE, C, d) at
    their slots, the experts as one batched product, the results added
    back weighted by their gates."""
    T_l, d = xs.shape
    k = gids.shape[1]
    flat_e = gids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok = order // k
    keep = (slot.reshape(-1)[order] < C) & (e_sorted >= e0) & \
        (e_sorted < e0 + nE)
    pos_c = slot.reshape(-1)[order].clamp(0, C - 1)
    e_loc = (e_sorted - e0).clamp(0, nE - 1)
    src = torch.where(keep[:, None], xs[tok], 0.0)
    buf = xs.new_zeros((nE, C, d)).index_put((e_loc, pos_c), src,
                                             accumulate=True)
    out_buf = _expert_ffn(p, buf)
    contrib = out_buf[e_loc, pos_c] * \
        (gvals.reshape(-1)[order] * keep)[:, None]
    return xs.new_zeros((T_l, d)).index_add(0, tok, contrib)


def _dense(p, xs, gvals, gids, E, e0, nE):
    """Exact path: every expert (of e0 .. e0 + nE - 1) on every token,
    gate-masked."""
    gate_full = xs.new_zeros((xs.shape[0], E)).scatter(
        1, gids, gvals)[:, e0:e0 + nE]
    wg, wi = p.wgi.chunk(2, dim=-1)
    h = F.silu(torch.einsum("td,edf->tef", xs, wg)) * \
        torch.einsum("td,edf->tef", xs, wi)
    per_exp = torch.einsum("tef,efd->ted", h, p.wo)
    return torch.einsum("ted,te->td", per_exp, gate_full)
