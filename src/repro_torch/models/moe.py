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

The router's top-k breaks ties towards the lower expert id, as
``lax.top_k`` does (a stable descending sort; ``torch.topk`` promises no
order on ties).  Shared experts (DeepSeekMoE) are one always-on SwiGLU
MLP of width n_shared * d_ff.  The switch-style load-balance loss
E * sum_e f_e * p_e is returned beside the output.

``repro`` concatenates [wg, wi] on every call of the einsum path; here
the module keeps them as one (E, d, 2 * d_ff) parameter ``wgi`` (gate
columns first) with ``wg``/``wi`` as views, so a call copies no weight.
All of it is plain PyTorch on every device: ``repro`` runs it in XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, dense_init, param

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


def _balance_loss(probs: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """E * sum_e f_e * p_e over probs (T, E) and each token's first
    choice (T,)."""
    E = probs.shape[-1]
    fe = F.one_hot(first, E).float().mean(0)
    return E * torch.sum(fe * probs.mean(0))


def _router(p: MoE, x2d: torch.Tensor, top_k: int):
    """x2d (T, d) -> gate values (T, k) in x's dtype, normalized over the
    k; expert ids (T, k); aux loss."""
    probs = torch.softmax((x2d @ p.router).float(), dim=-1)
    gvals, gids = _top_k(probs, top_k)
    gvals = gvals / torch.clamp_min(gvals.sum(-1, keepdim=True), 1e-9)
    return gvals.to(x2d.dtype), gids, _balance_loss(probs, gids[:, 0])


def _expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d), SwiGLU per expert."""
    gate, up = torch.bmm(buf, p.wgi).chunk(2, dim=-1)
    return torch.bmm(F.silu(gate) * up, p.wo)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: max(int(tokens * top_k / E * factor), 8), in
    Python floats as ``repro``."""
    return max(int(tokens * top_k / n_experts * capacity_factor), 8)


def moe_apply_scatter(p: MoE, x: torch.Tensor, top_k: int,
                      capacity_factor: float = CAPACITY_FACTOR):
    """x (B, S, d) -> (out, aux loss), through per-expert capacity buffers
    over all T = B * S tokens."""
    B, S, d = x.shape
    E = p.router.shape[1]
    T = B * S
    x2d = x.reshape(T, d)
    gvals, gids, aux = _router(p, x2d, top_k)
    flat_e = gids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok = order // top_k
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * top_k, device=x.device) - starts[e_sorted]
    C = capacity(T, top_k, E, capacity_factor)
    keep = pos < C
    pos_c = pos.clamp(0, C - 1)
    src = torch.where(keep[:, None], x2d[tok], 0.0)
    buf = x.new_zeros((E, C, d)).index_put((e_sorted, pos_c), src,
                                           accumulate=True)
    out_buf = _expert_ffn(p, buf)
    contrib = out_buf[e_sorted, pos_c] * \
        (gvals.reshape(-1)[order] * keep)[:, None]
    y = x.new_zeros((T, d)).index_add(0, tok, contrib)
    if p.shared is not None:
        y = y + p.shared(x2d)
    return y.reshape(B, S, d), aux


def moe_apply_dense(p: MoE, x: torch.Tensor, top_k: int):
    """Exact path: every expert on every token, gate-masked."""
    B, S, d = x.shape
    E = p.router.shape[1]
    x2d = x.reshape(B * S, d)
    gvals, gids, aux = _router(p, x2d, top_k)
    gate_full = x.new_zeros((B * S, E)).scatter(1, gids, gvals)
    h = F.silu(torch.einsum("td,edf->tef", x2d, p.wg)) * \
        torch.einsum("td,edf->tef", x2d, p.wi)
    per_exp = torch.einsum("tef,efd->ted", h, p.wo)
    y = torch.einsum("ted,te->td", per_exp, gate_full)
    if p.shared is not None:
        y = y + p.shared(x2d)
    return y.reshape(B, S, d), aux


def tokens_per_group(tokens: int, limit: int = 256) -> int:
    """The einsum path's tokens per group: ``limit``, halved until it
    divides ``tokens``."""
    gs = min(limit, tokens)
    while tokens % gs:
        gs //= 2
    return gs


def slots(onehot_e: torch.Tensor, C: int):
    """Each (token, k) assignment's slot in its expert's buffer, in the
    group's (token, k) order: the experts' one-hot (G, s, k, E) -> (slot
    (G, s, k) int64, kept (G, s, k) bool, slot < C)."""
    G, s, k, E = onehot_e.shape
    flat = onehot_e.reshape(G, s * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    slot = (pos * flat).sum(-1).reshape(G, s, k).long()
    return slot, slot < C


def moe_apply_einsum(p: MoE, x: torch.Tensor, top_k: int,
                     capacity_factor: float = CAPACITY_FACTOR,
                     group_size: int = 256):
    """GShard-style grouped one-hot dispatch (``repro``'s production
    path): x (B, S, d) -> (out, aux loss)."""
    B, S, d = x.shape
    E = p.router.shape[1]
    T = B * S
    gs = tokens_per_group(T, group_size)
    G = T // gs
    xg = x.reshape(G, gs, d)
    probs = torch.softmax((xg @ p.router).float(), dim=-1)
    gvals, gids = _top_k(probs, top_k)
    gvals = gvals / torch.clamp_min(gvals.sum(-1, keepdim=True), 1e-9)
    aux = _balance_loss(probs.reshape(T, E), gids[..., 0].reshape(T))

    C = capacity(gs, top_k, E, capacity_factor)
    onehot_e = F.one_hot(gids, E).float()                  # (G, s, k, E)
    slot, kept = slots(onehot_e, C)
    onehot_c = F.one_hot(slot.clamp_max(C - 1), C).float() * \
        kept[..., None]                                    # (G, s, k, C)
    dispatch = torch.einsum("gske,gskc->gsec", onehot_e, onehot_c)
    # a token's k experts differ, so each (e, c) cell sums one gate
    combine = torch.einsum("gske,gskc->gsec", onehot_e * gvals[..., None],
                           onehot_c)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    gate, up = torch.einsum("gecd,edf->gecf", expert_in,
                            p.wgi).chunk(2, dim=-1)
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, p.wo)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out)
    if p.shared is not None:
        y = y + p.shared(xg)
    return y.reshape(B, S, d), aux


def moe_apply(p: MoE, x: torch.Tensor, top_k: int, impl: str = "einsum",
              capacity_factor: float = CAPACITY_FACTOR):
    """The MoE FFN through ``impl`` ("einsum", "scatter" or "dense")."""
    if impl == "dense":
        return moe_apply_dense(p, x, top_k)
    if impl == "scatter":
        return moe_apply_scatter(p, x, top_k, capacity_factor)
    if impl == "einsum":
        return moe_apply_einsum(p, x, top_k, capacity_factor)
    raise ValueError(f"moe impl must be 'einsum', 'scatter' or 'dense', "
                     f"got {impl!r}")
