"""Transformer building blocks (port of ``repro/models/layers.py``).

Weights keep ``repro``'s orientation: a dense weight is (d_in, d_out) and
is applied as ``x @ w``, the embedding table is (vocab, d_model) and the
unembedding is tied to it.  ``repro``'s ``constrain`` calls are sharding
hints, no-ops on one device; on an LM grid the ``*_grid`` functions
make the collectives they imply by hand (``dist.tp``): the
column/row-parallel MLP, the vocab-parallel embedding and the
vocab-sharded logits.  Draws come from a
``torch.Generator`` (``repro``'s ``jax.random`` keys cannot be
reproduced), so parity tests load ``repro``'s parameters through
``convert.lm_params_from_repro``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import step_costs


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, 1) * scale in ``dtype``, scale 1 / sqrt(d_in) by default."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                       device=device) * scale


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter (filled by ``init_parameters`` or a
    loaded state dict)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS normalization in fp32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """1 / theta ** (2i / d) in fp32, computed on the CPU so that every
    device rotates by the same angles."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """``rope_freqs`` moved to ``device`` once: a copy from pageable host
    memory waits for the device's stream, which would stall every decode
    step twice per layer.  Set-up, so not counted (``launch.step_costs``)."""
    with step_costs.uncounted():
        return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., seq, heads, head_dim), positions (..., seq): the half-split
    rotation (not interleaved), angles in fp32."""
    d = x.shape[-1]
    freqs = _freqs_on(d, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs  # (..., s, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward blocks
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated SwiGLU MLP: (silu(x @ wg) * (x @ wi)) @ wo."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.wi = param((d_model, d_ff), dtype, device)
        self.wg = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            w.copy_(dense_init(gen, *w.shape, w.dtype, w.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.wg) * (x @ self.wi)) @ self.wo


class MLP2(nn.Module):
    """Two-matrix GELU MLP (tanh approximation, as ``jax.nn.gelu``):
    gelu(x @ wi) @ wo."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.wi = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wi, self.wo):
            w.copy_(dense_init(gen, *w.shape, w.dtype, w.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x @ self.wi, approximate="tanh") @ self.wo


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, dtype=dtype,
                       device=device) * 0.02


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T."""
    return x @ table.T


# ---------------------------------------------------------------------------
# On an LM grid (tensor parallel over "model"; ``dist.tp``)
# ---------------------------------------------------------------------------

def mlp_grid(mlp: nn.Module, h: torch.Tensor, tp, sharded: bool
             ) -> torch.Tensor:
    """The MLP on the grid: h (B, S, d), whole on every model rank.
    Sharded (wi and wg column-parallel, wo row-parallel), each rank
    computes its block of d_ff features and the partial products of wo
    are all-reduced; else every rank computes the whole MLP."""
    if not sharded:
        return mlp(h)
    hs = tp.split_use(h)
    if isinstance(mlp, MLP):
        a = F.silu(hs @ mlp.wg) * (hs @ mlp.wi)
    else:
        a = F.gelu(hs @ mlp.wi, approximate="tanh")
    return tp.reduce(a @ mlp.wo)


def embed_grid(table: torch.Tensor, tokens: torch.Tensor, tp,
               sharded: bool) -> torch.Tensor:
    """Vocab-parallel lookup: each rank holds rows [index * V_l, (index +
    1) * V_l) of the table, looks up the ids in its range, writes zero
    for the others, and the ranks' rows are all-reduced."""
    if not sharded:
        return embed(table, tokens)
    lo, n = tp.index * table.shape[0], table.shape[0]
    ids = tokens - lo
    inside = (ids >= 0) & (ids < n)
    x = embed(table, ids.clamp(0, n - 1))
    return tp.reduce(torch.where(inside[..., None], x, 0))


def unembed_grid(table: torch.Tensor, x: torch.Tensor, tp, sharded: bool
                 ) -> torch.Tensor:
    """Tied unembedding on the grid: logits (..., V_l) of this rank's
    vocab rows when the table is sharded (``repro``'s ``constrain(logits,
    BATCH, None, MODEL)``), else all of them."""
    if not sharded:
        return unembed(table, x)
    return unembed(table, tp.split_use(x))
