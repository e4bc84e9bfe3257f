"""Hymba-style hybrid mixer: parallel attention and Mamba2 heads in every
layer (port of ``repro/models/hybrid.py``; arXiv:2411.13676).

Within one layer the same normalized input feeds a sliding-window GQA
attention and a Mamba2 mixer; their outputs are each RMS-normalized and
averaged.  As in ``repro``, every layer's attention is sliding-window
(Hymba's few full-attention layers are not kept), and the decode cache
holds a ring of the last ``window`` keys and values (slot of position t:
t % window) beside the SSM state.

The ring comes from the tail of the prompt.  For a prompt of S >= W
positions its slots line up with t % W only when S % W == 0; ``repro``
says so and does not check it, and neither does the port, so the two
agree on every S (ROADMAP.md §3, reference caveats).  Plain PyTorch on
every device: ``repro`` runs the window and the ring in XLA, outside its
attention kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import (GQAAttention, gqa_grid_full, gqa_plan,
                        ring_decode_attention, sliding_window_attention)
from .layers import rmsnorm
from .ssm import Mamba2, mamba2_apply, mamba2_step


class Hymba(nn.Module):
    """attn (``GQAAttention``), mamba (``Mamba2``), and the two branch
    norms ln_a and ln_m."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, *, window: int, rope_theta: float,
                 ssm_state: int, ssm_headdim: int = 64, ssm_expand: int = 2,
                 ssm_groups: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        self.window = window
        self.attn = GQAAttention(d_model, n_heads, n_kv, head_dim,
                                 rope_theta, dtype, device)
        self.mamba = Mamba2(d_model, state=ssm_state, expand=ssm_expand,
                            headdim=ssm_headdim, groups=ssm_groups,
                            dtype=dtype, device=device)
        self.ln_a = nn.Parameter(torch.ones(d_model, dtype=dtype,
                                            device=device))
        self.ln_m = nn.Parameter(torch.ones(d_model, dtype=dtype,
                                            device=device))

    def init_parameters(self, gen: torch.Generator) -> None:
        self.attn.init_parameters(gen)
        self.mamba.init_parameters(gen)


def hymba_apply(p: Hymba, h: torch.Tensor, positions: torch.Tensor, *,
                plan=None, tp=None, return_state: bool = False):
    """The full-sequence (train, prefill) mixer over the normalized layer
    input h (B, S, d); with ``return_state`` also the decode cache {"k",
    "v" (B, W, Hkv, D) ring, "ssm", "conv"}, whole.  On an LM grid the
    sliding-window attention is tensor parallel as
    ``models.attention.gqa_grid_full`` runs GQA (``plan``, its
    ``GQAPlan`` on ``tp``'s "model" axis: Hymba's 25 query and 5 KV
    heads divide neither 2 nor 4, so there it takes the gather path,
    every rank attending every query) and the Mamba2 branch is whole on
    every model rank (its in_proj and out_proj replicate in ``repro``'s
    rules); on one device ``plan`` and ``tp`` are None."""
    S = h.shape[1]
    a = p.attn
    plan = plan or gqa_plan(a.n_heads, a.n_kv, a.head_dim, None, wq=False,
                            wk=False, wo=False)

    def window(q, k, v):
        return sliding_window_attention(q, k, v, window=p.window,
                                        chunk=min(256, S))

    attn_out, k, v = gqa_grid_full(a, h, positions, plan, tp, q_chunk=256,
                                   need_kv=return_state, attend=window)
    m = mamba2_apply(p.mamba, h, chunk=min(256, S),
                     return_state=return_state)
    m_out = m[0] if return_state else m
    out = 0.5 * (rmsnorm(attn_out, p.ln_a) + rmsnorm(m_out, p.ln_m))
    if not return_state:
        return out
    W = p.window
    if S >= W:
        k_ring, v_ring = k[:, S - W:], v[:, S - W:]
    else:
        pad = (0, 0, 0, 0, 0, W - S)
        k_ring = nn.functional.pad(k, pad)
        v_ring = nn.functional.pad(v, pad)
    h_last, conv_tail = m[1]
    return out, {"k": k_ring, "v": v_ring, "ssm": h_last, "conv": conv_tail}


def hymba_step(p: Hymba, h: torch.Tensor, cache: dict, pos: int
               ) -> torch.Tensor:
    """One token of normalized input h (B, 1, d) at ``pos``: its k and v
    go into ring slot pos % W and the SSM state and conv window of
    ``cache`` (one layer's {"k", "v", "ssm", "conv"}) are replaced, all in
    place.  Returns the mixer's output (B, 1, d)."""
    B = h.shape[0]
    a = p.attn
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=h.device)
    q, k, v = a.qkv(h, positions)
    slot = pos % p.window
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = ring_decode_attention(q, cache["k"], cache["v"], pos, p.window)
    attn_out = o.reshape(B, 1, -1) @ a.wo
    m_out, ssm_new, conv_new = mamba2_step(p.mamba, h, cache["ssm"],
                                           cache["conv"])
    cache["ssm"].copy_(ssm_new)
    cache["conv"].copy_(conv_new)
    return 0.5 * (rmsnorm(attn_out, p.ln_a) + rmsnorm(m_out, p.ln_m))
