"""Serving steps: prefill and cached single-token decode (port of
``repro/train/serve_step.py:29-77``).

``repro`` jits them with donated cache buffers on a mesh; here they are
plain callables under ``torch.inference_mode()`` on one device, and the
cache is updated in place.  The mesh (``params_shardings``) is not
ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import greedy_sample


def make_prefill_step(model, *, impl: str = "auto",
                      moe_impl: str = "einsum"):
    """(tokens (B, S), **inputs) -> (last-position logits (B, 1, Vpad),
    cache); ``inputs`` are enc-dec's ``frames`` or the VLM's ``patches``.
    ``impl`` picks the full-sequence attention: the CUDA flash_attention
    kernel on CUDA tensors ("auto", "cuda") or the plain chunked path
    ("ref"); ``moe_impl`` the MoE path."""
    def step(tokens, **inputs):
        with torch.inference_mode():
            return model.prefill(tokens, impl=impl, moe_impl=moe_impl,
                                 **inputs)
    return step


def make_serve_step(model, *, moe_impl: str = "einsum"):
    """(cache, tokens (B, 1), pos) -> (logits (B, 1, Vpad), cache), the
    cache updated in place."""
    def step(cache, tokens, pos: int):
        with torch.inference_mode():
            return model.decode_step(cache, tokens, pos, moe_impl=moe_impl)
    return step


def decode_loop(model, cache: dict, first_token: torch.Tensor,
                start_pos: int, n_tokens: int, *, moe_impl: str = "einsum"):
    """Greedy autoregressive loop (host-driven): ``n_tokens`` steps from
    ``first_token`` (B, 1) at ``start_pos``; padded vocab ids are never
    sampled.  Returns (tokens (B, n_tokens + 1), cache)."""
    step = make_serve_step(model, moe_impl=moe_impl)
    tok = first_token
    out = [tok]
    pos = start_pos
    for _ in range(n_tokens):
        logits, cache = step(cache, tok, pos)
        tok = greedy_sample(logits, model.cfg.vocab)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1), cache
