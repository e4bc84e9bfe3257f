"""Serving steps: prefill and cached single-token decode (port of
``repro/train/serve_step.py``).

``repro`` jits them with donated cache buffers, on one device or on a
mesh; here they are plain callables under ``torch.inference_mode()``,
and the cache is updated in place.  On an LM grid (``grid=``) the model
is first placed (``params_shardings``: each parameter's block on this
cell, ``repro``'s NamedSharding tree) and the steps run the
``models.transformer.GridTransformer``: the prefill takes the global
batch and keeps this cell's rows, its cache holds this cell's rows and
block of positions (``dist.sharding.cache_specs``), and a decode step
takes and gives this cell's rows, its logits over every vocab id.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import Grid
from repro_torch.models.model import greedy_sample
from repro_torch.models.transformer import (GridTransformer, Transformer,
                                            lm_placement)


def params_shardings(grid: Grid, model: Transformer) -> Transformer:
    """Place ``model``'s parameters on ``grid``: each becomes this cell's
    block (``dist.sharding.param_specs``), copied to the grid's device,
    in place; returns the model.  Every family places on any LM grid."""
    placement = lm_placement(grid, model.cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = placement.local(name, p.data).to(
                grid.device, copy=True).contiguous()
    return model


def make_prefill_step(model, *, impl: str = "auto",
                      moe_impl: str = "einsum", grid: Grid | None = None,
                      max_len: int | None = None):
    """(tokens (B, S), **inputs) -> (last-position logits (B, 1, Vpad),
    cache); ``inputs`` are enc-dec's ``frames`` or the VLM's ``patches``.
    ``impl`` picks the full-sequence attention: the CUDA flash_attention
    kernel on CUDA tensors ("auto", "cuda") or the plain chunked path
    ("ref"); ``moe_impl`` the MoE path.  With ``grid`` (a placed model)
    the tokens and inputs are the global batch's, the logits this cell's
    rows, and the cache has ``max_len`` positions (default S plus the
    patches), this cell's blocks."""
    if grid is not None:
        gm = GridTransformer(model, grid)

        def grid_step(tokens, **inputs):
            with torch.inference_mode():
                return gm.prefill(tokens, max_len, impl=impl,
                                  moe_impl=moe_impl, **inputs)
        return grid_step

    def step(tokens, **inputs):
        with torch.inference_mode():
            return model.prefill(tokens, impl=impl, moe_impl=moe_impl,
                                 **inputs)
    return step


def make_serve_step(model, *, moe_impl: str = "einsum",
                    grid: Grid | None = None):
    """(cache, tokens (B, 1), pos) -> (logits (B, 1, Vpad), cache), the
    cache updated in place; with ``grid``, this cell's rows of each."""
    target = model if grid is None else GridTransformer(model, grid)

    def step(cache, tokens, pos: int):
        with torch.inference_mode():
            return target.decode_step(cache, tokens, pos, moe_impl=moe_impl)
    return step


def decode_loop(model, cache: dict, first_token: torch.Tensor,
                start_pos: int, n_tokens: int, *, moe_impl: str = "einsum",
                grid: Grid | None = None):
    """Greedy autoregressive loop (host-driven): ``n_tokens`` steps from
    ``first_token`` (B, 1) at ``start_pos``; padded vocab ids are never
    sampled.  Returns (tokens (B, n_tokens + 1), cache); with ``grid``,
    this cell's rows."""
    step = make_serve_step(model, moe_impl=moe_impl, grid=grid)
    tok = first_token
    out = [tok]
    pos = start_pos
    for _ in range(n_tokens):
        logits, cache = step(cache, tok, pos)
        tok = greedy_sample(logits, model.cfg.vocab)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1), cache
