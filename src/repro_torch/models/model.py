"""Model-level glue: parameter and FLOP accounting, greedy sampling (port
of ``repro/models/model.py:55-131``).

``model_flops`` is the roofline's useful work: 6·N·D for training and
2·N·D for forward-only serving steps (N = parameters in the active
compute path, D = tokens).  The dense family only: the MoE, SSM, hybrid,
enc-dec and MLA branches of ``repro`` raise ``NotImplementedError``, as
their models do (``transformer.check_supported``).  The loss
(``cross_entropy``, ``loss_fn``) comes with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_params_analytic(cfg) -> dict:
    """Parameter counts straight from the config (no allocation), norms
    excluded, as ``repro`` counts them: {"total": N, "active": N}."""
    transformer.check_supported(cfg)
    d, L = cfg.d_model, cfg.n_layers
    D = transformer.head_dim(cfg)
    embed = cfg.padded_vocab * d
    attn = d * cfg.n_heads * D + 2 * d * cfg.n_kv * D + cfg.n_heads * D * d
    ffn = (2 if cfg.mlp == "gelu" else 3) * d * cfg.d_ff
    total = embed + L * (attn + ffn)
    return {"total": int(total), "active": int(total)}


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for one step of ``shape`` (a ``ShapeSpec``):
    6·N·D train, 2·N·D prefill (D = batch x seq_len tokens), 2·N·batch
    for a decode step."""
    n_active = count_params_analytic(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def greedy_sample(logits: torch.Tensor, vocab: int | None = None
                  ) -> torch.Tensor:
    """argmax over the last axis (int64 token ids).  With ``vocab`` the
    padded ids >= vocab are masked to -inf first."""
    if vocab is not None and logits.shape[-1] > vocab:
        ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(ids < vocab, logits, -torch.inf)
    return torch.argmax(logits, dim=-1)
