"""Model-level glue: the training loss, parameter and FLOP accounting,
greedy sampling (port of ``repro/models/model.py``).

``model_flops`` is the roofline's useful work: 6·N·D for training and
2·N·D for forward-only serving steps (N = parameters in the active
compute path, D = tokens).  The dense family only: the MoE, SSM, hybrid,
enc-dec and MLA branches of ``repro`` raise ``NotImplementedError``, as
their models do (``transformer.check_supported``).

The loss is ``repro``'s padded-vocab causal cross-entropy, in fp32: the
logits of ids >= vocab are set to -1e30, labels equal to ``IGNORE`` are
left out, and the mean runs over the counted tokens.  ``loss_fn``'s
forward is the plain chunked attention (``impl="ref"``), which autograd
differentiates, as ``jax.grad`` differentiates ``repro``'s.
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer


IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """Padded-vocab causal CE: logits (B, S, Vpad), labels (B, S) with
    ``IGNORE`` for positions without a loss -> (mean loss, n_tokens), both
    0-d tensors (fp32, int64)."""
    Vp = logits.shape[-1]
    logits = logits.float()
    if Vp > vocab:
        real = torch.arange(Vp, device=logits.device) < vocab
        logits = torch.where(real, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0).unsqueeze(-1))[..., 0]
    counted = labels != IGNORE
    nll = torch.where(counted, lse - picked, 0.0)
    n = counted.sum().clamp_min(1)
    return nll.sum() / n, n


def loss_fn(model: nn.Module, cfg, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01):
    """The training loss of ``model`` on ``batch`` ({"tokens", "labels"},
    (B, S) each): (loss, {"ce", "aux", "tokens"}), loss = ce + aux_weight
    * aux."""
    logits, aux = model(batch["tokens"], impl="ref", remat=remat)
    ce, n = cross_entropy(logits, batch["labels"], cfg.vocab)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": n}


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
