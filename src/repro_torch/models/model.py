"""Model-level glue: the training loss, parameter and FLOP accounting,
greedy sampling (port of ``repro/models/model.py``).

``model_flops`` is the roofline's useful work: 6·N·D for training and
2·N·D for forward-only serving steps (N = parameters in the active
compute path, D = tokens).  For MoE, N counts only the active experts
(top_k + shared).

The loss is ``repro``'s padded-vocab causal cross-entropy, in fp32: the
logits of ids >= vocab are set to -1e30, labels equal to ``IGNORE`` are
left out, and the mean runs over the counted tokens; the MoE
load-balance loss is added with ``aux_weight``, and a VLM's patch
positions carry no loss.  ``loss_fn``'s forward is the plain chunked
attention (``impl="ref"``), which autograd differentiates, as
``jax.grad`` differentiates ``repro``'s.
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer
from .ssm import mamba2_dims


IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  tp=None):
    """Padded-vocab causal CE: logits (B, S, Vpad), labels (B, S) with
    ``IGNORE`` for positions without a loss -> (mean loss, n_tokens), both
    0-d tensors (fp32, int64).  With ``tp`` (``dist.tp.TensorParallel``)
    the logits are this rank's vocab block (``token_nll``)."""
    nll, counted = token_nll(logits, labels, vocab, tp)
    n = counted.sum().clamp_min(1)
    return nll.sum() / n, n


def token_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
              tp=None):
    """Each position's negative log-likelihood (0 where not counted) and
    the mask of counted positions.  With ``tp`` the logits (B, S, V_l)
    are rank index's vocab rows [index * V_l, (index + 1) * V_l) over the
    "model" axis: the logsumexp is distributed (an all-reduce MAX of the
    row maxima, then a SUM of exp), and the target's logit comes from the
    rank that holds it (a SUM of one value and zeros); the padded ids
    are masked to -1e30 on their rank."""
    V = logits.shape[-1]
    lo = 0 if tp is None else tp.index * V
    logits = logits.float()
    if lo + V > vocab:
        real = lo + torch.arange(V, device=logits.device) < vocab
        logits = torch.where(real, logits, -1e30)
    target = labels.clamp_min(0)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, target.unsqueeze(-1))[..., 0]
    else:
        m = tp.pmax(logits.amax(dim=-1))
        lse = m + torch.log(tp.reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1)))
        t = target - lo
        inside = (t >= 0) & (t < V)
        own = logits.gather(-1, t.clamp(0, V - 1).unsqueeze(-1))[..., 0]
        picked = tp.reduce(torch.where(inside, own, 0.0))
    counted = labels != IGNORE
    return torch.where(counted, lse - picked, 0.0), counted


def loss_fn(model: nn.Module, cfg, batch: dict, *, moe_impl: str = "einsum",
            remat: bool = False, aux_weight: float = 0.01):
    """The training loss of ``model`` on ``batch`` ({"tokens", "labels"},
    (B, S) each, and enc-dec's "frames" or the VLM's "patches"): (loss,
    {"ce", "aux", "tokens"}), loss = ce + aux_weight * aux.  The labels
    align with the token positions."""
    logits, aux = model(batch["tokens"], frames=batch.get("frames"),
                        patches=batch.get("patches"), impl="ref",
                        moe_impl=moe_impl, remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:       # vlm: the patch positions
        logits = logits[:, -labels.shape[1]:]
    ce, n = cross_entropy(logits, labels, cfg.vocab)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": n}


def grid_loss_fn(gm, batch: dict, *, remat: bool = False,
                 moe_impl: str = "einsum", aux_weight: float = 0.01):
    """The training loss of a ``GridTransformer`` on this cell's rows of
    ``batch`` ({"tokens", "labels"}, (B_l, S) each, and enc-dec's
    "frames" or the VLM's "patches"): (this cell's share of the loss,
    {"ce", "aux", "tokens"}).  The share is its tokens' summed NLL (the
    vocab-parallel logits' distributed logsumexp) over the global
    batch's counted tokens (an all-reduce over ("pod", "data")) plus
    aux_weight * aux over the number of data cells; aux is the global
    batch's balance loss, the same on every cell, whose gradient reaches
    each cell's tokens (``moe.moe_apply``), so the shares' gradients,
    summed over the batch group, are the global loss's, and ``ce`` (the
    shares summed; no gradient) is ``repro``'s mean over the global
    batch."""
    logits, aux = gm.forward(batch["tokens"], frames=batch.get("frames"),
                             patches=batch.get("patches"), impl="ref",
                             remat=remat, moe_impl=moe_impl)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:       # vlm: the patch positions
        logits = logits[:, -labels.shape[1]:]
    tp = gm.tp if gm.vocab_sharded else None
    nll, counted = token_nll(logits, labels, gm.cfg.vocab, tp)
    n = gm.batch.psum(counted.sum())
    share = nll.sum() / n.clamp_min(1) + aux_weight * aux / gm.batch.size
    ce = gm.batch.psum(share.detach()) - aux_weight * aux.detach()
    return share, {"ce": ce, "aux": aux.detach(), "tokens": n}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_params_analytic(cfg) -> dict:
    """Parameter counts straight from the config (no allocation), norms
    excluded, as ``repro`` counts them: {"total": N, "active": N_active};
    active differs for MoE."""
    transformer.block_type(cfg)
    d, L = cfg.d_model, cfg.n_layers
    D = transformer.head_dim(cfg) if cfg.n_heads else 0
    embed = cfg.padded_vocab * d

    def attn_params():
        if cfg.attn_impl == "mla":
            return (d * cfg.q_lora
                    + cfg.q_lora * cfg.n_heads * (cfg.d_nope + cfg.d_rope)
                    + d * (cfg.kv_lora + cfg.d_rope)
                    + cfg.kv_lora * cfg.n_heads * (cfg.d_nope + cfg.d_v)
                    + cfg.n_heads * cfg.d_v * d)
        return d * cfg.n_heads * D + 2 * d * cfg.n_kv * D + cfg.n_heads * D * d

    def mamba_params():
        d_in, H, conv_dim = mamba2_dims(d, cfg.ssm_expand, cfg.ssm_headdim,
                                        cfg.ssm_groups, cfg.ssm_state)
        d_proj = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + H
        return (d * d_proj + cfg.ssm_conv * conv_dim + conv_dim
                + 3 * H + d_in + d_in * d)

    def ffn_params(active: bool):
        if not cfg.n_experts:
            return (2 if cfg.mlp == "gelu" else 3) * d * cfg.d_ff
        e = cfg.top_k if active else cfg.n_experts
        shared = 3 * d * cfg.n_shared * cfg.d_ff if cfg.n_shared else 0
        return e * 3 * d * cfg.d_ff + shared + d * cfg.n_experts

    if cfg.family == "ssm":
        per_layer_total = per_layer_active = mamba_params()
    else:
        a = attn_params() + (mamba_params() if cfg.family == "hybrid"
                             else 0)
        per_layer_total = a + ffn_params(False)
        per_layer_active = a + ffn_params(True)
    total = embed + L * per_layer_total
    active = embed + L * per_layer_active
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn_params()
                                  + (2 if cfg.mlp == "gelu" else 3)
                                  * d * cfg.d_ff)
        xattn = L * attn_params()
        total += enc + xattn
        active += enc + xattn
    return {"total": int(total), "active": int(active)}


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
