"""The training step: loss -> grads -> clip -> AdamW (port of
``repro/train/train_step.py``), on one device.

State (``TrainState``):
  params  — the ``Transformer`` (bf16 parameters at the published widths)
  opt     — ``AdamWState``: fp32 moments keyed by parameter name
  step    — 0-d int64 on the host

``make_train_step(cfg, ...)`` returns ``step_fn(state, batch) -> (state,
metrics)``.  The parameters and the moments are updated in place (the
port's counterpart of ``repro``'s donated state): no second copy of
either exists.  ``microbatches > 1`` splits the batch along its rows,
accumulates fp32 gradients, divides them by the count and casts them to
each parameter's dtype, and averages the loss, as ``repro``'s
``accumulate`` does.  ``remat`` recomputes each decoder block in the
backward (``Transformer.forward(remat=True)``).  The metrics are 0-d
tensors: ce, aux, tokens, loss and grad_norm (before clipping).

``repro``'s ``state_shardings``/``batch_shardings`` (the GSPMD mesh of
the step) wait for the LM mesh (ROADMAP.md §1 item 5(d)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamW, AdamWState, clip_by_global_norm


class TrainState(NamedTuple):
    params: Transformer
    opt: AdamWState
    step: torch.Tensor


def init_state(cfg, optimizer: AdamW, *, generator: torch.Generator,
               device=None) -> TrainState:
    """A fresh state on ``device`` (default ``cuda``): parameters drawn
    from ``generator`` (a generator on that device), zero moments."""
    model = Transformer(cfg, device=_device.resolve(device), gen=generator)
    return TrainState(params=model,
                      opt=optimizer.init(dict(model.named_parameters())),
                      step=torch.zeros((), dtype=torch.int64))


def make_train_step(cfg, *, optimizer: AdamW | None = None,
                    remat: bool = True, moe_impl: str = "einsum",
                    clip_norm: float = 1.0,
                    aux_weight: float = 0.01,
                    microbatches: int | None = None):
    """The step: (state, batch) -> (state, metrics).  ``batch`` is
    {"tokens", "labels"} (B, S) (and enc-dec's "frames" or the VLM's
    "patches"), on any device (copied to the parameters');
    ``moe_impl`` picks the MoE path; ``microbatches`` defaults to
    cfg.train_microbatches and must divide B."""
    optimizer = optimizer or AdamW()
    mb = microbatches or getattr(cfg, "train_microbatches", 1) or 1

    def grads_of(model, names, params, batch):
        loss, metrics = model_lib.loss_fn(model, cfg, batch,
                                          moe_impl=moe_impl, remat=remat,
                                          aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), metrics, dict(zip(names, grads))

    def accumulate(model, names, params, batch):
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches")
        per = B // mb
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in zip(names, params)}
        loss_sum = aux_sum = tok_sum = 0
        for i in range(mb):
            part = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = grads_of(model, names, params, part)
            for n, g in grads.items():
                acc[n].add_(g.float())
            del grads
            loss_sum = loss_sum + loss
            tok_sum = tok_sum + metrics["tokens"]
            aux_sum = aux_sum + metrics["aux"].detach()
        grads = {n: (acc.pop(n) / mb).to(p.dtype)
                 for n, p in zip(names, params)}
        return loss_sum / mb, {"ce": loss_sum / mb, "aux": aux_sum / mb,
                               "tokens": tok_sum}, grads

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.params
        dev = model.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        names, params = zip(*model.named_parameters())
        if mb > 1:
            loss, metrics, grads = accumulate(model, names, params, batch)
        else:
            loss, metrics, grads = grads_of(model, names, params, batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        live = dict(zip(names, params))
        with torch.no_grad():
            updates, opt = optimizer.update(grads, state.opt, live)
            del grads
            for n, p in live.items():
                p.add_(updates.pop(n))
        return (TrainState(params=model, opt=opt, step=state.step + 1),
                dict(metrics, loss=loss, grad_norm=gnorm))

    return step
