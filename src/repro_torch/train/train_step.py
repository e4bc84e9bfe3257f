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

On an LM grid (``make_train_step(cfg, grid=grid)``, ``repro``'s
``make_train_step(cfg, mesh)``) the state is placed as ``repro``'s
``state_shardings`` places it: the parameters are this cell's
tensor-parallel blocks (``train.serve_step.params_shardings``) and the
moments ZeRO-1's (``dist.sharding.opt_state_specs``): where the spec
puts "data" on a layer stack, one data rank holds a layer's moments
whole; on another dim, each data rank a slice; else each data rank a
copy.  A step takes the global batch and runs this cell's rows
(``batch_shardings``); the gradients are all-reduced over ("pod",
"data"); each cell keeps the part whose moments it holds (with
microbatches, the fp32 accumulator holds only that part), clips by the
global norm over every distinct part (a replicated parameter counted
once), updates that part, and the updated part reaches every data rank
that holds the parameter (a broadcast from a layer's owner, or an
all-gather of the slices).  ``batch_shardings`` (``repro``'s name here)
is ``dist.sharding.batch_shardings``.  ``repro``'s train step does not call
``optim.compression.ef_psum``, and this one does not either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.dist.sharding import (DATA_AXIS, MODEL_AXIS, Grid, Spec,
                                       batch_shardings, shard_batch)
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import (GridTransformer, Transformer,
                                            lm_placement)
from repro_torch.optim import AdamW, AdamWState, clip_by_global_norm


class TrainState(NamedTuple):
    params: Transformer
    opt: AdamWState
    step: torch.Tensor


def init_state(cfg, optimizer: AdamW, *, generator: torch.Generator,
               device=None, grid: Grid | None = None) -> TrainState:
    """A fresh state on ``device`` (default ``cuda``): parameters drawn
    from ``generator`` (a generator on that device), zero moments.  With
    ``grid`` the whole model is drawn, then placed (this cell's blocks on
    the grid's device) and the moments are ZeRO-1's (``zero1_moments``)."""
    model = Transformer(cfg, device=_device.resolve(device), gen=generator)
    if grid is None:
        return TrainState(params=model,
                          opt=optimizer.init(dict(model.named_parameters())),
                          step=torch.zeros((), dtype=torch.int64))
    from .serve_step import params_shardings
    params_shardings(grid, model)
    return TrainState(params=model, opt=zero1_moments(grid, model, optimizer),
                      step=torch.zeros((), dtype=torch.int64))


def state_shapes(cfg, optimizer: AdamW) -> TrainState:
    """The state ``init_state`` builds, on the meta device (``repro``'s
    ``state_shapes``): the port's own model and the optimizer's own
    moments, shapes and dtypes only, no allocation.  The update count
    and the step stay host scalars, as in ``init_state``."""
    model = Transformer(cfg, device="meta")
    return TrainState(params=model,
                      opt=optimizer.init(dict(model.named_parameters())),
                      step=torch.zeros((), dtype=torch.int64))


def zero1_moments(grid: Grid, model: Transformer, optimizer: AdamW
                  ) -> AdamWState:
    """Zero moments for the parts of a placed model's parameters whose
    moments this cell holds (``LMPlacement.owned``); a parameter whose
    moments another data rank holds has none here."""
    placement = lm_placement(grid, model.cfg)
    owned = {n: placement.owned(n, p.detach())
             for n, p in model.named_parameters()}
    return optimizer.init({n: x for n, x in owned.items() if x is not None})


def state_shardings(grid: Grid, cfg) -> TrainState:
    """The state's placement (``repro``'s ``state_shardings``), by the
    port's parameter names: each parameter's tensor-parallel ``Spec``
    (without the layer axis), the moments' ZeRO-1 ``Spec`` (a layer
    whose moments one data rank holds whole shows "data" first, on the
    layer axis ``repro`` stacks), and the replicated count and step."""
    placement = lm_placement(grid, cfg)
    params = {n: pp.spec for n, pp in placement.params.items()}
    moments = {n: (Spec(DATA_AXIS, *pp.moment) if pp.owner is not None
                   else pp.moment) for n, pp in placement.params.items()}
    return TrainState(params=params,
                      opt=AdamWState(m=moments, v=dict(moments),
                                     count=Spec()),
                      step=Spec())


def make_train_step(cfg, *, grid: Grid | None = None,
                    optimizer: AdamW | None = None,
                    remat: bool = True, moe_impl: str = "einsum",
                    clip_norm: float = 1.0,
                    aux_weight: float = 0.01,
                    microbatches: int | None = None):
    """The step: (state, batch) -> (state, metrics).  ``batch`` is
    {"tokens", "labels"} (B, S) (and enc-dec's "frames" or the VLM's
    "patches"), on any device (copied to the parameters');
    ``moe_impl`` picks the MoE path; ``microbatches`` defaults to
    cfg.train_microbatches and must divide B.  With ``grid`` the state
    is a grid state (``init_state(grid=)``), the batch is the global one
    and the step runs as the module docstring says (every family on any
    LM grid; an MoE on several data cells needs each microbatch's rows to
    split evenly over them, ``ValueError``)."""
    optimizer = optimizer or AdamW()
    mb = microbatches or getattr(cfg, "train_microbatches", 1) or 1
    if grid is not None:
        return _grid_step(cfg, grid, optimizer, mb, remat, moe_impl,
                          clip_norm, aux_weight)

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


def _grid_step(cfg, grid: Grid, optimizer: AdamW, mb: int, remat: bool,
               moe_impl: str, clip_norm: float, aux_weight: float):
    """make_train_step's step on an LM grid (module docstring)."""
    placement = lm_placement(grid, cfg)
    batch_group = grid.axis("batch")

    def grads_of(gm, names, params, batch):
        gm.check_rows(batch["tokens"].shape[0])
        share, metrics = model_lib.grid_loss_fn(
            gm, shard_batch(grid, batch), remat=remat, moe_impl=moe_impl,
            aux_weight=aux_weight)
        grads = torch.autograd.grad(share, params)
        # the shares' gradients summed over ("pod", "data")
        grads = [batch_group.psum(g) for g in grads]
        loss = batch_group.psum(share.detach())
        return loss, metrics, dict(zip(names, grads))

    def owned(grads):
        parts = {n: placement.owned(n, g) for n, g in grads.items()}
        return {n: g for n, g in parts.items() if g is not None}

    def accumulate(gm, names, params, batch):
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches")
        per = B // mb
        acc: dict = {}
        loss_sum = aux_sum = tok_sum = 0
        for i in range(mb):
            part = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = grads_of(gm, names, params, part)
            for n, g in owned(grads).items():
                if n in acc:
                    acc[n].add_(g.float())
                else:
                    acc[n] = g.float()
            del grads
            loss_sum = loss_sum + loss
            tok_sum = tok_sum + metrics["tokens"]
            aux_sum = aux_sum + metrics["aux"]
        dtypes = dict(zip(names, (p.dtype for p in params)))
        grads = {n: (a / mb).to(dtypes[n]) for n, a in acc.items()}
        return loss_sum / mb, {"ce": loss_sum / mb, "aux": aux_sum / mb,
                               "tokens": tok_sum}, grads

    def clip(grads: dict):
        """``clip_by_global_norm`` over the owned parts: each distinct
        part's squares counted once (summed over "model" where the
        parameter is split there, over "data" where the data ranks hold
        different parts)."""
        dev = grid.device
        sums = torch.zeros(4, dtype=torch.float32, device=dev)
        for n, g in grads.items():
            c = (2 * placement.data_sharded(n)
                 + placement.model_sharded(n))
            sums[c] += torch.sum(torch.square(g.float()))
        model_part = grid.psum(sums[1::2], MODEL_AXIS)
        data_part = grid.psum(torch.stack([sums[2], model_part[1]]),
                              DATA_AXIS)
        norm = torch.sqrt(sums[0] + model_part[0] + data_part.sum())
        scale = torch.clamp(clip_norm / torch.clamp_min(norm, 1e-12),
                            max=1.0)
        return {n: (g.float() * scale).to(g.dtype)
                for n, g in grads.items()}, norm

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.params
        gm = GridTransformer(model, grid, placement)
        dev = model.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        names, params = zip(*model.named_parameters())
        if mb > 1:
            loss, metrics, grads = accumulate(gm, names, params, batch)
        else:
            loss, metrics, full = grads_of(gm, names, params, batch)
            grads = owned(full)
            del full
        grads, gnorm = clip(grads)
        live = {n: placement.owned(n, p.detach())
                for n, p in zip(names, params)}
        with torch.no_grad():
            updates, opt = optimizer.update(grads, state.opt, live)
            del grads
            for n, p in zip(names, params):
                if n in updates:
                    live[n].add_(updates.pop(n))
                placement.sync(n, p.data)
        return (TrainState(params=model, opt=opt, step=state.step + 1),
                dict(metrics, loss=loss, grad_norm=gnorm))

    return step
