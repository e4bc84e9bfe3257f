"""Fault-tolerant training loop: checkpoint/restart and the straggler
watchdog (port of ``repro/train/loop.py``).

The loop is restart-identical by construction: a batch is a pure
function of the step (``data.tokens.batch_at``) and a checkpoint holds
the parameters, the moments, the update count and the step, so a
restore followed by the replay reproduces the trajectory bit for bit
(under ``torch.use_deterministic_algorithms`` on the card).  Before each
step the loop probes the ``train/step`` fault seam
(``resilience.faults``).  Restarts are classified by the
``RetryPolicy``: a transient error (``TransientError``, ``OSError``, ...)
restores the newest checkpoint (or a fresh state when there is none yet)
after the policy's deterministic backoff; any other error, or a run
without ``ckpt_dir``, or one past ``max_restarts``, raises at once with
its own traceback.

A restore copies the checkpoint into the live state's tensors (its
``like`` is built on the ``meta`` device), so the device never holds a
second state.  Saves and restores are ``train/save`` and
``train/restore`` spans (``obs.trace``); the run's last step is saved
once (``repro`` writes it again when it falls on ``save_every``).

On an LM grid (``grid=``, ``repro``'s ``mesh=``) the step is the grid
step and a checkpoint holds the global arrays, as ``repro``'s global
format does: every cell takes part in gathering the parameters (over
"model") and the moments (over "data", then "model"), rank 0 writes
them, and the cells wait for each other (``Grid.agree``) before the
next step.  A restore reads the global arrays on every cell and keeps
this cell's blocks.  The cells must share the checkpoint directory, and
``async_save`` is refused there (the other cells could restore before
rank 0's write ends).  A fault must strike every cell alike (the
``train/step`` seam fires on every cell at the same hit): an error on
one cell only leaves the others waiting in a collective until the
group's timeout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import ckpt
from repro_torch import device as _device
from repro_torch.dist.elastic import StragglerMonitor
from repro_torch.dist.sharding import Grid
from repro_torch.models.transformer import lm_placement, named_shapes
from repro_torch.obs import trace as obs
from repro_torch.optim import AdamW
from repro_torch.resilience import RetryPolicy, faults

from .train_step import TrainState, init_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    save_every: int = 50
    log_every: int = 10
    max_restarts: int = 3
    straggler_factor: float = 2.5
    seed: int = 0
    # write checkpoints on a background thread; the previous write is
    # joined (re-raising any failure) at the next save boundary
    async_save: bool = False


def state_tree(state: TrainState, grid: Grid | None = None) -> dict:
    """The state as a tree of tensors for ``ckpt``: {"params": {name:
    tensor}, "opt": {"m", "v", "count"}, "step"}; on ``grid`` the global
    arrays, gathered (every cell must call this)."""
    named = dict(state.params.named_parameters())
    if grid is None:
        return {"params": {n: p.detach() for n, p in named.items()},
                "opt": {"m": state.opt.m, "v": state.opt.v,
                        "count": state.opt.count},
                "step": state.step}
    pl = lm_placement(grid, state.params.cfg)
    params = {n: pl.gather_param(n, p.detach()) for n, p in named.items()}
    moments = {part: {n: pl.gather_moment(n, getattr(state.opt, part).get(n),
                                          p.detach())
                      for n, p in named.items()} for part in ("m", "v")}
    return {"params": params,
            "opt": {**moments, "count": state.opt.count},
            "step": state.step}


def load_tree(state: TrainState, tree: dict, grid: Grid | None = None
              ) -> TrainState:
    """Copy a restored tree (``state_tree``'s layout, on any device) into
    ``state``'s tensors in place (on ``grid``, this cell's blocks of the
    global arrays); returns the state with the restored count and
    step."""
    pl = None if grid is None else lm_placement(grid, state.params.cfg)
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            x = tree["params"][name]
            p.copy_(x if pl is None else pl.local(name, x))
        for part in ("m", "v"):
            for name, x in getattr(state.opt, part).items():
                y = tree["opt"][part][name]
                x.copy_(y if pl is None else pl.place_owned(name, y))
    opt = state.opt._replace(count=tree["opt"]["count"].to(torch.int32))
    return TrainState(params=state.params, opt=opt,
                      step=tree["step"].to(torch.int64))


def _meta_like(tree):
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _global_like(state: TrainState) -> dict:
    """``state_tree(state, grid)``'s layout on the meta device, from the
    global shapes (no collective)."""
    shapes = named_shapes(state.params.cfg)
    dtypes = {n: p.dtype for n, p in state.params.named_parameters()}

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    moments = {n: meta(s, torch.float32) for n, s in shapes.items()}
    return {"params": {n: meta(s, dtypes[n]) for n, s in shapes.items()},
            "opt": {"m": moments, "v": dict(moments),
                    "count": meta((), torch.int32)},
            "step": meta((), torch.int64)}


def train_loop(cfg, batch_fn: Callable[[int], Any], loop: LoopConfig, *,
               optimizer: AdamW | None = None, remat: bool = True,
               moe_impl: str = "einsum", retry: RetryPolicy | None = None,
               device=None, grid: Grid | None = None,
               verbose: bool = False) -> tuple[TrainState, list[dict]]:
    """Run ``loop.steps`` steps of ``cfg`` on ``device`` (default
    ``cuda``; on ``grid``, the grid's device) with checkpoint/restart;
    returns (state, history), one dict of floats per executed step
    (replayed steps appear again).

    batch_fn(step) -> batch (a pure function of step; on a grid the
    global batch, the same on every cell).  ``retry`` classifies errors
    and gives the backoff between restarts (the budget is
    loop.max_restarts, not the policy's attempts)."""
    optimizer = optimizer or AdamW()
    policy = retry or RetryPolicy()
    dev = grid.device if grid is not None else _device.resolve(device)
    if grid is not None and loop.async_save and loop.ckpt_dir:
        raise ValueError("async_save is refused on a grid: the other cells "
                         "could restore before rank 0's write ends")
    step_fn = make_train_step(cfg, grid=grid, optimizer=optimizer,
                              remat=remat, moe_impl=moe_impl)

    def generator() -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(loop.seed)
        return g

    def fresh(state: TrainState | None) -> TrainState:
        if state is None or grid is not None:
            return init_state(cfg, optimizer, generator=generator(),
                              device=dev, grid=grid)
        state.params.init_parameters(generator())
        for part in (state.opt.m, state.opt.v):
            for x in part.values():
                x.zero_()
        return TrainState(params=state.params,
                          opt=state.opt._replace(count=torch.zeros(
                              (), dtype=torch.int32)),
                          step=torch.zeros((), dtype=torch.int64))

    def try_restore(state: TrainState | None) -> tuple[TrainState, int]:
        if loop.ckpt_dir and ckpt.latest_step(loop.ckpt_dir) is not None:
            if state is None:
                state = fresh(None)
            like = (_meta_like(state_tree(state)) if grid is None
                    else _global_like(state))
            with obs.span("train/restore"):
                tree, step = ckpt.restore(loop.ckpt_dir, like)
                return load_tree(state, tree, grid), step
        return fresh(state), 0

    pending: list[ckpt.AsyncSave] = []

    def surface_pending() -> None:
        # a failed background save surfaces here, at the next checkpoint
        # boundary: it must not silently age the restore point
        while pending:
            pending.pop().join()

    saved = [-1]

    def save_state(step: int, state: TrainState) -> None:
        surface_pending()
        with obs.span("train/save", step=step, async_save=loop.async_save):
            tree = state_tree(state, grid)
            if loop.async_save:
                pending.append(ckpt.save_async(loop.ckpt_dir, step, tree))
            elif grid is None or grid.rank == 0:
                ckpt.save(loop.ckpt_dir, step, tree)
            del tree
            if grid is not None:
                grid.agree([step])          # the files exist for every cell
        saved[0] = step

    state, start = try_restore(None)
    monitor = StragglerMonitor(factor=loop.straggler_factor)
    history: list[dict] = []
    restarts = 0
    step = start
    while step < loop.steps:
        try:
            faults.probe("train/step", step=step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            metrics.update(step=step, seconds=dt,
                           straggler=monitor.record(step, dt))
            history.append(metrics)
            obs.event("train/step", **metrics)
            if verbose and step % loop.log_every == 0:
                print(f"[train] step={step} loss={metrics['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            step += 1
            if loop.ckpt_dir and step % loop.save_every == 0:
                save_state(step, state)
        except Exception as err:     # noqa: BLE001 — classified below
            restarts += 1
            if (not policy.is_transient(err) or not loop.ckpt_dir
                    or restarts > loop.max_restarts):
                raise
            obs.event("train/restart", step=step, restarts=restarts,
                      error=type(err).__name__)
            pause = policy.backoff(restarts + 1, key="train")
            if pause > 0.0:
                time.sleep(pause)
            surface_pending()
            state, step = try_restore(state)
    if loop.ckpt_dir:
        if saved[0] != step:
            save_state(step, state)
        surface_pending()
    return state, history
