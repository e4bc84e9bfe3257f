"""Process-grid builders (port of ``repro/launch/mesh.py``'s
``make_debug_mesh`` / ``make_production_mesh``).

``make_grid`` joins (or starts) the default ``torch.distributed`` process
group and creates the grid's row, column and pod groups
(``dist/sharding.py``): NCCL for CUDA tensors, gloo for CPU ones.  Nothing
here starts a process or a group when imported.  A machine tells a
program nothing of its cluster, so the caller gives the rank, the world
size and the rendezvous address; a one-process grid picks a free
localhost port itself:

    grid = make_grid(data=1, model=1)           # 1 x 1 on cuda, NCCL
    ...
    grid.destroy()

``spawn_grid`` runs a function on every cell of a CPU gloo grid, one
spawned process per cell, and returns what each returned; the tests use
it for the 2 x 2 and 2 x (2 x 2) grids.
"""
from __future__ import annotations

import datetime
import multiprocessing
import pickle
import socket
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.dist.sharding import Grid, check_shape, group_ranks

DEFAULT_TIMEOUT_S = 300


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_grid(pods: int | None = None, data: int = 1, model: int = 1,
              backend: str | None = None, *, rank: int = 0,
              init_method: str | None = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Grid:
    """This process's cell of a (pods, data, model) grid: ``data`` rows by
    ``model`` columns, ``pods`` (default 1) copies for the ensemble's
    member split.  ``device`` defaults to ``cuda``; ``backend`` to NCCL on
    CUDA and gloo on the CPU.  When no default group exists yet this
    joins one of world size pods * data * model at ``init_method``
    (required above one process; a free localhost port for one), and the
    grid's ``destroy`` ends it again.  Every process must call this with
    the same shape: the groups are created in one order on all ranks."""
    pods_n = 1 if pods is None else pods
    check_shape(pods_n, data, model)
    world = pods_n * data * model
    dev = _device.resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        if init_method is None:
            if world != 1:
                raise ValueError(f"a {world}-process grid needs an "
                                 f"init_method every process shares")
            init_method = f"tcp://localhost:{free_port()}"
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != world:
        raise ValueError(f"the default group has {dist.get_world_size()} "
                         f"processes, the grid needs {world}")
    rank = dist.get_rank()
    groups = {}
    for axis, ranks in group_ranks(pods_n, data, model):
        g = dist.new_group(ranks=ranks)
        if rank in ranks:
            groups[axis] = g
    return Grid.at_rank(rank, pods_n, data, model, dev, groups,
                        owns_default_group=owns)


def _grid_worker(fn: Callable, rank: int, shape: tuple, init_method: str,
                 args: tuple, out: str) -> None:
    """One cell of ``spawn_grid``: build the grid, run fn, pickle
    ("ok", result) or ("error", traceback) to ``out``."""
    torch.set_num_threads(1)
    try:
        pods, data, model = shape
        grid = make_grid(pods, data, model, "gloo", rank=rank,
                         init_method=init_method, device="cpu",
                         timeout_s=120)
        try:
            payload = ("ok", fn(grid, *args))
        finally:
            grid.destroy()
    except Exception:  # the boundary: hand the failure to the parent
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def spawn_grid(fn: Callable, tmp_dir, *, pods: int | None = None,
               data: int = 2, model: int = 2, args: tuple = (),
               timeout_s: float = 300) -> list:
    """Run ``fn(grid, *args)`` on every cell of a CPU gloo grid, one
    spawned process per cell, and return the results in rank order.

    ``fn`` must be importable by name from a module that the workers can
    import (they start from a fresh interpreter); arguments and results
    travel by pickle, results through files under ``tmp_dir``.  A worker
    that raises fails the call with its traceback; a grid that does not
    finish within ``timeout_s`` is terminated."""
    pods_n = 1 if pods is None else pods
    check_shape(pods_n, data, model)
    world = pods_n * data * model
    tmp = Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    init_method = f"file://{tmp / 'rendezvous'}"
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_grid_worker,
                         args=(fn, r, (pods, data, model), init_method, args,
                               str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"grid ranks {hung} did not finish within "
                               f"{timeout_s} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if not out.exists():
            errors.append(f"rank {r}: exit code {p.exitcode}, no result")
            continue
        with open(out, "rb") as f:
            status, value = pickle.load(f)   # written by our own workers
        if status == "error":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError("spawn_grid failed:\n" + "\n".join(errors))
    return results
