"""Error-feedback int8 gradient compression (port of
``repro/optim/compression.py``): a symmetric per-tensor int8 payload
with an fp32 scale (amax / 127), and error feedback that carries each
step's quantization residual into the next, so the sum of what was sent
plus the carried error equals the sum of the raw gradients.

``ef_psum`` is ``repro``'s compressed all-reduce with error feedback
over one axis of a process grid (``repro``'s is a ``shard_map``
collective over a mesh axis): the building block only, which neither
package's train step calls.  ``compress``/``decompress`` also serve
standalone, e.g. to shrink a checkpoint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # fp32 scalar


def compress(x: torch.Tensor) -> Compressed:
    """Symmetric per-tensor int8 quantization."""
    x32 = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return Compressed(q=q.to(torch.int8), scale=scale)


def decompress(c: Compressed, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    return (c.q.float() * c.scale).to(dtype)


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> tuple[Compressed, torch.Tensor]:
    """Error-feedback step: (compressed, new_err) with decompress(
    compressed) + new_err == g + err up to fp32 rounding."""
    target = g.float() + err
    c = compress(target)
    return c, target - decompress(c)


def ef_psum(g: torch.Tensor, err: torch.Tensor, grid, axis: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed mean of g over ``axis`` of ``grid``
    (``dist.sharding.Grid``) with error feedback: (mean in g's dtype,
    new_err).  The ranks agree on one scale (an all-reduce MAX of each
    one's amax of g + err), each quantizes g + err to int8 with it and
    keeps the residual, and the int8 payloads are summed exactly in
    int32 (exact for up to 2^23 summands)."""
    target = g.float() + err
    amax = grid.pmax(torch.max(torch.abs(target)), axis)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.float() * scale
    qsum = grid.psum(q.to(torch.int32), axis)
    mean = qsum.float() * scale / grid.axis_size(axis)
    return mean.to(g.dtype), new_err


def init_error(params: dict) -> dict:
    """Zero fp32 error buffers like ``params``."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
