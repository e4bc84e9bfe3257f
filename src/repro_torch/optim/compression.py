"""Error-feedback int8 gradient compression (port of
``repro/optim/compression.py``): a symmetric per-tensor int8 payload
with an fp32 scale (amax / 127), and error feedback that carries each
step's quantization residual into the next, so the sum of what was sent
plus the carried error equals the sum of the raw gradients.

``repro``'s ``ef_psum``, the compressed all-reduce of the data-parallel
path (a ``shard_map`` collective), is not ported: it waits for the LM
mesh (ROADMAP.md §1 item 5(d)).  ``compress``/``decompress`` also serve
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


def init_error(params: dict) -> dict:
    """Zero fp32 error buffers like ``params``."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
