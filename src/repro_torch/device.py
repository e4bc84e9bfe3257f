"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  A caller
that wants the CPU says so; nothing here drops to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on.  ``None`` means ``cuda``;
    asking for CUDA on a machine without it raises.  ``meta`` (tensors
    with shapes and no storage) serves shape queries such as
    ``models.transformer.param_shapes``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and convolutions.  ``rel_error``'s
    cancelling identity (core/rescal.py) needs true fp32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def seeded_generator(*words: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from integer words
    through numpy's ``SeedSequence``: one independent stream per tuple of
    words (seed, stream, member, shard, ...), the port's counterpart of
    ``jax.random``'s ``fold_in``."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state >> np.uint64(1)))
    return g
