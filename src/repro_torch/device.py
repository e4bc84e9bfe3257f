"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  A caller
that wants the CPU says so; nothing here drops to the CPU on its own.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on.  ``None`` means ``cuda``;
    asking for CUDA on a machine without it raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and convolutions.  ``rel_error``'s
    cancelling identity (core/rescal.py) needs true fp32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
