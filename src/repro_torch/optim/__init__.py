"""Optimizers of the LM training path (port of ``repro/optim``): AdamW
with fp32 moments, global-norm clipping, and int8 error-feedback
compression."""
from . import compression
from .adamw import (AdamW, AdamWState, apply_updates, clip_by_global_norm,
                    global_norm)

__all__ = ["AdamW", "AdamWState", "apply_updates", "clip_by_global_norm",
           "global_norm", "compression"]
