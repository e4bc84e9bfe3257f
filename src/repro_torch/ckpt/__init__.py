"""Atomic, digest-verified, self-healing checkpoints (port of
``repro/ckpt``), and the crash-safe file writes every artifact writer of
the port shares."""
from .checkpoint import (AsyncSave, CheckpointError, atomic_json_dump,
                         atomic_write, latest_step, restore, save,
                         save_async, verify_step)

__all__ = ["AsyncSave", "CheckpointError", "atomic_json_dump",
           "atomic_write", "latest_step", "restore", "save", "save_async",
           "verify_step"]
