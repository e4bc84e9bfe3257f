"""Crash-safe file writes (port of ``repro/ckpt/checkpoint.py:54``
``atomic_json_dump``; the rest of the checkpoint layer is not ported yet).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import IO, Callable


def atomic_write(path: str, mode: str, write: Callable[[IO], None]) -> str:
    """Call ``write`` on a temporary file in ``path``'s folder, then
    ``os.replace`` it onto ``path``: a reader sees the old file or the new
    one, never a torn one.  ``mode`` is "w" or "wb"."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def atomic_json_dump(path: str, obj, **json_kwargs) -> str:
    """Write JSON crash-safely (``atomic_write``).  Shared by every JSON
    artifact the port writes (reports, bundle manifests)."""
    return atomic_write(path, "w", lambda f: json.dump(obj, f, **json_kwargs))
