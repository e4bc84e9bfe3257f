"""Checkpoints with atomic writes, digests and self-healing (port of
``repro/ckpt/checkpoint.py``), in ``repro``'s on-disk format:

    <dir>/step_<n>.npz        one array per leaf, keyed by its tree path
                              ("A", "R", "errors"; nested: "params/w")
    <dir>/step_<n>.json       manifest: step, and per leaf its shape,
                              dtype and sha256
    <dir>/LATEST              text file with the newest step number

so a step written by either package restores in the other.  A tree is a
nested dict, list or tuple of torch tensors; leaves go to the host as
numpy (a dict's keys in sorted order, as ``jax`` flattens them).

Writes are atomic (temporary file, then ``os.replace``), so a crash in a
save never tears the restore point.  The digests make torn multi-file
writes, bit rot and truncation detectable, and :func:`restore` survives
them: a step that fails verification is quarantined (renamed
``step_<n>.corrupt.*``, with a ``ckpt/quarantine`` event), restore falls
back through older steps to the newest verifiable one, and ``LATEST`` is
repointed at it.

:func:`save_async` copies the tensors to host numpy before it returns and
writes the files on a thread; the :class:`AsyncSave` handle's
``join()``/``result()`` re-raise a failed write.  The fault seams
``ckpt/write`` (after a step's writes) and ``ckpt/read`` (before a step
is loaded) are probed where ``repro`` fires them.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
import warnings
from typing import IO, Any, Callable

import numpy as np
import torch

from repro_torch.obs import trace as obs
from repro_torch.resilience import faults

_STEP_MANIFEST = re.compile(r"^step_(\d+)\.json$")


class CheckpointError(RuntimeError):
    """A checkpoint failed to load or verify."""


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
    artifact the port writes (reports, bundle manifests, sweep
    fingerprints)."""
    return atomic_write(path, "w", lambda f: json.dump(obj, f, **json_kwargs))


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array that owns its bytes (a snapshot:
    later writes to the tensor do not reach it).  bfloat16 goes out as
    raw 2-byte voids, as numpy stores ``repro``'s."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: _host(tree)}
    out: dict[str, np.ndarray] = {}
    for name, sub in items:
        out.update(_flatten(sub, f"{prefix}/{name}" if prefix else str(name)))
    return out


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _leaf_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _manifest(step: int, arrays: dict[str, np.ndarray]) -> dict:
    return {"step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v),
                           "sha256": _leaf_digest(v)}
                       for k, v in arrays.items()}}


def _point_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def _write_step(ckpt_dir: str, step: int,
                arrays: dict[str, np.ndarray]) -> str:
    """The step writer behind save and save_async: npz, then manifest,
    then LATEST, each a temporary file replaced onto its name, so every
    prefix of a crash leaves a verifiable step or none."""
    os.makedirs(ckpt_dir, exist_ok=True)
    base = os.path.join(ckpt_dir, f"step_{step}")
    with open(base + ".npz.tmp", "wb") as f:
        np.savez(f, **arrays)
    with open(base + ".json.tmp", "w") as f:
        json.dump(_manifest(step, arrays), f)
    os.replace(base + ".npz.tmp", base + ".npz")
    os.replace(base + ".json.tmp", base + ".json")
    _point_latest(ckpt_dir, step)
    faults.probe("ckpt/write", path=base + ".npz", step=step)
    return base + ".npz"


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step``; returns the npz path."""
    return _write_step(ckpt_dir, step, _flatten(tree))


class AsyncSave:
    """A checkpoint write on a background thread.  The thread parks its
    exception here; ``join()``/``result()`` re-raise it."""

    def __init__(self, ckpt_dir: str, step: int,
                 arrays: dict[str, np.ndarray]):
        self.step = step
        self._path: str | None = None
        self._error: BaseException | None = None

        def _write():
            try:
                self._path = _write_step(ckpt_dir, step, arrays)
            except BaseException as err:    # noqa: BLE001 — re-raised in join
                self._error = err

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: float | None = None) -> None:
        """Wait for the write; re-raise its failure."""
        self._thread.join(timeout)
        if self._error is not None:
            raise CheckpointError(
                f"async save of step {self.step} failed: "
                f"{self._error}") from self._error

    def result(self, timeout: float | None = None) -> str:
        """join(), then the written npz path."""
        self.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"async save of step {self.step} still "
                               f"running after {timeout}s")
        assert self._path is not None
        return self._path


def save_async(ckpt_dir: str, step: int, tree) -> AsyncSave:
    """Copy ``tree`` to host numpy now, write it in the background."""
    return AsyncSave(ckpt_dir, step, _flatten(tree))


def _scan_steps(ckpt_dir: str) -> list[int]:
    """Step numbers with a manifest on disk, newest first (quarantined
    ``step_*.corrupt.json`` files do not match)."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    return sorted((int(m.group(1)) for name in names
                   if (m := _STEP_MANIFEST.match(name))), reverse=True)


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(path):
        try:
            with open(path) as f:
                text = f.read().strip()
            if text:
                return int(text)
            raise ValueError("empty LATEST")
        except (OSError, ValueError) as err:
            warnings.warn(f"unreadable LATEST in {ckpt_dir} ({err}); "
                          f"scanning step manifests instead", stacklevel=2)
    steps = _scan_steps(ckpt_dir)
    return steps[0] if steps else None


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff step ``step`` loads and every leaf matches its manifest
    entry (shape, sha256)."""
    try:
        _load_step(ckpt_dir, step)
        return True
    except CheckpointError:
        return False


def _load_step(ckpt_dir: str, step: int) -> dict[str, np.ndarray]:
    """Load and verify one step against its manifest; CheckpointError on
    missing or torn files, a leaf-set mismatch, shape drift or a digest
    mismatch."""
    base = os.path.join(ckpt_dir, f"step_{step}")
    try:
        with open(base + ".json") as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as err:
        raise CheckpointError(f"step {step}: bad manifest: {err}") from err
    try:
        with np.load(base + ".npz", allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as err:
        raise CheckpointError(f"step {step}: bad npz: {err}") from err
    leaves = manifest.get("leaves", {})
    if set(arrays) != set(leaves):
        raise CheckpointError(
            f"step {step}: npz/manifest leaf sets differ "
            f"(npz-only={sorted(set(arrays) - set(leaves))}, "
            f"manifest-only={sorted(set(leaves) - set(arrays))})")
    for key, meta in leaves.items():
        arr = arrays[key]
        if list(arr.shape) != list(meta["shape"]):
            raise CheckpointError(f"step {step}: leaf {key!r} shape "
                                  f"{list(arr.shape)} != manifest "
                                  f"{meta['shape']}")
        want = meta.get("sha256")
        if want is not None and _leaf_digest(arr) != want:
            raise CheckpointError(f"step {step}: leaf {key!r} sha256 "
                                  f"mismatch (corrupt bytes?)")
    return arrays


def _quarantine(ckpt_dir: str, step: int, reason: str) -> None:
    """Rename a bad step out of the restore path and record it."""
    base = os.path.join(ckpt_dir, f"step_{step}")
    moved = []
    for ext in (".npz", ".json"):
        if os.path.exists(base + ext):
            os.replace(base + ext, f"{base}.corrupt{ext}")
            moved.append(ext)
    warnings.warn(f"quarantined checkpoint step {step} in {ckpt_dir}: "
                  f"{reason}", stacklevel=3)
    obs.event("ckpt/quarantine", step=step, reason=reason,
              files=len(moved))


def restore(ckpt_dir: str, like, step: int | None = None, *,
            device: torch.device | str | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``, whose tensor leaves give the
    shapes and dtypes (e.g. tensors on the ``meta`` device); the leaves
    come back as tensors on ``device`` (default: the CPU).  Returns (tree,
    step).

    A step that fails verification is quarantined and restore falls back
    through older steps; only when no step survives does it raise.  A
    structure mismatch against ``like`` is the caller's error, not
    corruption: it raises without quarantine."""
    newest = latest_step(ckpt_dir)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    candidates = sorted({newest, *_scan_steps(ckpt_dir)}, reverse=True)
    if step is not None:
        candidates = [s for s in candidates if s <= step]
        if not candidates:
            raise CheckpointError(f"no checkpoint step <= {step} "
                                  f"in {ckpt_dir}")
    healed = False
    for s in candidates:
        faults.probe("ckpt/read",
                     path=os.path.join(ckpt_dir, f"step_{s}.npz"), step=s)
        try:
            arrays = _load_step(ckpt_dir, s)
        except CheckpointError as err:
            _quarantine(ckpt_dir, s, str(err))
            healed = True
            continue
        tree = _assemble(arrays, like, s, "", device)
        if healed:      # LATEST pointed at a quarantined step
            _point_latest(ckpt_dir, s)
        return tree, s
    raise CheckpointError(f"no verifiable checkpoint step in {ckpt_dir} "
                          f"({len(candidates)} candidate(s) quarantined)")


def _assemble(arrays: dict[str, np.ndarray], like, step: int, prefix: str,
              device):
    if isinstance(like, dict):
        return {name: _assemble(arrays, sub, step,
                                f"{prefix}/{name}" if prefix else str(name),
                                device)
                for name, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _assemble(arrays, sub, step,
                      f"{prefix}/{i}" if prefix else str(i), device)
            for i, sub in enumerate(like))
    if prefix not in arrays:
        raise CheckpointError(f"step {step}: leaf {prefix!r} missing from "
                              f"checkpoint (have {sorted(arrays)})")
    arr = arrays[prefix]
    if tuple(arr.shape) != tuple(like.shape):
        raise CheckpointError(f"step {step}: leaf {prefix!r} shape "
                              f"{tuple(arr.shape)} != restore target "
                              f"{tuple(like.shape)}")
    want = like.dtype
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and want == torch.bfloat16:
        out = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(arr, order="C")).to(want)
    return out.to(device) if device is not None else out
