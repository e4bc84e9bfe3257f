"""Dataset manifests (port of ``repro/io/manifest.py:41-121,162-195``: a
BCSR or a dense operand; sharded and virtual operands come with their
slices).

A manifest is the operand's identity: a content digest, its shape, and
its logical vs resident bytes.  The digest of a BCSR is two moments of
the stored values plus a sha1 of the block pattern; of a dense X, its two
moments plus the entity-index-weighted row and column sums, which a
symmetric permutation of the entities shifts.  The FactorBundle records
the fingerprint.

The fields equal ``repro``'s for the same operand, with one exception:
the moments are fp32 sums printed with ``%.6e``, and PyTorch and XLA add
in different orders, so their last printed digit can differ.  The index
digest is exact.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.sparse import BCSR

__all__ = ["DatasetManifest", "manifest_of", "operand_dims"]


def _moments_digest(x: torch.Tensor) -> str:
    """Two-moment content digest of a tensor, computed where it lies, one
    slice of the leading axis at a time (a BLAS dot takes at most 2^31 - 1
    values; a full-size dense X holds 2^31)."""
    sq = sum(float(torch.dot(s, s)) for s in x.flatten(1))
    return f"{float(x.sum()):.6e}/{sq:.6e}"


def _dense_digest(X: torch.Tensor) -> str:
    """The moments plus sum_tij i X_tij and sum_tij j X_tij."""
    e = torch.arange(X.shape[1], dtype=X.dtype, device=X.device)
    wr = float(X.sum(dim=(0, 2)) @ e)
    wc = float(X.sum(dim=(0, 1)) @ e)
    return f"{_moments_digest(X)}/{wr:.6e}/{wc:.6e}"


def _index_digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype ("float32", not "torch.float32")."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class DatasetManifest:
    kind: str                 # bcsr | dense (bcsr-sharded | virtual-* later)
    m: int
    n: int                    # logical entity count
    n_factor: int             # factor-space rows
    dtype: str
    digest: str
    logical_bytes: int
    resident_bytes: int
    block_size: int | None = None
    grid: tuple[int, int] | None = None
    nnzb: tuple[int, ...] | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def compression(self) -> float:
        """logical / resident bytes."""
        return self.logical_bytes / max(self.resident_bytes, 1)

    def byte_ledger(self) -> dict[str, Any]:
        return {"kind": self.kind,
                "logical_bytes": int(self.logical_bytes),
                "resident_bytes": int(self.resident_bytes),
                "compression": self.compression}

    def fingerprint(self) -> dict[str, Any]:
        """JSON-able identity (what a FactorBundle records)."""
        d = dataclasses.asdict(self)
        d["grid"] = None if self.grid is None else list(self.grid)
        d["nnzb"] = None if self.nnzb is None else list(self.nnzb)
        return d


def manifest_of(operand) -> DatasetManifest:
    """The manifest of a BCSR or a dense (m, n, n) operand (one tensor, no
    member axis)."""
    if torch.is_tensor(operand):
        if operand.dim() != 3 or operand.shape[1] != operand.shape[2]:
            raise TypeError(f"a dense operand must be (m, n, n), got "
                            f"{tuple(operand.shape)}")
        m, n, _ = operand.shape
        nbytes = operand.numel() * operand.element_size()
        return DatasetManifest(
            kind="dense", m=m, n=n, n_factor=n,
            dtype=_dtype_name(operand.dtype), digest=_dense_digest(operand),
            logical_bytes=nbytes, resident_bytes=nbytes)
    if not isinstance(operand, BCSR) or operand.batch_shape:
        raise TypeError("manifest_of takes a BCSR without a member axis or "
                        "a dense tensor (other operands are not ported yet)")
    sp = operand
    itemsize = sp.data.element_size()
    resident = sp.data.numel() * itemsize + 2 * sp.nnzb * 4
    return DatasetManifest(
        kind="bcsr", m=sp.m, n=sp.n, n_factor=sp.n,
        dtype=_dtype_name(sp.data.dtype),
        digest=(_moments_digest(sp.data) + ":" + _index_digest(
            sp.block_rows.cpu().numpy(), sp.block_cols.cpu().numpy())),
        logical_bytes=sp.m * sp.n * sp.n * itemsize,
        resident_bytes=resident, block_size=sp.bs, nnzb=(sp.nnzb,))


def operand_dims(operand) -> tuple[int, int]:
    """(m, n) of a BCSR or a dense (m, n, n) operand."""
    if isinstance(operand, BCSR):
        return operand.m, operand.n
    return operand.shape[0], operand.shape[1]
