"""Dataset manifests (port of ``repro/io/manifest.py``): one identity for
every operand the sweep takes — a dense tensor, a ``core.sparse.BCSR``,
an ``io.partition.ShardedBCSR`` or an ``io.virtual.VirtualSpec``.

A manifest is the operand's identity: a content digest, its shape (with
``n_factor``, the factor-space rows: the padded, permuted entity count of
a sharded operand), and its logical vs resident bytes.  The digest of a
BCSR is two moments of the stored values plus a sha1 of the block
pattern (and of the permutation, when sharded); of a dense X, its two
moments plus the entity-index-weighted row and column sums, which a
symmetric permutation of the entities shifts; of a virtual spec, the sha1
of its spec string.  The FactorBundle records the fingerprint.

The fields equal ``repro``'s for the same operand, with one exception:
the moments are fp32 sums printed with ``%.6e``, and PyTorch and XLA add
in different orders, so their last printed digits can differ (XLA's CPU
sum strays up to ~2e-5 from the float64 sum on the tests' tensors, the
port's within 1e-6).  The index and spec digests are exact.  A virtual spec's per-shard nnzb comes from
its pattern, so from the draw source (``io.virtual``): equal to
``repro``'s on ``repro``'s uniforms.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np
import torch

from repro_torch.ckpt import atomic_json_dump
from repro_torch.core.sparse import BCSR

from .partition import ShardedBCSR
from .virtual import VirtualSpec, virtual_shard_nnzb

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
    kind: str                 # dense | bcsr | bcsr-sharded | virtual-*
    m: int
    n: int                    # logical entity count
    n_factor: int             # factor-space rows (padded/permuted n)
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

    def save(self, path: str) -> str:
        return atomic_json_dump(path, self.fingerprint(), indent=1)

    @classmethod
    def load(cls, path: str) -> "DatasetManifest":
        with open(path) as f:
            d = json.load(f)
        if d.get("grid") is not None:
            d["grid"] = tuple(d["grid"])
        if d.get("nnzb") is not None:
            d["nnzb"] = tuple(d["nnzb"])
        return cls(**d)


def _virtual_manifest(spec: VirtualSpec, source, extra: dict
                      ) -> DatasetManifest:
    itemsize = spec.torch_dtype.itemsize
    if spec.kind == "dense":
        nnzb = None
        resident = (spec.grid * spec.grid
                    * spec.m * spec.n_loc * spec.n_loc * itemsize)
    else:
        counts = virtual_shard_nnzb(spec, source)
        nnzb = tuple(int(v) for v in counts.reshape(-1))
        z_max = max(int(counts.max()), 1)
        resident = (spec.grid * spec.grid
                    * (spec.m * z_max * spec.bs * spec.bs * itemsize
                       + 2 * z_max * 4))
    return DatasetManifest(
        kind=f"virtual-{spec.kind}", m=spec.m, n=spec.n, n_factor=spec.n,
        dtype=spec.dtype,
        digest=hashlib.sha1(spec.spec_string().encode()).hexdigest()[:16],
        logical_bytes=spec.logical_bytes, resident_bytes=resident,
        block_size=spec.bs if spec.kind == "bcsr" else None,
        grid=(spec.grid, spec.grid), nnzb=nnzb,
        extra={"spec": spec.spec_string(), **extra})


def manifest_of(operand, *, extra: dict | None = None,
                source=None) -> DatasetManifest:
    """The manifest of a sweep operand: a dense (m, n, n) tensor, a BCSR
    without a member axis, a ShardedBCSR, or a VirtualSpec (index only:
    no value is generated; ``source`` is its draw source, default the
    seeded one)."""
    extra = dict(extra or {})
    if isinstance(operand, VirtualSpec):
        return _virtual_manifest(operand, source, extra)
    if isinstance(operand, ShardedBCSR):
        sh = operand
        itemsize = sh.data.element_size()
        return DatasetManifest(
            kind="bcsr-sharded", m=sh.m, n=sh.n, n_factor=sh.n_pad,
            dtype=_dtype_name(sh.data.dtype),
            digest=(_moments_digest(sh.data) + ":" + _index_digest(
                sh.rows.cpu().numpy(), sh.cols.cpu().numpy(),
                sh.part.perm)),
            logical_bytes=sh.m * sh.n * sh.n * itemsize,
            resident_bytes=sh.resident_bytes, block_size=sh.bs,
            grid=(sh.g, sh.g),
            nnzb=tuple(int(v) for v in sh.nnzb.reshape(-1)), extra=extra)
    if torch.is_tensor(operand):
        if operand.dim() != 3 or operand.shape[1] != operand.shape[2]:
            raise TypeError(f"a dense operand must be (m, n, n), got "
                            f"{tuple(operand.shape)}")
        m, n, _ = operand.shape
        nbytes = operand.numel() * operand.element_size()
        return DatasetManifest(
            kind="dense", m=m, n=n, n_factor=n,
            dtype=_dtype_name(operand.dtype), digest=_dense_digest(operand),
            logical_bytes=nbytes, resident_bytes=nbytes, extra=extra)
    if not isinstance(operand, BCSR) or operand.batch_shape:
        raise TypeError("manifest_of takes a dense tensor, a BCSR without "
                        "a member axis, a ShardedBCSR or a VirtualSpec")
    sp = operand
    itemsize = sp.data.element_size()
    resident = sp.data.numel() * itemsize + 2 * sp.nnzb * 4
    return DatasetManifest(
        kind="bcsr", m=sp.m, n=sp.n, n_factor=sp.n,
        dtype=_dtype_name(sp.data.dtype),
        digest=(_moments_digest(sp.data) + ":" + _index_digest(
            sp.block_rows.cpu().numpy(), sp.block_cols.cpu().numpy())),
        logical_bytes=sp.m * sp.n * sp.n * itemsize,
        resident_bytes=resident, block_size=sp.bs, nnzb=(sp.nnzb,),
        extra=extra)


def operand_dims(operand) -> tuple[int, int]:
    """(m, n_factor) of a sweep operand: the dims the ensemble's factor
    shapes derive from."""
    if isinstance(operand, VirtualSpec):
        return operand.m, operand.n
    if isinstance(operand, ShardedBCSR):
        return operand.m, operand.n_pad
    if isinstance(operand, BCSR):
        return operand.m, operand.n
    return operand.shape[0], operand.shape[1]
