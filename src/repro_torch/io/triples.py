"""NPZ triple ingest to a deduplicated COO tensor (port of
``repro/io/triples.py:127,216``, NPZ only; TSV ingest comes later).

``read_coo_npz`` yields bounded chunks of a pre-numbered COO file (arrays
``row``/``rel``/``col`` and optional ``val``); ``ingest_npz`` accumulates
them and merges duplicate coordinates by summation, as ``repro``'s
``COOBuilder`` does.  Host numpy, O(nnz) memory.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

DEFAULT_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class COOTensor:
    """Deduplicated COO relational tensor (relation-major coordinates)."""
    rels: np.ndarray   # (nnz,) int64 relation ids in [0, m)
    rows: np.ndarray   # (nnz,) int64 entity ids in [0, n)
    cols: np.ndarray   # (nnz,) int64
    vals: np.ndarray   # (nnz,) float32
    n: int             # entities
    m: int             # relations

    @property
    def nnz(self) -> int:
        return int(self.rels.shape[0])


def read_coo_npz(path: str, *, chunk: int = DEFAULT_CHUNK
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]]:
    """Yield (rows, rels, cols, vals) id chunks from an NPZ COO file."""
    with np.load(path) as data:
        rows = np.asarray(data["row"], np.int64)
        rels = np.asarray(data["rel"], np.int64)
        cols = np.asarray(data["col"], np.int64)
        vals = (np.asarray(data["val"], np.float32) if "val" in data
                else np.ones(rows.shape[0], np.float32))
    if not (rows.shape == rels.shape == cols.shape == vals.shape):
        raise ValueError(f"COO arrays disagree: {rows.shape} {rels.shape} "
                         f"{cols.shape} {vals.shape}")
    for s in range(0, rows.shape[0], chunk):
        e = s + chunk
        yield rows[s:e], rels[s:e], cols[s:e], vals[s:e]


def coo_from_chunks(chunks) -> COOTensor:
    """Concatenate (rows, rels, cols, vals) chunks, sort by (rel, row, col)
    and sum duplicates.  n and m are one past the largest ids."""
    parts = list(chunks)
    if not parts:
        z = np.zeros(0, np.int64)
        return COOTensor(rels=z, rows=z, cols=z,
                         vals=np.zeros(0, np.float32), n=0, m=0)
    rows, rels, cols, vals = (np.concatenate(p) for p in zip(*parts))
    vals = vals.astype(np.float32)
    if min(rows.min(), cols.min(), rels.min()) < 0:
        raise ValueError("negative entity or relation id")
    n = int(max(rows.max(), cols.max())) + 1
    m = int(rels.max()) + 1
    order = np.lexsort((cols, rows, rels))
    rels, rows, cols, vals = (rels[order], rows[order], cols[order],
                              vals[order])
    new = np.empty(rels.shape[0], bool)
    new[0] = True
    new[1:] = ((rels[1:] != rels[:-1]) | (rows[1:] != rows[:-1])
               | (cols[1:] != cols[:-1]))
    starts = np.flatnonzero(new)
    vals = np.add.reduceat(vals, starts).astype(np.float32)
    return COOTensor(rels=rels[starts], rows=rows[starts],
                     cols=cols[starts], vals=vals, n=n, m=m)


def ingest_npz(path: str, *, chunk: int = DEFAULT_CHUNK) -> COOTensor:
    """Chunked NPZ COO ingest (ids already assigned upstream)."""
    return coo_from_chunks(read_coo_npz(path, chunk=chunk))
