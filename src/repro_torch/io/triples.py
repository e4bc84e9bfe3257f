"""Triple ingest to a deduplicated COO tensor (port of
``repro/io/triples.py:59,98,127,172,202,216``).

``read_triples_tsv`` yields bounded chunks of a TSV triple list
(``head \t relation \t tail [\t weight]``), which ``Vocab`` numbers in
order of first appearance; ``read_coo_npz`` yields bounded chunks of a
pre-numbered COO file (arrays ``row``/``rel``/``col`` and optional
``val``).  ``ingest_tsv``/``ingest_npz`` (and ``COOBuilder``) accumulate
the chunks and merge duplicate coordinates by summation, as ``repro``'s
does, so the COO and the vocab equal ``repro``'s.  Host numpy, O(nnz)
memory.
Traced as ``ingest/tsv`` and ``ingest/npz`` spans (``obs.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.resilience import faults

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


class Vocab:
    """Entity/relation id assignment in first-appearance order."""

    def __init__(self):
        self.entities: dict[str, int] = {}
        self.relations: dict[str, int] = {}

    @property
    def n(self) -> int:
        return len(self.entities)

    @property
    def m(self) -> int:
        return len(self.relations)

    def entity_id(self, name: str) -> int:
        eid = self.entities.get(name)
        if eid is None:
            eid = self.entities[name] = len(self.entities)
        return eid

    def relation_id(self, name: str) -> int:
        rid = self.relations.get(name)
        if rid is None:
            rid = self.relations[name] = len(self.relations)
        return rid

    def encode(self, heads: Sequence[str], rels: Sequence[str],
               tails: Sequence[str]) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Ids of one chunk.  A chunk's heads are numbered before its
        tails, as in ``repro``: the ids depend on that order."""
        h = np.fromiter((self.entity_id(x) for x in heads), np.int64,
                        len(heads))
        r = np.fromiter((self.relation_id(x) for x in rels), np.int64,
                        len(rels))
        t = np.fromiter((self.entity_id(x) for x in tails), np.int64,
                        len(tails))
        return h, r, t

    def names(self) -> tuple[list[str], list[str]]:
        """(entities, relations) as lists in id order."""
        return list(self.entities), list(self.relations)


def read_triples_tsv(path: str, *, chunk: int = DEFAULT_CHUNK
                     ) -> Iterator[tuple[list[str], list[str], list[str],
                                         np.ndarray]]:
    """Yield (heads, rels, tails, vals) string chunks from a TSV triple
    list.  Blank lines and ``#`` comments are skipped; a missing 4th column
    means weight 1.0."""
    heads: list[str] = []
    rels: list[str] = []
    tails: list[str] = []
    vals: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(f"malformed triple line: {line!r}")
            heads.append(parts[0])
            rels.append(parts[1])
            tails.append(parts[2])
            vals.append(float(parts[3]) if len(parts) > 3 else 1.0)
            if len(heads) >= chunk:
                yield heads, rels, tails, np.asarray(vals, np.float32)
                heads, rels, tails, vals = [], [], [], []
    if heads:
        yield heads, rels, tails, np.asarray(vals, np.float32)


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


def coo_from_chunks(chunks, *, n: int | None = None,
                    m: int | None = None) -> COOTensor:
    """Concatenate (rows, rels, cols, vals) chunks, sort by (rel, row, col)
    and sum duplicates.  Declared n and m override the inferred ones (one
    past the largest ids); an id outside them raises ``ValueError``."""
    parts = list(chunks)
    if not parts:
        z = np.zeros(0, np.int64)
        return COOTensor(rels=z, rows=z, cols=z,
                         vals=np.zeros(0, np.float32), n=n or 0, m=m or 0)
    rows, rels, cols, vals = (np.concatenate(p) for p in zip(*parts))
    vals = vals.astype(np.float32)
    n = n if n is not None else int(max(rows.max(), cols.max())) + 1
    m = m if m is not None else int(rels.max()) + 1
    if (min(rows.min(), cols.min(), rels.min()) < 0
            or max(rows.max(), cols.max()) >= n or rels.max() >= m):
        raise ValueError("coordinate out of bounds for declared (m, n)")
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


class COOBuilder:
    """Streaming COO accumulator (``repro``'s): ``add`` appends one id
    chunk, ``finalize`` sorts and sums duplicates (``coo_from_chunks``).
    ``add`` is the ``ingest/chunk`` fault seam: a raise-* spec kills the
    chunk, a nan-poison spec corrupts its values in place."""

    def __init__(self):
        self._chunks: list[tuple] = []

    def add(self, rels, rows, cols, vals) -> "COOBuilder":
        vals = np.asarray(vals, np.float32)
        faults.probe("ingest/chunk", arrays=vals, chunk=len(self._chunks))
        self._chunks.append((np.asarray(rows, np.int64),
                             np.asarray(rels, np.int64),
                             np.asarray(cols, np.int64), vals))
        return self

    def finalize(self, *, n: int | None = None,
                 m: int | None = None) -> COOTensor:
        return coo_from_chunks(self._chunks, n=n, m=m)


def ingest_tsv(path: str, *, chunk: int = DEFAULT_CHUNK
               ) -> tuple[COOTensor, Vocab]:
    """One-pass TSV ingest: number the names while accumulating the COO
    chunks.  Every name appears in some triple, so n and m are the vocab's
    sizes."""
    vocab = Vocab()
    builder = COOBuilder()
    with obs.span("ingest/tsv", path=path, chunk=chunk):
        for heads, rels, tails, vals in read_triples_tsv(path, chunk=chunk):
            h, r, t = vocab.encode(heads, rels, tails)
            builder.add(r, h, t, vals)
        return builder.finalize(), vocab


def ingest_npz(path: str, *, n: int | None = None, m: int | None = None,
               chunk: int = DEFAULT_CHUNK) -> COOTensor:
    """Chunked NPZ COO ingest (ids already assigned upstream); ``n`` and
    ``m`` declare the dimensions, as ``coo_from_chunks`` takes them."""
    builder = COOBuilder()
    with obs.span("ingest/npz", path=path, chunk=chunk):
        for rows, rels, cols, vals in read_coo_npz(path, chunk=chunk):
            builder.add(rels, rows, cols, vals)
        return builder.finalize(n=n, m=m)
