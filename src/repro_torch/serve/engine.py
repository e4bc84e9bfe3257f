"""ServeEngine — online link prediction over a FactorBundle (port of
``repro/serve/engine.py``).

Request path, as ``repro``'s:

  1. cache probe: queries are keyed (mode, anchor, rel); a hot-head LRU
     answers repeated keys without the device;
  2. micro-batching: the uncached keys are deduplicated and scored in
     chunks padded to exactly ``ServeConfig.batch`` rows (pad rows are
     anchor 0, relation 0; their results are dropped on the host);
  3. scoring: gather the anchors, orient R per query (``(s, r, ?)`` uses
     R[r], ``(?, r, o)`` uses R[r]^T), V = A[anchor] @ R_q, and rank every
     entity with ``kernels.ops.score_topk``, which never builds the
     (batch, n) score matrix (the CUDA kernel on the card, its plain
     version on the CPU).

Overload sheds, as in ``repro``: uncached keys past ``admit``, and chunks
that would start after ``deadline``, get (-inf, -1) with ``shed=True``.
``reload`` validates a new bundle's digest before it swaps anything.

Traced (``obs.trace``) as ``repro``'s engine is: a ``serve/request`` span
per request, a ``serve/score`` span per device batch (closed after the
scores reach the host), ``serve/shed`` and ``serve/cache`` instants per
request, and a ``serve/reload`` span and instant per reload.  ``query``
probes the ``serve/request`` fault seam at admission
(``resilience.faults``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.obs import trace as obs
from repro_torch.resilience import faults

from .bundle import FactorBundle

MODES = ("sro", "sor")


class Query(NamedTuple):
    mode: str          # "sro" = (s, r, ?) | "sor" = (?, r, o)
    anchor: int        # subject id (sro) or object id (sor)
    rel: int


class QueryResult(NamedTuple):
    scores: np.ndarray     # (topk,) f32, descending
    indices: np.ndarray    # (topk,) i32, -1 past n
    cached: bool
    shed: bool = False     # dropped under deadline/admission pressure


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    topk: int = 10
    batch: int = 32              # rows of every scoring call
    cache_entries: int = 4096    # 0 disables the hot-head LRU
    pn: int | None = None        # plain score_topk panel (None: default)
    kernel: KernelPolicy = KernelPolicy()
    deadline: float | None = None  # per-request wall-clock budget, seconds
    admit: int | None = None     # max uncached keys scored per request


class ServeEngine:
    """Stateful server over one FactorBundle, on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).  Not thread-safe: one engine per
    worker."""

    def __init__(self, bundle: FactorBundle, cfg: ServeConfig | None = None,
                 device=None):
        self.cfg = cfg or ServeConfig()
        self.device = _device.resolve(device)
        self.bundle = bundle
        self.A = torch.as_tensor(bundle.A, device=self.device)
        self.R = torch.as_tensor(bundle.R, device=self.device)
        self.n, self.k, self.m = bundle.n, bundle.k, bundle.m
        self._cache: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = self.misses = self.evictions = 0
        self.batches = 0
        self.sheds = self.reloads = 0

    # -- cache ------------------------------------------------------------

    def _cache_get(self, entry):
        hit = self._cache.get(entry)
        if hit is not None:
            self._cache.move_to_end(entry)
        return hit

    def _cache_put(self, entry, value):
        if self.cfg.cache_entries <= 0:
            return
        self._cache[entry] = value
        self._cache.move_to_end(entry)
        while len(self._cache) > self.cfg.cache_entries:
            self._cache.popitem(last=False)
            self.evictions += 1

    # -- scoring ----------------------------------------------------------

    def _score(self, anchors: torch.Tensor, rels: torch.Tensor,
               is_sro: torch.Tensor):
        E = self.A[anchors]                                  # (b, k)
        Rq = self.R[rels]                                    # (b, k, k)
        Rq = torch.where(is_sro[:, None, None], Rq, Rq.transpose(1, 2))
        V = torch.einsum("bi,bij->bj", E, Rq).contiguous()
        return ops.score_topk(V, self.A, topk=self.cfg.topk,
                              impl=self.cfg.kernel.impl, pn=self.cfg.pn)

    def _score_chunk(self, keys: list[tuple]) -> list[tuple]:
        """Score up to ``batch`` unique (mode, anchor, rel) keys in one
        call of ``batch`` rows; pad rows are dropped on the host."""
        b = self.cfg.batch
        anchors = np.zeros(b, np.int64)
        rels = np.zeros(b, np.int64)
        is_sro = np.ones(b, bool)
        for j, (mode, anchor, rel) in enumerate(keys):
            anchors[j], rels[j], is_sro[j] = anchor, rel, mode == "sro"
        dev = self.device
        with obs.span("serve/score", batch=b, live=len(keys)):
            s, i = self._score(torch.from_numpy(anchors).to(dev),
                               torch.from_numpy(rels).to(dev),
                               torch.from_numpy(is_sro).to(dev))
            s, i = s.cpu().numpy(), i.cpu().numpy()  # waits for the device
        self.batches += 1
        return [(s[j], i[j]) for j in range(len(keys))]

    def _shed_sentinel(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.full(self.cfg.topk, -np.inf, np.float32),
                np.full(self.cfg.topk, -1, np.int32))

    def query(self, queries: Sequence[Query]) -> list[QueryResult]:
        """Answer a request.  Overload degrades, never queues: uncached
        keys past cfg.admit, and chunks that would start after
        cfg.deadline has elapsed, are shed with the (-inf, -1) sentinel
        and ``shed=True``."""
        with obs.span("serve/request", n=len(queries)):
            faults.probe("serve/request", n=len(queries))
            t0 = time.perf_counter()
            results: list[QueryResult | None] = [None] * len(queries)
            pending: OrderedDict[tuple, list[int]] = OrderedDict()
            for i, q in enumerate(queries):
                if q.mode not in MODES:
                    raise ValueError(f"query mode must be one of {MODES}, "
                                     f"got {q.mode!r}")
                if not (0 <= q.anchor < self.n and 0 <= q.rel < self.m):
                    raise ValueError(f"query out of range for (n={self.n}, "
                                     f"m={self.m}): {q}")
                key = (q.mode, int(q.anchor), int(q.rel))
                hit = self._cache_get(key)
                if hit is not None:
                    self.hits += 1
                    results[i] = QueryResult(hit[0], hit[1], True)
                else:
                    self.misses += 1
                    pending.setdefault(key, []).append(i)
            uniq = list(pending)
            shed_keys: list[tuple] = []
            admit = self.cfg.admit
            if admit is not None and len(uniq) > admit:
                uniq, shed_keys = uniq[:admit], uniq[admit:]
            for c0 in range(0, len(uniq), self.cfg.batch):
                if (self.cfg.deadline is not None
                        and time.perf_counter() - t0 > self.cfg.deadline):
                    shed_keys.extend(uniq[c0:])
                    break
                chunk = uniq[c0:c0 + self.cfg.batch]
                for key, out in zip(chunk, self._score_chunk(chunk)):
                    self._cache_put(key, out)
                    for i in pending[key]:
                        results[i] = QueryResult(out[0], out[1], False)
            if shed_keys:
                sent = self._shed_sentinel()
                n_shed = 0
                for key in shed_keys:
                    for i in pending[key]:
                        results[i] = QueryResult(sent[0], sent[1], False, True)
                        n_shed += 1
                self.sheds += n_shed
                obs.event("serve/shed", queries=n_shed, keys=len(shed_keys),
                          elapsed=round(time.perf_counter() - t0, 6))
            obs.event("serve/cache", hits=self.hits, misses=self.misses,
                      evictions=self.evictions, size=len(self._cache))
        return results      # type: ignore[return-value]

    # -- hot reload --------------------------------------------------------

    def reload(self, bundle_dir: str) -> FactorBundle:
        """Swap in the factors of another on-disk bundle.  The load checks
        the digest (``FactorBundle.load`` raises BundleError) and the
        factors reach the device before anything changes, so a bad bundle
        leaves the engine serving the old factors."""
        with obs.span("serve/reload", path=bundle_dir):
            new = FactorBundle.load(bundle_dir)             # may raise
            A = torch.as_tensor(new.A, device=self.device)
            R = torch.as_tensor(new.R, device=self.device)
            # commit point: nothing before this changed the engine
            self.bundle, self.A, self.R = new, A, R
            self.n, self.k, self.m = new.n, new.k, new.m
            self._cache.clear()
            self.reloads += 1
            if obs.current() is not None:   # digest() hashes A and R
                obs.event("serve/reload", digest=new.digest(), n=new.n,
                          k=new.k, m=new.m)
        return new

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "batches": self.batches,
                "sheds": self.sheds, "reloads": self.reloads,
                "cache_size": len(self._cache)}


# -- query sources --------------------------------------------------------

def random_queries(n: int, m: int, count: int, *, skew: float = 1.1,
                   seed: int = 0, mode: str = "mixed") -> list[Query]:
    """A zipf-skewed query stream (rank r anchor ~ r^-skew, the shape the
    hot-head cache exists for).  mode: sro | sor | mixed."""
    rng = np.random.default_rng(seed)
    anchors = (rng.zipf(max(skew, 1.01), size=count) - 1) % n
    rels = rng.integers(0, m, size=count)
    if mode == "mixed":
        modes = np.where(rng.random(count) < 0.5, "sro", "sor")
    elif mode in MODES:
        modes = np.full(count, mode)
    else:
        raise ValueError(f"mode must be sro|sor|mixed, got {mode!r}")
    return [Query(str(md), int(a), int(r))
            for md, a, r in zip(modes, anchors, rels)]


def parse_queries_tsv(path: str, *, entities: list[str] | None = None,
                      relations: list[str] | None = None) -> list[Query]:
    """Parse ``s<TAB>r<TAB>?`` / ``?<TAB>r<TAB>o`` lines into queries.
    Names resolve through the bundle vocab when present; otherwise every
    field must already be an integer id."""
    ent_id = {name: i for i, name in enumerate(entities or [])}
    rel_id = {name: i for i, name in enumerate(relations or [])}

    def _id(tok: str, table: dict, what: str, lineno: int) -> int:
        if tok in table:
            return table[tok]
        try:
            return int(tok)
        except ValueError:
            raise ValueError(f"{path}:{lineno}: unknown {what} {tok!r} "
                             f"(not in bundle vocab, not an id)") from None

    queries = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 3 or (parts[0] == "?") == (parts[2] == "?"):
                raise ValueError(f"{path}:{lineno}: want "
                                 f"'s<TAB>r<TAB>?' or '?<TAB>r<TAB>o', "
                                 f"got {line!r}")
            s, r, o = parts
            rel = _id(r, rel_id, "relation", lineno)
            if o == "?":
                queries.append(Query("sro", _id(s, ent_id, "entity",
                                                lineno), rel))
            else:
                queries.append(Query("sor", _id(o, ent_id, "entity",
                                                lineno), rel))
    return queries
