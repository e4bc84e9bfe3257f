"""RESCAL link-prediction serving CLI of the port (port of
``repro/launch/serve.py``): answer KG-completion queries from a
FactorBundle (``rescalk_run --bundle`` or ``--report`` writes one).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --factors /tmp/report.bundle --queries random:256 --topk 10

Runs on the H100 by default; ``--device cpu`` scores with the plain
PyTorch version on the CPU.  Query sources (--queries):

    random:COUNT[:SKEW]   a zipf-skewed synthetic stream (rank-r anchor
                          ~ r^-SKEW, default 1.1)
    path.tsv              ``s<TAB>r<TAB>?`` / ``?<TAB>r<TAB>o`` lines; names
                          resolve through the bundle vocab when present

--mode sro|sor forces every query's direction (mixed by default for
random streams; TSV lines carry their own).  Requests are micro-batched
to --batch rows and scored by the ``score_topk`` kernel; the reply prints
per-request latency percentiles and throughput.  With --trace DIR the
request/score/cache spans and instants land in ``trace.jsonl`` and
``trace_chrome.json`` there, which ``scripts/check_trace.py`` validates.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np

from repro_torch import device as _device
from repro_torch.kernels.policy import IMPLS, KernelPolicy
from repro_torch.obs import trace as obs
from repro_torch.serve import (FactorBundle, QueryResult, ServeConfig,
                               ServeEngine, parse_queries_tsv,
                               random_queries)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--factors", required=True, metavar="BUNDLE",
                    help="FactorBundle directory (rescalk_run --bundle)")
    ap.add_argument("--queries", default="random:256",
                    help="random:COUNT[:SKEW] or a queries .tsv "
                         "(default random:256)")
    ap.add_argument("--batch", type=int, default=32,
                    help="rows of every scoring call")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--mode", default="mixed",
                    choices=("sro", "sor", "mixed"),
                    help="force query direction (random streams; mixed "
                         "draws both)")
    ap.add_argument("--requests", type=int, default=16,
                    help="split the query stream into this many requests "
                         "(per-request latency percentiles)")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="score_topk dispatch (kernels/ops.py; auto: the "
                         "CUDA kernel on the card, the plain version on "
                         "the CPU)")
    ap.add_argument("--cache", type=int, default=4096,
                    help="hot-head LRU entries (0 disables)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="per-request wall-clock budget; chunks past it "
                         "are shed with the (-inf, -1) sentinel")
    ap.add_argument("--admit", type=int, default=None, metavar="N",
                    help="max uncached keys scored per request; the rest "
                         "are shed (bounded admission)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--show", type=int, default=3,
                    help="print the top-k for this many queries")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write serve trace artifacts to DIR "
                         "(scripts/check_trace.py validates)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


class ServeRun(NamedTuple):
    """What one run of the CLI served."""
    results: list[QueryResult]
    stats: dict               # ServeEngine.stats()
    latencies: np.ndarray     # seconds per request
    seconds: float            # wall time of all requests


def load_queries(args, bundle):
    if args.queries.startswith("random:"):
        parts = args.queries.split(":")
        count = int(parts[1])
        skew = float(parts[2]) if len(parts) > 2 else 1.1
        return random_queries(bundle.n, bundle.m, count, skew=skew,
                              seed=args.seed, mode=args.mode)
    queries = parse_queries_tsv(args.queries, entities=bundle.entities,
                                relations=bundle.relations)
    if args.mode != "mixed":
        queries = [q._replace(mode=args.mode) for q in queries]
    return queries


def run(args) -> ServeRun:
    """Load the bundle, serve the query stream and print; returns the
    results, the engine's stats and the latencies."""
    dev = _device.resolve(args.device)
    bundle = FactorBundle.load(args.factors)
    src = bundle.meta.get("k_opt")
    print(f"[serve] bundle {args.factors}: n={bundle.n} m={bundle.m} "
          f"k={bundle.k}" + (f" (k_opt={src})" if src is not None else ""))
    engine = ServeEngine(bundle, ServeConfig(
        topk=args.topk, batch=args.batch, cache_entries=args.cache,
        kernel=KernelPolicy(impl=args.impl),
        deadline=args.deadline, admit=args.admit), device=dev)

    queries = load_queries(args, bundle)
    n_req = max(1, min(args.requests, len(queries)))
    per_req = -(-len(queries) // n_req)

    latencies, results = [], []
    t_all = time.perf_counter()
    for c0 in range(0, len(queries), per_req):
        req = queries[c0:c0 + per_req]
        t0 = time.perf_counter()
        results.extend(engine.query(req))
        latencies.append(time.perf_counter() - t0)
    t_all = time.perf_counter() - t_all

    for q, r in list(zip(queries, results))[:max(args.show, 0)]:
        names = bundle.entities
        tops = ", ".join(
            (names[i] if names and 0 <= i < len(names) else str(i))
            + f":{s:.3f}"
            for s, i in zip(r.scores[:5], r.indices[:5]) if i >= 0)
        print(f"  {q.mode}(anchor={q.anchor}, rel={q.rel}) -> {tops}")

    lat = np.asarray(latencies)
    st = engine.stats()
    print(f"[serve] {len(queries)} queries in {len(lat)} requests: "
          f"p50 {np.percentile(lat, 50) * 1e3:.2f} ms, "
          f"p99 {np.percentile(lat, 99) * 1e3:.2f} ms, "
          f"{len(queries) / t_all:.0f} q/s")
    print(f"[serve] cache: {st['hits']} hits / {st['misses']} misses "
          f"({st['evictions']} evicted), {st['batches']} device batches"
          + (f", {st['sheds']} shed" if st["sheds"] else ""))
    return ServeRun(results=results, stats=st, latencies=lat,
                    seconds=t_all)


def run_traced(args) -> ServeRun:
    """``run`` with a tracer installed; its artifacts are written even
    when the run fails."""
    os.makedirs(args.trace, exist_ok=True)
    tracer = obs.Tracer(args.trace, meta={"argv": vars(args)})
    prev = obs.install(tracer)
    try:
        return run(args)
    finally:
        tracer.export_chrome(os.path.join(args.trace, "trace_chrome.json"))
        obs.install(prev)
        tracer.close()
        print(f"[obs] serve trace artifacts in {args.trace}")


def main(argv=None) -> ServeRun:
    _device.strict_fp32()
    args = build_parser().parse_args(argv)
    return run(args) if args.trace is None else run_traced(args)


if __name__ == "__main__":
    main()
