"""repro_torch.serve — link prediction from the swept factors (port of
``repro/serve``).

  bundle.py   FactorBundle, the versioned on-disk factor artifact that
              ``rescalk_run`` writes and ``launch/serve`` loads (the same
              format as ``repro``'s, both ways)
  engine.py   ServeEngine: hot-head LRU, deduplicated micro-batches of one
              fixed width, scoring through the ``score_topk`` CUDA kernel
"""
from .bundle import FORMAT_VERSION, BundleError, FactorBundle
from .engine import (MODES, Query, QueryResult, ServeConfig, ServeEngine,
                     parse_queries_tsv, random_queries)

__all__ = ["BundleError", "FORMAT_VERSION", "FactorBundle", "MODES",
           "Query", "QueryResult", "ServeConfig", "ServeEngine",
           "parse_queries_tsv", "random_queries"]
