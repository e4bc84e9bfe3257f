"""Data generators of the port (``repro/data``): the synthetic relational
tensors and the LM token stream."""
from .synthetic import gaussian_features, synthetic_rescal, trade_like
from .tokens import TokenStreamConfig, batch_at, shard_batch_at, stream

__all__ = ["TokenStreamConfig", "batch_at", "gaussian_features",
           "shard_batch_at", "stream", "synthetic_rescal", "trade_like"]
