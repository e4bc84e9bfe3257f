"""Deterministic synthetic token stream for LM training (port of
``repro/data/tokens.py``).

Every batch is a pure function of (seed, step): it is drawn from a
``torch.Generator`` seeded from both, on the host, so a restarted loop
regenerates exactly the batch it would have seen, on any device.  Tokens
follow a Zipf(a) marginal over the vocab (``torch.multinomial`` over
``repro``'s logits -a log(rank)), and every second position repeats its
predecessor + 1 mod V, so the loss has signal to descend.  ``jax.random``
and torch give different draws from one seed: the stream follows
``repro``'s recipe, not its bits (parity tests feed ``repro``'s batches
to both packages).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    batch: int          # global batch
    seq: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_logits(vocab: int, a: float) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return -a * torch.log(ranks)


def batch_at(cfg: TokenStreamConfig, step: int) -> dict[str, torch.Tensor]:
    """{"tokens", "labels"}, each (batch, seq) int64 on the host, for
    ``step``: a pure function of (cfg, step)."""
    gen = _device.seeded_generator(cfg.seed, step)
    probs = torch.softmax(_zipf_logits(cfg.vocab, cfg.zipf_a), dim=0)
    draw = torch.multinomial(probs, cfg.batch * (cfg.seq + 1),
                             replacement=True, generator=gen)
    draw = draw.view(cfg.batch, cfg.seq + 1)
    # light Markov structure: every 2nd token repeats its predecessor + 1
    rep = torch.roll(draw, 1, dims=1)
    odd = (torch.arange(cfg.seq + 1) % 2).bool()
    seq = torch.where(odd[None, :], (rep + 1) % cfg.vocab, draw)
    return {"tokens": seq[:, :-1].contiguous(),
            "labels": seq[:, 1:].contiguous()}


def stream(cfg: TokenStreamConfig, start_step: int = 0
           ) -> Iterator[dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


def shard_batch_at(cfg: TokenStreamConfig, step: int, shard: int,
                   n_shards: int) -> dict[str, torch.Tensor]:
    """Shard ``shard`` of ``n_shards``: its rows of the global
    ``batch_at``, so the content does not depend on the placement."""
    full = batch_at(cfg, step)
    per = cfg.batch // n_shards
    return {k: v[shard * per:(shard + 1) * per] for k, v in full.items()}
