"""The inputs of a cell, made from ``--seed`` on the run's device: the
operand (a dense block or a BCSR shard, or a planted dense tensor), the
initial factors, and the ensemble's draws.  The program and the
reference are handed the same inputs; the reference makes nothing of
the program's.

Every stream is a ``torch.Generator`` on the device, seeded from the
run's seed and a fixed word per purpose, so one seed gives the same
inputs in every run, and the large tensors are made in a few calls.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# one word per stream, folded with the seed
OPERAND, FACTORS, PATTERN, PLANTED, MEMBER, REGRESS = range(6)


def generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from the words (any non-negative
    integers, the seed among them) through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def uniform(shape, gen: torch.Generator, lo: float = 0.0, hi: float = 1.0
            ) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return out.uniform_(lo, hi, generator=gen)


def uniform_factors(seed: int, n: int, m: int, k: int, device):
    """The initial A (n, k) and R (m, k, k), uniform in [0, 1)."""
    g = generator(device, seed, FACTORS)
    return uniform((n, k), g), uniform((m, k, k), g)


def dense_block(seed: int, m: int, n: int, device) -> torch.Tensor:
    """A dense block (m, n, n), uniform in [0, 1), in one call."""
    return uniform((m, n, n), generator(device, seed, OPERAND))


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A BCSR shard's block coordinates and values, as the harness made
    them: ``rows``/``cols`` int32 (nnzb,) row-major and distinct,
    ``data`` (m, nnzb, bs, bs), over n = nb * bs entities."""
    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    nb: int

    @property
    def n(self) -> int:
        return self.nb * self.data.shape[-1]


def bcsr_shard(seed: int, m: int, nb: int, nnzb: int, bs: int, device,
               pattern_seed: int | None = None) -> Pattern:
    """nnzb distinct block positions uniform over (nb, nb), row-major,
    from ``pattern_seed`` (by default the seed), and their values uniform
    in [0, 1) (m slices) from the seed."""
    if nnzb > nb * nb:
        raise ValueError(f"{nnzb} blocks do not fit a {nb} x {nb} pattern")
    rng = np.random.default_rng(
        [int(seed if pattern_seed is None else pattern_seed), PATTERN])
    flat = np.unique(rng.integers(0, nb * nb, size=2 * nnzb + 16,
                                  dtype=np.int64))
    while flat.size < nnzb:           # only for small, dense patterns
        more = rng.integers(0, nb * nb, size=nnzb, dtype=np.int64)
        flat = np.unique(np.concatenate([flat, more]))
    flat = np.sort(rng.choice(flat, size=nnzb, replace=False))
    rows = torch.from_numpy((flat // nb).astype(np.int32)).to(device)
    cols = torch.from_numpy((flat % nb).astype(np.int32)).to(device)
    data = uniform((m, nnzb, bs, bs), generator(device, seed, OPERAND))
    return Pattern(rows=rows, cols=cols, data=data, nb=nb)


def planted(seed: int, m: int, n: int, k_true: int, background: float,
            noise: float, device) -> torch.Tensor:
    """A planted non-negative tensor (m, n, n): X_t = A R_t A^T + noise
    * U, with A's rows in k_true equal groups (1 on the row's group,
    ``background`` * uniform elsewhere), R_t uniform in [0, 1) and U
    uniform in [0, 1).  Built slice by slice into one buffer."""
    g = generator(device, seed, PLANTED)
    A = uniform((n, k_true), g, 0.0, background)
    group = torch.arange(n, device=device) * k_true // n
    A[torch.arange(n, device=device), group] = 1.0
    R = uniform((m, k_true, k_true), g)
    X = uniform((m, n, n), g, 0.0, noise)
    for t in range(m):
        X[t].addmm_(A @ R[t], A.T)
    return X


class SeedDraws:
    """The ensemble's draws from the seed, served to the port's sweep on a
    1 x 1 grid through its ``DrawSource`` interface (``grid_member``,
    ``regress_R0``): member q at rank k gets its noise, uniform in
    [1 - delta, 1 + delta], and its initial A (n, k) and R (m, k, k),
    uniform in [0.05, 1); rank k's regression gets its initial R.  The
    reference draws from the same object."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def noise_into(self, k: int, q: int, out: torch.Tensor,
                   delta: float) -> torch.Tensor:
        g = generator(self.device, self.seed, MEMBER, k, q)
        return out.uniform_(1.0 - delta, 1.0 + delta, generator=g)

    def init(self, k: int, q: int, n: int, m: int):
        g = generator(self.device, self.seed, FACTORS, k, q)
        return uniform((n, k), g, 0.05, 1.0), uniform((m, k, k), g, 0.05,
                                                      1.0)

    # -- the port's DrawSource interface (the grid sweep's part) ----------

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        g = generator(self.device, self.seed, REGRESS, k)
        return uniform((m, k, k), g, 0.05, 1.0)

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float, n: int | None = None):
        if grid.rows != 1 or grid.cols != 1:
            raise ValueError("these draws serve a 1 x 1 grid")
        self.noise_into(k, q, out, delta)
        return self.init(k, q, out.shape[-1] if n is None else n,
                         out.shape[-3])
