"""Draw sources: where an ensemble's random numbers come from.

``repro`` derives every draw from ``jax.random`` keys (``ensemble.unit_keys``
-> ``split(member_key)`` into (pkey, fkey) -> the perturbation noise and
``init_factors``' (ka, kr) draws; the regression's init from
``PRNGKey(17)``).  torch cannot reproduce threefry, so the port takes its
draws from a source:

  * ``TorchDraws(seed, device)`` — the port's own: one ``torch.Generator``
    per (seed, k, q), so two runs with the same config draw the same
    numbers (on the same device type).
  * ``ArrayDraws`` — serves arrays drawn elsewhere; the parity tests fill
    it with ``repro``'s own draws, so both packages compute on the same
    numbers.

Per member (k, q) a source gives the multiplicative noise for the stored
blocks (uniform in [1 - delta, 1 + delta], the data's shape) and the
initial factors A0 (n, k) and R0 (m, k, k) (uniform in [0.05, 1)); per
rank k it gives the regression's initial R0 (m, k, k).

On the dense grid (``grid_member``, the counterpart of ``repro``'s
``perturb_shard``, ``core/perturb.py:24``) the noise of a member's local
block X^(i,j) depends on (seed, k, q, the cell's linear grid index), so
every cell draws its own; the initial A (n, k) and R are drawn globally
from (seed, k, q), equal on every cell, and the caller slices A to its
rows, as ``repro``'s ``make_mesh_ensemble`` does.
"""
from __future__ import annotations

from typing import Mapping, Protocol

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import init_factors
from repro_torch.core.sparse import BCSR

_REGRESS_WORD = 17   # repro's fixed regression key, PRNGKey(17)


class DrawSource(Protocol):
    def member(self, k: int, q: int, sp: BCSR, delta: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(noise, A0, R0) of member q at rank k."""

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        """Initial R (m, k, k) of rank k's regression."""

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Write member q's noise for this cell's block into ``out``
        (m, n/g, n/g) and return its global (A0 (n, k), R0 (m, k, k))."""


class TorchDraws:
    """Seeded torch draws, one generator per (seed, k, q)."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = _device.resolve(device)

    def _generator(self, *words: int) -> torch.Generator:
        state = np.random.SeedSequence(list(words)).generate_state(
            1, np.uint64)[0]
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state >> np.uint64(1)))
        return g

    def member(self, k: int, q: int, sp: BCSR, delta: float):
        g = self._generator(self.seed, k, q)
        noise = torch.empty(sp.data.shape, dtype=sp.data.dtype,
                            device=self.device)
        noise.uniform_(1.0 - delta, 1.0 + delta, generator=g)
        st = init_factors(sp.n, sp.m, k, generator=g, dtype=sp.data.dtype)
        return noise, st.A, st.R

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        g = self._generator(_REGRESS_WORD, k)
        R0 = torch.empty((m, k, k), dtype=torch.float32, device=self.device)
        return R0.uniform_(0.05, 1.0, generator=g)

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float):
        out.uniform_(1.0 - delta, 1.0 + delta,
                     generator=self._generator(self.seed, k, q,
                                               grid.linear_index))
        m, nr, _ = out.shape
        st = init_factors(nr * grid.rows, m, k,
                          generator=self._generator(self.seed, k, q),
                          dtype=out.dtype)
        return st.A, st.R


class ArrayDraws:
    """Draws handed in as arrays: ``members[(k, q)] = (noise, A0, R0)`` and
    ``regress[k] = R0``, numpy or torch, moved to ``device`` when used."""

    def __init__(self, members: Mapping, regress: Mapping, device=None):
        self.members = dict(members)
        self.regress = dict(regress)
        self.device = _device.resolve(device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32),
                               device=self.device)

    def member(self, k: int, q: int, sp: BCSR, delta: float):
        if (k, q) not in self.members:
            raise KeyError(f"no draws for member (k={k}, q={q})")
        noise, A0, R0 = (self._tensor(x) for x in self.members[(k, q)])
        if noise.shape != sp.data.shape:
            raise ValueError(f"noise {tuple(noise.shape)} does not match "
                             f"the data {tuple(sp.data.shape)}")
        return noise, A0, R0

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        return self._tensor(self.regress[k])

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float):
        """``members[(k, q)]`` holds the global blocked noise (m, n, n) —
        ``repro``'s ``perturb_shard`` draws, block by block — and A0, R0;
        this cell's block of the noise is copied into ``out``."""
        if (k, q) not in self.members:
            raise KeyError(f"no draws for member (k={k}, q={q})")
        noise, A0, R0 = self.members[(k, q)]
        block = grid.x_block(torch.as_tensor(np.asarray(noise, np.float32)))
        if tuple(block.shape) != tuple(out.shape):
            raise ValueError(f"noise block {tuple(block.shape)} does not "
                             f"match the local block {tuple(out.shape)}")
        out.copy_(block)
        return self._tensor(A0), self._tensor(R0)
