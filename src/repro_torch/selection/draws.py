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

Per member (k, q) a source gives the multiplicative noise for the values
the member perturbs (uniform in [1 - delta, 1 + delta]): the stored
blocks of a BCSR operand, or the whole (m, n, n) of a dense one
(``repro``'s ``core/perturb.py:17``), written into a caller's buffer
when one is given; and the initial factors A0 (n, k) and R0 (m, k, k)
(uniform in [0.05, 1)).  Per rank k it gives the regression's initial R0
(m, k, k).

``TorchDraws`` draws a member's noise from (seed, k, q, cell) and its
initial factors from (seed, k, q); a single-device member is cell 0, so
the single-device sweep and the 1 x 1 grid sweep compute on the same
numbers, dense or BCSR.

On the grid (``grid_member``, the counterpart of ``repro``'s
``perturb_shard``, ``core/perturb.py:24``) the noise of a member's local
block X^(i,j), or of its BCSR shard's stored blocks, depends on (seed, k,
q, the cell's linear grid index), so every cell draws its own (a shard's
zero padding blocks stay zero under any noise); the initial A (n, k) and
R are drawn globally from (seed, k, q) — at n_pad for a sharded operand
— equal on every cell, and the caller slices A to its rows, as
``repro``'s ``make_mesh_ensemble`` and ``make_mesh_ensemble_bcsr`` do.
"""
from __future__ import annotations

from typing import Mapping, Protocol

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import init_factors
from repro_torch.core.sparse import BCSR

_REGRESS_WORD = 17   # repro's fixed regression key, PRNGKey(17)


def perturbed_values(operand) -> torch.Tensor:
    """The values a member perturbs: a BCSR's stored blocks, or the whole
    dense X."""
    return operand.data if isinstance(operand, BCSR) else operand


class DrawSource(Protocol):
    def member(self, k: int, q: int, operand, delta: float,
               out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(noise, A0, R0) of member q at rank k on ``operand`` (a BCSR or
        a dense (m, n, n) tensor); the noise has the shape of
        ``perturbed_values(operand)`` and is written into ``out`` when
        given."""

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        """Initial R (m, k, k) of rank k's regression."""

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float, n: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Write member q's noise for this cell's values into ``out`` — a
        dense block (m, n/g, n/g), or a BCSR shard's stored blocks (m,
        z_max, bs, bs) — and return its global (A0 (n, k), R0 (m, k,
        k)); ``n`` is the global entity count (n_pad of a sharded
        operand), by default the dense block's side times the grid's."""


class TorchDraws:
    """Seeded torch draws, one generator per (seed, k, q[, cell])."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = _device.resolve(device)

    def _generator(self, *words: int) -> torch.Generator:
        return _device.seeded_generator(*words, device=self.device)

    def member(self, k: int, q: int, operand, delta: float,
               out: torch.Tensor | None = None):
        vals = perturbed_values(operand)
        noise = out if out is not None else torch.empty(
            vals.shape, dtype=vals.dtype, device=self.device)
        n = operand.n if isinstance(operand, BCSR) else operand.shape[-1]
        return (noise,) + self._draw(k, q, 0, noise, n, delta)

    def _draw(self, k: int, q: int, cell: int, out: torch.Tensor, n: int,
              delta: float):
        """A member's draws: the noise of grid cell ``cell`` into ``out``
        from (seed, k, q, cell), and the global A0 (n, k), R0 (m, k, k)
        from (seed, k, q)."""
        out.uniform_(1.0 - delta, 1.0 + delta,
                     generator=self._generator(self.seed, k, q, cell))
        st = init_factors(n, out.shape[-4 if out.dim() == 4 else -3], k,
                          generator=self._generator(self.seed, k, q),
                          dtype=out.dtype)
        return st.A, st.R

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        g = self._generator(_REGRESS_WORD, k)
        R0 = torch.empty((m, k, k), dtype=torch.float32, device=self.device)
        return R0.uniform_(0.05, 1.0, generator=g)

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float, n: int | None = None):
        if n is None:
            n = out.shape[-2] * grid.rows
        return self._draw(k, q, grid.linear_index, out, n, delta)


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

    def member(self, k: int, q: int, operand, delta: float,
               out: torch.Tensor | None = None):
        if (k, q) not in self.members:
            raise KeyError(f"no draws for member (k={k}, q={q})")
        noise, A0, R0 = (self._tensor(x) for x in self.members[(k, q)])
        vals = perturbed_values(operand)
        if noise.shape != vals.shape:
            raise ValueError(f"noise {tuple(noise.shape)} does not match "
                             f"the values {tuple(vals.shape)}")
        if out is not None:
            noise = out.copy_(noise)
        return noise, A0, R0

    def regress_R0(self, k: int, m: int) -> torch.Tensor:
        return self._tensor(self.regress[k])

    def grid_member(self, k: int, q: int, grid, out: torch.Tensor,
                    delta: float, n: int | None = None):
        """``members[(k, q)]`` holds the global noise and A0, R0: a dense
        operand's blocked noise (m, n, n) — ``repro``'s ``perturb_shard``
        draws, block by block — or a sharded BCSR's stacked shard noise
        (g, g, m, z_max, bs, bs) (``repro``'s ``perturb_sharded_blocked``);
        this cell's part is copied into ``out``."""
        if (k, q) not in self.members:
            raise KeyError(f"no draws for member (k={k}, q={q})")
        noise, A0, R0 = self.members[(k, q)]
        noise = torch.as_tensor(np.asarray(noise, np.float32))
        block = noise[grid.i, grid.j] if noise.dim() == 6 else \
            grid.x_block(noise)
        if tuple(block.shape) != tuple(out.shape):
            raise ValueError(f"noise block {tuple(block.shape)} does not "
                             f"match the local block {tuple(out.shape)}")
        out.copy_(block)
        return self._tensor(A0), self._tensor(R0)
