"""AdamW on plain tensors (port of ``repro/optim/adamw.py``).

A tree here is a dict of tensors keyed by name (``dict(model.
named_parameters())``, or the gradients under the same names).  The
moments are fp32 whatever the parameter dtype; the update is computed in
fp32, cast to the parameter's dtype and added in that dtype, so bf16
parameters keep no fp32 master copy, as in ``repro``.  Not
``torch.optim.AdamW``: its decay is applied to the parameter before the
step and its state follows the parameter's dtype.

``update`` writes the new moments into ``state.m`` and ``state.v`` in
place and returns the same dicts in the new state: the port's
counterpart of ``repro``'s donated state, which keeps a second copy of
the moments (8 bytes per parameter) from ever existing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    m: dict            # fp32 tensors, like params
    v: dict            # fp32 tensors, like params
    count: torch.Tensor   # 0-d int32 on the host: updates taken


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: dict) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(m={n: zeros(p) for n, p in params.items()},
                          v={n: zeros(p) for n, p in params.items()},
                          count=torch.zeros((), dtype=torch.int32))

    def update(self, grads: dict, state: AdamWState, params: dict
               ) -> tuple[dict, AdamWState]:
        """(updates in each parameter's dtype, new state); the moments are
        updated in place."""
        c = int(state.count) + 1
        # the bias corrections in fp32, as repro computes b ** c
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(c))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(c))
        updates = {}
        for name, g in grads.items():
            m, v, p = state.m[name], state.v[name], params[name]
            g32 = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            updates[name] = (-self.lr * upd).to(p.dtype)
        return updates, AdamWState(m=state.m, v=state.v,
                                   count=torch.tensor(c, dtype=torch.int32))


def apply_updates(params: dict, updates: dict) -> dict:
    """p + u for every parameter, in the parameter's dtype (new
    tensors)."""
    return {n: p + updates[n] for n, p in params.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (0-d fp32)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """(tree scaled by min(1, max_norm / norm) in fp32 and cast back to
    each leaf's dtype, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {n: (x.float() * scale).to(x.dtype)
            for n, x in tree.items()}, norm
