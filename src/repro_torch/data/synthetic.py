"""Synthetic relational tensors, the paper's §6.2.1 generator and its
§6.2.2 Trade-style tensor (port of ``repro/data/synthetic.py``).

Ground-truth latent communities are Gaussian bumps over the entity axis;
the core tensor R is Exponential(1); uniform multiplicative noise of
+-``noise`` is applied elementwise.  The draws come from a
``torch.Generator`` on the caller's device, so a full-size X is built on
the card without passing through the host.  ``jax.random`` and torch
give different numbers from one seed: the tensors follow ``repro``'s
recipe, not its bits.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device


def gaussian_features(n: int, k: int, *, generator: torch.Generator,
                      width: float = 0.06, correlated: bool = False,
                      floor: float = 0.01) -> torch.Tensor:
    """(n, k) non-negative feature matrix of Gaussian bumps, on the
    generator's device."""
    dev = generator.device
    if correlated:
        # overlapping centers in the middle half -> highly correlated cols
        centers = 0.25 + 0.5 * torch.rand(k, generator=generator, device=dev)
    else:
        centers = ((torch.arange(k, device=dev) + 0.5) / k
                   + 0.1 / k * torch.randn(k, generator=generator,
                                           device=dev))
    widths = width * (0.5 + torch.rand(k, generator=generator, device=dev))
    t = torch.linspace(0.0, 1.0, n, device=dev)[:, None]
    A = torch.exp(-0.5 * ((t - centers[None, :]) / widths[None, :]) ** 2)
    return A + floor


def synthetic_rescal(n: int, m: int, k: int, *, seed: int = 0,
                     noise: float = 0.01, correlated: bool = False,
                     device=None, dtype: torch.dtype = torch.float32):
    """(X (m, n, n), A_true (n, k), R_true (m, k, k)) on ``device``
    (default ``cuda``) with X = A R A^T elementwise-perturbed by
    Uniform[1 - noise, 1 + noise].  Built slice by slice, so the peak is
    X plus one (n, n) noise slice."""
    dev = _device.resolve(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    A = gaussian_features(n, k, generator=g, correlated=correlated).to(dtype)
    R = torch.empty((m, k, k), dtype=dtype, device=dev).exponential_(
        1.0, generator=g)
    X = torch.empty((m, n, n), dtype=dtype, device=dev)
    delta = torch.empty((n, n), dtype=dtype, device=dev)
    for t in range(m):
        torch.matmul(A @ R[t], A.T, out=X[t])
        X[t].mul_(delta.uniform_(1.0 - noise, 1.0 + noise, generator=g))
    return X, A, R


def trade_like(n: int = 24, m: int = 60, k: int = 5, *, seed: int = 0,
               device=None, dtype: torch.dtype = torch.float32):
    """A Trade-dataset-style tensor (paper §6.2.2's structure; port of
    ``repro/data/synthetic.py:46``): k economic blocs (Gaussian bumps of
    width 0.08) whose pairwise flows, base ~ Exp(1) (k, k), grow by
    linspace(0.2, 1.0, m) over the m time slices, with multiplicative
    noise Uniform[0.98, 1.02].  Returns (X (m, n, n), A (n, k), R (m, k,
    k)) on ``device`` (default ``cuda``)."""
    dev = _device.resolve(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    A = gaussian_features(n, k, generator=g, width=0.08).to(dtype)
    base = torch.empty((k, k), dtype=dtype, device=dev).exponential_(
        1.0, generator=g)
    growth = torch.linspace(0.2, 1.0, m, dtype=dtype, device=dev)
    R = base[None] * growth[:, None, None]                  # trade grows
    X = torch.einsum("ia,mab,jb->mij", A, R, A)
    delta = torch.empty_like(X).uniform_(0.98, 1.02, generator=g)
    return X * delta, A, R
