"""Build the port's objects from ``repro``'s arrays (as numpy).

The parity tests compute with both packages on the same operand and the
same factors; these helpers take what ``repro`` holds, as numpy arrays or
anything ``np.asarray`` accepts (a JAX array included), and build the
port's counterpart on a torch device (a bundle stays numpy).  What they
carry across:

  * a BCSR's ``data``/``block_rows``/``block_cols``/``n`` (``bcsr``);
  * a dense X, ``RescalState`` factors A and R (``tensor``,
    ``rescal_state``);
  * one grid cell's share of the global dense X, A and R and of the
    blocked perturbation noise, as ``repro``'s mesh shards them
    (``grid_blocks``);
  * a ``KResult`` (``k_result``) and a ``FactorBundle``
    (``factor_bundle``).

Nothing here imports ``repro`` or ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import RescalState
from repro_torch.core.sparse import BCSR
from repro_torch.dist.sharding import Grid
from repro_torch.selection.types import KResult
from repro_torch.serve.bundle import FactorBundle


def tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """An array (numpy, JAX, list) as a tensor on ``device``."""
    return torch.as_tensor(np.array(x), dtype=dtype,
                           device=_device.resolve(device))


def bcsr(sp_like, device=None) -> BCSR:
    """A BCSR from ``repro``'s: an object with ``data``, ``block_rows``,
    ``block_cols`` and ``n``."""
    return BCSR(data=tensor(sp_like.data, device),
                block_rows=tensor(sp_like.block_rows, device, torch.int32),
                block_cols=tensor(sp_like.block_cols, device, torch.int32),
                n=int(sp_like.n))


def rescal_state(A, R, *, step: int = 0, device=None) -> RescalState:
    """A RescalState from ``repro``'s factors A (n, k) and R (m, k, k)."""
    return RescalState(A=tensor(A, device), R=tensor(R, device), step=step)


def grid_blocks(grid: Grid, *, X=None, A=None, R=None, noise=None,
                device=None) -> dict[str, torch.Tensor]:
    """This cell's blocks of global arrays, as ``repro``'s mesh holds
    them: X (m, n, n) -> X^(i,j); A (..., n, k) -> row block A^(i); R
    replicated; the blocked noise (..., m, n, n) of ``repro``'s
    ``perturb_blocked`` -> its (i, j) block.  ``grid`` needs no process
    groups (``Grid.at_rank`` builds one for any rank).  Only the arrays
    given are returned."""
    out = {}
    for name, x in (("X", X), ("noise", noise)):
        if x is not None:
            out[name] = grid.x_block(tensor(x, device)).contiguous()
    if A is not None:
        out["A"] = grid.row_block(tensor(A, device)).contiguous()
    if R is not None:
        out["R"] = tensor(R, device)
    return out


def k_result(res) -> KResult:
    """A KResult with numpy fields from ``repro``'s."""
    return KResult(k=int(res.k), s_min=float(res.s_min),
                   s_mean=float(res.s_mean), rel_err=float(res.rel_err),
                   A_median=np.asarray(res.A_median),
                   R_regress=np.asarray(res.R_regress),
                   member_errors=np.asarray(res.member_errors))


def factor_bundle(bundle) -> FactorBundle:
    """The port's FactorBundle from ``repro``'s (numpy arrays, the same
    vocab, manifest and meta)."""
    perm = bundle.permutation
    return FactorBundle(A=np.asarray(bundle.A), R=np.asarray(bundle.R),
                        entities=bundle.entities, relations=bundle.relations,
                        permutation=None if perm is None else np.asarray(perm),
                        manifest=bundle.manifest, meta=dict(bundle.meta))


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) as numpy, for comparison with ``repro``."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
