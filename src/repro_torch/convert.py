"""Build the port's objects from ``repro``'s arrays (as numpy).

The parity tests compute with both packages on the same operand and the
same factors; these helpers take what ``repro`` holds — a BCSR's
``data``/``block_rows``/``block_cols``/``n``, a ``RescalState``'s
``A``/``R``, a ``KResult`` — as numpy arrays or anything ``np.asarray``
accepts (a JAX array included), and build the port's counterpart on a
torch device.  Nothing here imports ``repro`` or ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import RescalState
from repro_torch.core.sparse import BCSR
from repro_torch.selection.types import KResult


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


def k_result(res) -> KResult:
    """A KResult with numpy fields from ``repro``'s."""
    return KResult(k=int(res.k), s_min=float(res.s_min),
                   s_mean=float(res.s_mean), rel_err=float(res.rel_err),
                   A_median=np.asarray(res.A_median),
                   R_regress=np.asarray(res.R_regress),
                   member_errors=np.asarray(res.member_errors))


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) as numpy, for comparison with ``repro``."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
