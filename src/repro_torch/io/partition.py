"""COO to one global BCSR tensor (port of ``repro/io/partition.py:48``,
``coo_to_bcsr`` only; the balanced sharding comes with the mesh), traced
as an ``ingest/blockify`` span."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.sparse import BCSR, cdiv
from repro_torch.obs import trace as obs

from .triples import COOTensor


def coo_to_bcsr(coo: COOTensor, bs: int = 128, *, device=None) -> BCSR:
    """COO -> one BCSR in the original entity order, built on ``device``
    (default ``cuda``).  Blocks are row-major sorted; the pattern is the
    union over relation slices.  The block pattern is found on the host;
    the values are scattered into the (m, nnzb, bs, bs) data on the
    device, so the host never holds the stored blocks.  Memory is
    O(nnzb * bs^2), never O(n^2)."""
    dev = _device.resolve(device)
    with obs.span("ingest/blockify", n=coo.n, bs=bs):
        nb = cdiv(coo.n, bs)
        brow = coo.rows // bs
        bcol = coo.cols // bs
        ukeys, z = np.unique(brow * nb + bcol, return_inverse=True)
        nnzb = ukeys.shape[0]
        data = torch.zeros((coo.m, nnzb, bs, bs), dtype=torch.float32,
                           device=dev)
        flat = (((coo.rels * nnzb + z) * bs + coo.rows % bs) * bs
                + coo.cols % bs)
        data.view(-1).index_put_((torch.from_numpy(flat).to(dev),),
                                 torch.from_numpy(coo.vals).to(dev),
                                 accumulate=True)
        return BCSR(data=data,
                    block_rows=torch.from_numpy(
                        (ukeys // nb).astype(np.int32)).to(dev),
                    block_cols=torch.from_numpy(
                        (ukeys % nb).astype(np.int32)).to(dev), n=coo.n)
