"""Build the port's objects from ``repro``'s arrays (as numpy).

The parity tests compute with both packages on the same operand and the
same factors; these helpers take what ``repro`` holds, as numpy arrays or
anything ``np.asarray`` accepts (a JAX array included), and build the
port's counterpart on a torch device (a bundle stays numpy).  What they
carry across:

  * a BCSR's ``data``/``block_rows``/``block_cols``/``n`` (``bcsr``);
  * a ``BlockPartition`` (``block_partition``) and a ``ShardedBCSR``
    with its partition (``sharded_bcsr``);
  * a dense X, ``RescalState`` factors A and R (``tensor``,
    ``rescal_state``);
  * one grid cell's share of the global dense X, A and R and of the
    blocked perturbation noise, as ``repro``'s mesh shards them
    (``grid_blocks``);
  * a ``KResult`` (``k_result``), a ``FactorBundle``
    (``factor_bundle``) and a cross-k ``GridChunk`` (``grid_chunk``);
  * the LM zoo's parameter pytree, any family, as the state dict of the
    port's ``Transformer`` (``lm_params_from_repro``), or one LM grid
    cell's blocks of it (``lm_grid_params_from_repro``).

``repro``'s dense member draws and k_max-padded states need no helper:
``selection.ArrayDraws`` takes the arrays as they are, and
``rescal_state`` takes factors of any rank.

Nothing here imports ``repro`` or ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import RescalState
from repro_torch.core.sparse import BCSR
from repro_torch.dist.sharding import Grid
from repro_torch.io.partition import BlockPartition, ShardedBCSR
from repro_torch.selection.scheduler import GridChunk
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


def block_partition(part_like) -> BlockPartition:
    """A BlockPartition from ``repro``'s (its ints and numpy arrays)."""
    return BlockPartition(
        n=int(part_like.n), bs=int(part_like.bs), grid=int(part_like.grid),
        nb=int(part_like.nb), nb_loc=int(part_like.nb_loc),
        perm=np.array(part_like.perm, np.int64),
        pos=np.array(part_like.pos, np.int64))


def sharded_bcsr(sh_like, device=None) -> ShardedBCSR:
    """A ShardedBCSR from ``repro``'s: ``part``, the stacked ``data``
    (g, g, m, z_max, bs, bs), ``rows``/``cols`` and ``nnzb``, on
    ``device``."""
    return ShardedBCSR(part=block_partition(sh_like.part),
                       data=tensor(sh_like.data, device),
                       rows=tensor(sh_like.rows, device, torch.int32),
                       cols=tensor(sh_like.cols, device, torch.int32),
                       nnzb=np.array(sh_like.nnzb, np.int64))


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


def grid_chunk(chunk) -> GridChunk:
    """A GridChunk from ``repro``'s (its index, cells and k_max)."""
    return GridChunk(index=int(chunk.index),
                     cells=tuple((int(k), int(q)) for k, q in chunk.cells),
                     k_max=int(chunk.k_max))


def lm_params_from_repro(params, cfg, device=None) -> dict[str, torch.Tensor]:
    """The state dict of ``models.transformer.Transformer(cfg)`` from
    ``repro``'s ``init_params`` pytree, any family: ``embed/table``,
    ``final_norm``, the ``layers`` stack (and enc-dec's ``enc_layers``
    stack and ``enc_norm``) split along its leading L axis.  The names
    carry over (``layers/attn/wq`` is ``layers.{i}.attn.wq``, ``mixer/
    mamba/A_log`` is ``layers.{i}.mixer.mamba.A_log``), but for the
    experts' ``wg`` and ``wi``, concatenated once into the fused
    ``moe.wgi`` (gate columns first).  Both packages keep dense weights as
    (d_in, d_out) applied as ``x @ w``, so the arrays carry over as they
    are, each in its own dtype (bf16 and fp32 leaves alike; bf16 passes
    through fp32 exactly)."""
    dev = _device.resolve(device)

    def t(x) -> torch.Tensor:
        dtype = (torch.bfloat16 if str(np.asarray(x).dtype) == "bfloat16"
                 else torch.float32)
        return torch.as_tensor(np.array(x, dtype=np.float32),
                               device=dev).to(dtype)

    def flat(tree, prefix: str) -> dict:
        out = {}
        for name, x in tree.items():
            key = f"{prefix}{name}"
            if isinstance(x, dict):
                if "router" in x:                # the experts' wg, wi
                    out[f"{key}.wgi"] = torch.cat([t(x["wg"]), t(x["wi"])],
                                                  dim=-1)
                    x = {k: v for k, v in x.items() if k not in ("wg", "wi")}
                out.update(flat(x, key + "."))
            else:
                out[key] = t(x)
        return out

    state = {"embed": t(params["embed"]["table"]),
             "final_norm": t(params["final_norm"])}
    for stack, n in (("layers", cfg.n_layers),
                     ("enc_layers", cfg.n_enc_layers)):
        if stack in params:
            for name, x in flat(params[stack], "").items():
                state.update({f"{stack}.{i}.{name}": x[i] for i in range(n)})
    if "enc_norm" in params:
        state["enc_norm"] = t(params["enc_norm"])
    return state


def lm_grid_params_from_repro(params, cfg, grid: Grid, device=None
                              ) -> dict[str, torch.Tensor]:
    """This LM grid cell's blocks of ``lm_params_from_repro``'s state dict
    (``dist.sharding.param_specs``; contiguous, on ``device``), the state
    dict of a model placed on ``grid`` (``train.serve_step.
    params_shardings``).  ``grid`` needs no process groups."""
    from repro_torch.models.transformer import lm_placement
    placement = lm_placement(grid, cfg)
    dev = _device.resolve(device)
    return {n: placement.local(n, x).to(dev).contiguous()
            for n, x in lm_params_from_repro(params, cfg, "cpu").items()}


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) as numpy, for comparison with ``repro``."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
