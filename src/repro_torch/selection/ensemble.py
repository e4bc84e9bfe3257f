"""Batched perturbation ensembles (port of
``repro/selection/ensemble.py:202,421,823``): a BCSR operand on one device
(batched mode), and a dense operand on the 2D process grid (the mesh
program ``make_mesh_ensemble``).

``repro`` vmaps the member pipeline (perturb -> init -> MU -> normalize ->
rel_error) over the r members of a work unit.  Here the member axis is
written out: the perturbed data is one (r, m, nnzb, bs, bs) tensor and the
factors are (r, n, k) and (r, m, k, k), so each MU iteration is one
kernel launch for all r members (the kernels index the factors by member).

The r perturbed copies stay resident for the unit's MU loop: r times the
stored blocks (or this cell's dense block) on the device, on top of the
unperturbed tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rescal import (EPS_DEFAULT, RescalState, init_factors,
                                     normalize)
from repro_torch.core.sparse import BCSR, sparse_mu_step, sparse_rel_error
from repro_torch.dist.engine import (DistRescalConfig, get_mu_iter,
                                     local_normalize, local_rel_error)
from repro_torch.dist.sharding import Grid

from .draws import DrawSource


class EnsembleResult(NamedTuple):
    """Factors and errors for the members of one work unit."""
    A: torch.Tensor        # (r, n, k)
    R: torch.Tensor        # (r, m, k, k)
    errors: torch.Tensor   # (r,) rel. error vs the UNperturbed X


def run_ensemble(sp: BCSR, k: int, cfg, draws: DrawSource
                 ) -> EnsembleResult:
    """Run the cfg.n_perturbations members of candidate rank k on ``sp``
    (on its device).  ``cfg`` is a ``RescalkConfig``."""
    if sp.batch_shape:
        raise ValueError("run_ensemble takes the unperturbed tensor")
    r = cfg.n_perturbations
    policy = cfg.kernel
    data = torch.empty((r,) + tuple(sp.data.shape), dtype=sp.data.dtype,
                       device=sp.device)
    A0, R0 = [], []
    for q in range(r):
        noise, A_q, R_q = draws.member(k, q, sp, cfg.perturbation_delta)
        torch.mul(sp.data, noise, out=data[q])
        del noise
        st = init_factors(sp.n, sp.m, k, A=A_q, R=R_q)
        A0.append(st.A)
        R0.append(st.R)
    sp_q = sp.with_data(data)
    A, R = torch.stack(A0), torch.stack(R0)
    for _ in range(cfg.rescal_iters):
        A, R = sparse_mu_step(sp_q, A, R, EPS_DEFAULT, policy=policy)
    del sp_q, data
    st = normalize(RescalState(A=A, R=R, step=cfg.rescal_iters))
    return EnsembleResult(A=st.A, R=st.R,
                          errors=sparse_rel_error(sp, st.A, st.R,
                                                  policy=policy))


def run_grid_ensemble(grid: Grid, Xl: torch.Tensor, k: int, cfg,
                      draws: DrawSource) -> EnsembleResult:
    """This pod's members of candidate rank k on the dense grid: perturb
    this cell's block -> init -> MU (``dist.engine``, ``cfg.schedule``,
    ``cfg.kernel``) -> ``local_normalize`` -> ``local_rel_error`` against
    the unperturbed block.  ``Xl`` is X^(i,j) (m, n/g, n/g).  Returns the
    pod's members (``grid.pod_members``): A^(i) (r/pods, n/g, k), R and
    errors, equal on every cell of the pod but A."""
    members = grid.pod_members(cfg.n_perturbations)
    dcfg = DistRescalConfig(schedule=cfg.schedule, kernel=cfg.kernel)
    it = get_mu_iter(cfg.schedule)
    X_q = torch.empty((len(members),) + tuple(Xl.shape), dtype=Xl.dtype,
                      device=Xl.device)
    A0, R0 = [], []
    for slot, q in enumerate(members):
        A_q, R_q = draws.grid_member(k, q, grid, X_q[slot],
                                     cfg.perturbation_delta)
        X_q[slot].mul_(Xl)
        A0.append(grid.row_block(A_q))
        R0.append(R_q)
    Ai, R = torch.stack(A0), torch.stack(R0)
    for _ in range(cfg.rescal_iters):
        Ai, R = it(grid, X_q, Ai, R, dcfg)
    del X_q
    Ai, R = local_normalize(grid, Ai, R)
    return EnsembleResult(A=Ai, R=R, errors=local_rel_error(grid, Xl, Ai, R))
