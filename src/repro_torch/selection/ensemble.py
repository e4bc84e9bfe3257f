"""Batched perturbation ensembles on a BCSR operand (port of
``repro/selection/ensemble.py:202,823``, batched mode).

``repro`` vmaps the member pipeline (perturb -> init -> MU -> normalize ->
rel_error) over the r members of a work unit.  Here the member axis is
written out: the perturbed data is one (r, m, nnzb, bs, bs) tensor and the
factors are (r, n, k) and (r, m, k, k), so each MU iteration is one
kernel launch for all r members (the kernels index the factors by member).

The r perturbed copies stay resident for the unit's MU loop: r times the
stored blocks on the device, on top of the unperturbed tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rescal import (EPS_DEFAULT, RescalState, init_factors,
                                     normalize)
from repro_torch.core.sparse import BCSR, sparse_mu_step, sparse_rel_error

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
