"""The plain reference against the port's plain CPU path at a small size:
one MU iteration (dense batched, BCSR sliced) and one small sweep's
per-k values and selected k."""
import numpy as np
import pytest
import torch

from portbench.harness import inputs
from portbench.reference import mu as ref_mu
from portbench.reference import sweep as ref_sweep


@pytest.fixture
def grid():
    from repro_torch.launch.mesh import make_grid
    g = make_grid(data=1, model=1, device="cpu")
    yield g
    g.destroy()


def close(a, b, tol=1e-5):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max()) <= tol


def test_dense_batched_iteration():
    from repro_torch.core.rescal import RescalState, mu_step_batched
    X = inputs.dense_block(5, 4, 48, "cpu")
    A, R = inputs.uniform_factors(5, 48, 4, 5, "cpu")
    got = mu_step_batched(X, RescalState(A=A, R=R, step=0))
    want = ref_mu.mu_iteration(ref_mu.Dense(X), A, R)
    assert close(got.A, want[0]) and close(got.R, want[1])


def test_bcsr_sliced_iteration(grid):
    from repro_torch.core.sparse import BCSR
    from repro_torch.dist.engine import DistRescalConfig, make_mu_step
    p = inputs.bcsr_shard(7, 3, 6, 14, 8, "cpu")
    sp = BCSR(data=p.data, block_rows=p.rows, block_cols=p.cols, n=p.n)
    A, R = inputs.uniform_factors(7, p.n, 3, 5, "cpu")
    step = make_mu_step(grid, DistRescalConfig(schedule="sliced"))
    got = step(sp, A, R)
    want = ref_mu.mu_iteration(ref_mu.Blocks(p.data, p.rows, p.cols, p.nb),
                               A, R)
    assert close(got[0], want[0]) and close(got[1], want[1])


def test_blocks_equal_their_dense_tensor():
    p = inputs.bcsr_shard(9, 2, 5, 9, 4, "cpu")
    X = torch.zeros(2, 5, 5, 4, 4)
    X[:, p.rows.long(), p.cols.long()] = p.data
    X = X.transpose(2, 3).reshape(2, 20, 20)
    A, R = inputs.uniform_factors(9, 20, 2, 3, "cpu")
    a = ref_mu.mu_iteration(ref_mu.Blocks(p.data, p.rows, p.cols, p.nb),
                            A, R)
    b = ref_mu.mu_iteration(ref_mu.Dense(X), A, R)
    assert close(a[0], b[0]) and close(a[1], b[1])


def test_small_sweep(grid):
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.selection.scheduler import SweepScheduler
    from repro_torch.selection.types import RescalkConfig
    seed, ks = 3, [2, 3, 4]
    X = inputs.planted(seed, 3, 40, 3, 0.1, 0.05, "cpu")
    draws = inputs.SeedDraws(seed, "cpu")
    cfg = RescalkConfig(k_min=2, k_max=4, n_perturbations=4,
                        perturbation_delta=0.02, rescal_iters=30,
                        regress_iters=40, seed=seed,
                        kernel=KernelPolicy(use_fused=True))
    got = SweepScheduler(cfg, mode="batched", draws=draws,
                         grid=grid).run(X)
    per_k, k_opt = ref_sweep.sweep(X, ks, members=4, iters=30,
                                   regress_iters=40, delta=0.02,
                                   draws=draws, sil_threshold=0.75)
    assert got.k_opt == k_opt
    for i, k in enumerate(ks):
        r = per_k[k]
        assert abs(got.s_min[i] - r.s_min) < 1e-5
        assert abs(got.s_mean[i] - r.s_mean) < 1e-5
        assert abs(got.rel_err[i] - r.rel_err) < 1e-5 * r.rel_err
        assert close(got.per_k[k].A_median, r.A_median)
        np.testing.assert_allclose(got.per_k[k].member_errors,
                                   r.member_errors, rtol=1e-5)
