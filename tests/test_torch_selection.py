"""repro_torch's per-k reduction and sweep against repro's.

The sweep parity runs both packages on one planted rank-3 BCSR tensor with
the same draws: the port gets ``ArrayDraws`` filled from repro's own key
discipline (``unit_keys`` -> split into (pkey, fkey) -> the stored-block
noise and init_factors' draws; the regression's PRNGKey(17)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.core.clustering import custom_cluster as j_cluster
from repro.core.rescal import init_factors as j_init
from repro.core.silhouette import silhouettes as j_silhouettes
from repro.kernels.policy import KernelPolicy as JPolicy
from repro.selection import RescalkConfig as JConfig
from repro.selection import SweepScheduler as JScheduler
from repro.selection.ensemble import unit_keys
from repro_torch import convert
from repro_torch.core.clustering import custom_cluster, median
from repro_torch.core.silhouette import silhouettes
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.selection import (ArrayDraws, RescalkConfig, SweepScheduler,
                                   TorchDraws, plan_sweep, run_ensemble)


def ensemble(seed, r=4, n=60, m=2, k=4):
    """A noisy aligned ensemble with shuffled columns per member."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.05, 1.0, (n, k))
    A = np.stack([base * rng.uniform(0.9, 1.1, (n, k)) for _ in range(r)])
    R = rng.uniform(0.05, 1.0, (r, m, k, k))
    for q in range(1, r):
        p = rng.permutation(k)
        A[q] = A[q][:, p]
        R[q] = R[q][:, p][:, :, p]
    return A.astype(np.float32), R.astype(np.float32)


@pytest.mark.parametrize("seed,r", [(0, 4), (1, 4), (2, 3)])
def test_custom_cluster_matches_repro(seed, r):
    """r = 4 is the median trap: jnp.median averages the two middle
    values, torch.median would return the lower one."""
    A, R = ensemble(seed, r=r)
    ref = j_cluster(jnp.asarray(A), jnp.asarray(R))
    got = custom_cluster(torch.from_numpy(A), torch.from_numpy(R))
    np.testing.assert_array_equal(got.perms, ref.perms)
    assert got.n_sweeps == ref.n_sweeps
    np.testing.assert_allclose(got.A_median.numpy(), ref.A_median,
                               rtol=1e-6)
    np.testing.assert_allclose(got.R_aligned.numpy(), ref.R_aligned,
                               rtol=1e-6)
    ref_s, got_s = j_silhouettes(ref.A_aligned), silhouettes(got.A_aligned)
    np.testing.assert_allclose(got_s.s_points.numpy(), ref_s.s_points,
                               rtol=1e-5, atol=1e-6)
    assert float(got_s.s_min) == pytest.approx(float(ref_s.s_min), rel=1e-5)


def test_median_averages_middle_values():
    x = torch.tensor([[1.0], [4.0], [2.0], [8.0]])
    assert float(median(x, 0)) == 3.0
    assert float(median(x[:3], 0)) == 2.0
    np.testing.assert_array_equal(median(x, 0).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), 0)))


def planted(n=72, bs=16, m=3, k=3, seed=0):
    """A planted rank-k non-negative tensor A R A^T with community
    structure, blockified (blocks of unlinked communities drop out)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, k), np.float32)
    comm = np.arange(n) * k // n
    A[np.arange(n), comm] = rng.uniform(0.5, 1.0, n)
    A += 0.05 * rng.uniform(size=(n, k)) * (rng.random((n, k)) < 0.2)
    R = rng.uniform(0.1, 1.0, (m, k, k)).astype(np.float32)
    R[:, 0, 2] = R[:, 2, 0] = 0.0
    X = np.einsum("ia,mab,jb->mij", A, R, A).astype(np.float32)
    return jsp.from_dense(jnp.asarray(X), bs=bs)


def repro_draws(cfg, sp) -> ArrayDraws:
    """repro's draws for every member of the sweep, replayed from its keys
    (selection/ensemble.py unit_keys and _batched_members_bcsr)."""
    members = {}
    for k in cfg.ks:
        keys = unit_keys(cfg, k, tuple(range(cfg.n_perturbations)))
        for q in range(cfg.n_perturbations):
            pkey, fkey = jax.random.split(keys[q])
            noise = jax.random.uniform(pkey, sp.data.shape, sp.data.dtype,
                                       1.0 - cfg.perturbation_delta,
                                       1.0 + cfg.perturbation_delta)
            st = j_init(fkey, sp.n, sp.m, k, dtype=sp.data.dtype)
            members[(k, q)] = (noise, st.A, st.R)
    regress = {k: jax.random.uniform(jax.random.PRNGKey(17), (sp.m, k, k),
                                     dtype=sp.data.dtype, minval=0.05,
                                     maxval=1.0) for k in cfg.ks}
    return ArrayDraws(members, regress, device="cpu")


def test_sweep_matches_repro():
    """The whole slice: same k_opt, per-k s_min/s_mean/rel_err within
    1e-4, on the fused policy (repro impl='ref', the port's plain kernel
    versions on CPU tensors)."""
    sp = planted()
    jcfg = JConfig(k_min=2, k_max=4, n_perturbations=4, rescal_iters=40,
                   regress_iters=50, seed=3,
                   kernel=JPolicy(use_fused=True, impl="ref"))
    ref = JScheduler(jcfg, mode="batched").run(sp)
    tcfg = RescalkConfig(k_min=2, k_max=4, n_perturbations=4,
                         rescal_iters=40, regress_iters=50, seed=3,
                         kernel=KernelPolicy(use_fused=True))
    got = SweepScheduler(tcfg, draws=repro_draws(jcfg, sp)).run(
        convert.bcsr(sp, device="cpu"))
    assert got.k_opt == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
    # members run 40 MU steps each; fp32 summation-order differences grow
    # along the way (repro holds its own batched vs loop members to 1e-3)
    for k in tcfg.ks:
        np.testing.assert_allclose(got.per_k[k].member_errors,
                                   ref.per_k[k].member_errors, rtol=1e-3)


def test_schedule_names_are_checked_once_and_bcsr_runs_batched_only():
    """One list of schedules (core.rescal.MU_SCHEDULES) is what the sweep
    config, the grid engine and the single-process reference accept; the
    BCSR sweep refuses the sliced schedule instead of running batched."""
    from repro_torch.core.rescal import MU_SCHEDULES
    from repro_torch.dist.engine import DistRescalConfig, get_mu_iter
    assert tuple(MU_SCHEDULES) == ("batched", "sliced")
    for schedule in MU_SCHEDULES:
        RescalkConfig(schedule=schedule)
        DistRescalConfig(schedule=schedule)
        assert callable(get_mu_iter(schedule))
    for make in (lambda: RescalkConfig(schedule="loop"),
                 lambda: DistRescalConfig(schedule="loop"),
                 lambda: get_mu_iter("loop")):
        with pytest.raises(ValueError, match="schedule must be one of"):
            make()
    cfg = RescalkConfig(k_min=2, k_max=2, n_perturbations=2,
                        rescal_iters=2, regress_iters=2, schedule="sliced")
    with pytest.raises(ValueError, match="batched schedule only"):
        SweepScheduler(cfg).run(convert.bcsr(planted(), device="cpu"))


def test_ensemble_members_match_repro_draw_for_draw():
    """One unit's members on repro's draws: the same factors, member for
    member, at the MU iterations' accumulated fp32 differences."""
    from repro.selection import run_ensemble as j_run_ensemble
    sp = planted(seed=1)
    jcfg = JConfig(k_min=3, k_max=3, n_perturbations=4, rescal_iters=20,
                   seed=5)
    ref = j_run_ensemble(sp, 3, jcfg, mode="batched")
    tcfg = RescalkConfig(k_min=3, k_max=3, n_perturbations=4,
                         rescal_iters=20, seed=5)
    got = run_ensemble(convert.bcsr(sp, device="cpu"), 3, tcfg,
                       repro_draws(jcfg, sp))
    np.testing.assert_allclose(got.errors.numpy(), ref.errors, rtol=1e-5)
    np.testing.assert_allclose(got.A.numpy(), ref.A, rtol=1e-4, atol=1e-5)


def test_torch_draws_repeat_and_differ_by_member():
    sp = convert.bcsr(planted(), device="cpu")
    d1, d2 = TorchDraws(7, "cpu"), TorchDraws(7, "cpu")
    a, b = d1.member(3, 1, sp, 0.02), d2.member(3, 1, sp, 0.02)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    other = d1.member(3, 2, sp, 0.02)
    assert not torch.equal(a[1], other[1])
    assert float(a[0].min()) >= 0.98 and float(a[0].max()) <= 1.02
    assert torch.equal(d1.regress_R0(3, 3), d2.regress_R0(3, 3))


def test_plan_and_report_read_by_repro(tmp_path):
    """One unit per k; repro's SelectionReport.load reads the port's
    report, and a KResult converts back and forth."""
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=3,
                        rescal_iters=5, regress_iters=5)
    units = plan_sweep(cfg)
    assert [(u.k, u.members, u.uid) for u in units] == [
        (2, (0, 1, 2), "unit_k2_q0-2"), (3, (0, 1, 2), "unit_k3_q0-2")]
    sched = SweepScheduler(cfg, report_path=str(tmp_path / "rep.json"),
                           draws=TorchDraws(0, "cpu"))
    res = sched.run(convert.bcsr(planted(), device="cpu"))
    from repro.selection.report import SelectionReport as JReport
    back = JReport.load(str(tmp_path / "rep.json"))
    assert back.k_opt == res.k_opt and len(back.units) == 2
    assert back.meta["kernel_launches"] == {"bcsr_xa_xta": 0,
                                            "bcsr_spmm": 0,
                                            "fused_xa_xtb": 0,
                                            "score_topk": 0}
    kr = convert.k_result(dataclasses.replace(res.per_k[2]))
    np.testing.assert_array_equal(kr.A_median, res.per_k[2].A_median)
    assert kr.s_min == res.per_k[2].s_min
