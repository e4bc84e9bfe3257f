"""repro_torch's per-k reduction and sweep against repro's.

The sweep parity runs both packages on one planted rank-3 BCSR tensor with
the same draws: the port gets ``ArrayDraws`` filled from repro's own key
discipline (``unit_keys`` -> split into (pkey, fkey) -> the stored-block
noise and init_factors' draws; the regression's PRNGKey(17)).
"""
import dataclasses
import json
import os

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
                                            "mu_update_a": 0,
                                            "score_topk": 0,
                                            "flash_attention": 0}
    kr = convert.k_result(dataclasses.replace(res.per_k[2]))
    np.testing.assert_array_equal(kr.A_median, res.per_k[2].A_median)
    assert kr.s_min == res.per_k[2].s_min


# ---------------------------------------------------------------------------
# The virtual and sharded operand on one device
# ---------------------------------------------------------------------------

VIRTUAL = "virtual:bcsr:n=384,m=2,k=3,bs=32,density=0.25,grid={g},seed=4"


@pytest.mark.parametrize("mode,g", [("batched", 1), ("batched", 2),
                                    ("loop", 2), ("grid", 2)])
def test_virtual_sweep_matches_repro(mode, g):
    """The slice as a whole on a virtual operand: repro's ShardedBCSR of
    the spec (the port's generation from repro's draws is held in
    tests/test_torch_io.py) through the port's SweepScheduler, merged
    once, against repro's SweepScheduler on the same draws: the same
    k_opt, per-k s_min / s_mean / rel_err within 1e-4."""
    from repro.io import VirtualSpec as JSpec
    from repro.io import virtual_sharded_bcsr as j_virtual
    sharded = j_virtual(JSpec.parse(VIRTUAL.format(g=g)))
    jcfg = JConfig(k_min=2, k_max=4, n_perturbations=3, rescal_iters=30,
                   regress_iters=30, seed=1,
                   kernel=JPolicy(use_fused=True, impl="ref"))
    ref = JScheduler(jcfg, mode=mode).run(sharded)
    tcfg = RescalkConfig(k_min=2, k_max=4, n_perturbations=3,
                         rescal_iters=30, regress_iters=30, seed=1,
                         kernel=KernelPolicy(use_fused=True))
    ours = convert.sharded_bcsr(sharded, device="cpu")
    got = SweepScheduler(tcfg, mode=mode,
                         draws=repro_draws(jcfg, sharded.to_bcsr())).run(ours)
    assert got.k_opt == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_operand_is_merged_once_per_sweep(monkeypatch):
    """On one device the scheduler merges a ShardedBCSR once, not per
    unit, and runs the batched schedule only; with grid= it refuses a
    ShardedBCSR (a cell takes its CellShard)."""
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    from repro_torch.io.partition import ShardedBCSR
    from repro_torch.dist.sharding import Grid
    sharded = virtual_sharded_bcsr(VirtualSpec.parse(VIRTUAL.format(g=2)),
                                   device="cpu")
    calls = []
    merge = ShardedBCSR.to_bcsr
    monkeypatch.setattr(ShardedBCSR, "to_bcsr",
                        lambda self: calls.append(1) or merge(self))
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                        rescal_iters=3, regress_iters=3)
    res = SweepScheduler(cfg, mode="loop",
                         draws=TorchDraws(0, "cpu")).run(sharded)
    assert len(calls) == 1 and res.per_k[2].A_median.shape == (384, 2)
    with pytest.raises(ValueError, match="batched schedule only"):
        SweepScheduler(dataclasses.replace(cfg, schedule="sliced")).run(
            sharded)
    with pytest.raises(TypeError, match="CellShard"):
        SweepScheduler(cfg, grid=Grid.at_rank(0, 1, 1, 1, "cpu")).run(
            sharded)


def test_torch_draws_bcsr_member_is_the_grid_cell():
    """TorchDraws draws a single-device BCSR member as cell 0 of a 1 x 1
    grid draws its shard (noise from (seed, k, q, 0), A0 and R0 from
    (seed, k, q)), so the two sweeps compute on the same numbers."""
    from repro_torch.dist.sharding import Grid
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    sharded = virtual_sharded_bcsr(VirtualSpec.parse(VIRTUAL.format(g=1)),
                                   device="cpu")
    sp = sharded.to_bcsr()
    d = TorchDraws(5, "cpu")
    noise, A0, R0 = d.member(3, 2, sp, 0.02)
    cell = torch.empty_like(sharded.cell(0, 0).sp.data)
    A1, R1 = d.grid_member(3, 2, Grid.at_rank(0, 1, 1, 1, "cpu"), cell,
                           0.02, n=sharded.n_pad)
    assert torch.equal(noise, cell) and torch.equal(A0, A1) \
        and torch.equal(R0, R1)


# ---------------------------------------------------------------------------
# Checkpoint / resume, retry and fault seams (repro's tests/test_selection
# .py:474-560, tests/test_resilience.py TestStragglerDeadline)
# ---------------------------------------------------------------------------

RESUME_CFG = dict(k_min=2, k_max=3, n_perturbations=2, rescal_iters=12,
                  regress_iters=10, seed=1)


def _resume_operand():
    return convert.bcsr(planted(n=48, bs=16, m=2), device="cpu")


def _same_sweep(got, want):
    assert got.k_opt == want.k_opt
    for k in want.per_k:
        for name in ("s_min", "s_mean", "rel_err"):
            assert getattr(got.per_k[k], name) == getattr(want.per_k[k], name)
        np.testing.assert_array_equal(got.per_k[k].member_errors,
                                      want.per_k[k].member_errors)
        np.testing.assert_array_equal(got.per_k[k].A_median,
                                      want.per_k[k].A_median)


@pytest.mark.parametrize("mode,chunk,stop,units,reused", [
    ("batched", None, 1, 2, 1), ("loop", None, 3, 4, 3),
    ("grid", 3, 1, 2, 1), ("batched", None, 0, 2, 0)])
def test_interrupt_then_resume_equals_uninterrupted(tmp_path, mode, chunk,
                                                    stop, units, reused):
    """stop_after_units computes at most that many units and raises
    SweepInterrupted; a resume from the same ckpt_dir restores them and
    recomputes the rest, bit for bit the uninterrupted sweep (the
    reduction takes the same TorchDraws words either way)."""
    from repro_torch.selection import SweepInterrupted
    X = _resume_operand()
    cfg = RescalkConfig(**RESUME_CFG, kernel=KernelPolicy(use_fused=True))
    d = str(tmp_path / "ck")
    with pytest.raises(SweepInterrupted) as stop_info:
        SweepScheduler(cfg, mode=mode, grid_chunk=chunk, ckpt_dir=d,
                       stop_after_units=stop).run(X)
    assert stop_info.value.executed == stop and stop_info.value.resumable
    sched = SweepScheduler(cfg, mode=mode, grid_chunk=chunk, ckpt_dir=d)
    res = sched.run(X)
    rep = sched.report
    assert len(rep.units) == units and rep.n_reused == reused
    assert all(u.attempts == (0 if u.reused else 1) for u in rep.units)
    _same_sweep(res, SweepScheduler(cfg, mode=mode,
                                    grid_chunk=chunk).run(X))
    again = SweepScheduler(cfg, mode=mode, grid_chunk=chunk, ckpt_dir=d)
    _same_sweep(again.run(X), res)
    assert again.report.n_reused == units


def test_resume_records_match_repros(tmp_path):
    """The same scenario through repro's scheduler and the port's (kill
    after one unit, a transient fault on the resumed run's first attempt,
    resume): the same units, reuse flags, attempts, retries and backoff."""
    from repro.resilience import FaultPlan as JPlan
    from repro.resilience import faults as j_faults
    from repro.selection import SweepInterrupted as JInterrupted
    from repro_torch.resilience import FaultPlan, RetryPolicy, faults
    from repro_torch.selection import SweepInterrupted
    plan = {"specs": {"sched/unit": [{"kind": "raise-transient",
                                      "at": [0]}]}}
    sp = planted(n=48, bs=16, m=2)
    records = []
    for pkg, cfg, X, interrupted, plan_cls, active, retry in (
            ("port", RescalkConfig(**RESUME_CFG), convert.bcsr(sp, "cpu"),
             SweepInterrupted, FaultPlan, faults.active,
             dict(retry=RetryPolicy(max_attempts=3))),
            ("repro", JConfig(**RESUME_CFG), sp, JInterrupted, JPlan,
             j_faults.active, dict(max_retries=2))):
        sched_cls = SweepScheduler if pkg == "port" else JScheduler
        d = str(tmp_path / pkg)
        with pytest.raises(interrupted):
            sched_cls(cfg, mode="loop", ckpt_dir=d, stop_after_units=1,
                      **retry).run(X)
        sched = sched_cls(cfg, mode="loop", ckpt_dir=d, **retry)
        with active(plan_cls.from_json(json.dumps(plan))):
            sched.run(X)
        records.append([(u.uid, u.reused, u.attempts, u.retries,
                         u.backoff_seconds) for u in sched.report.units])
        assert sched.report.meta["n_retries"] == 1
    assert records[0] == records[1]


def test_torn_checkpoint_is_quarantined_and_recomputed(tmp_path):
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    from repro_torch.selection import SweepInterrupted
    X = _resume_operand()
    cfg = RescalkConfig(**RESUME_CFG)
    d = str(tmp_path / "ck")
    plan = FaultPlan({"ckpt/write": [
        FaultSpec(kind="truncate-file", at=(0,), fraction=0.5)]})
    with faults.active(plan), pytest.raises(SweepInterrupted):
        SweepScheduler(cfg, ckpt_dir=d, stop_after_units=1).run(X)
    sched = SweepScheduler(cfg, ckpt_dir=d)
    with pytest.warns(UserWarning, match="quarantined"):
        res = sched.run(X)
    assert sched.report.n_reused == 0
    assert any(".corrupt." in f
               for f in os.listdir(os.path.join(d, "unit_k2_q0-1")))
    _same_sweep(res, SweepScheduler(cfg).run(X))


def test_changed_config_or_data_is_refused(tmp_path):
    """sweep.json: another config, another mode, other values or another
    sparsity pattern refuse to resume."""
    from repro_torch.core.sparse import random_bcsr
    X = random_bcsr(np.random.default_rng(0), m=2, n=64, bs=16,
                    block_density=0.4, device="cpu")
    cfg = RescalkConfig(**RESUME_CFG)
    d = str(tmp_path / "ck")
    SweepScheduler(cfg, ckpt_dir=d).run(X)
    for other_cfg, mode, other in (
            (dataclasses.replace(cfg, rescal_iters=13), "batched", X),
            (cfg, "loop", X),
            (cfg, "batched", X.with_data(X.data * 1.001)),
            (cfg, "batched", tsp_moved(X))):
        with pytest.raises(ValueError,
                           match="different sweep configuration"):
            SweepScheduler(other_cfg, mode=mode, ckpt_dir=d).run(other)
    with open(os.path.join(d, "sweep.json")) as f:
        stored = json.load(f)
    assert stored["mode"] == "batched" and stored["mesh"] is None
    assert stored["manifest"]["kind"] == "bcsr"


def tsp_moved(X):
    """X's values on another pattern: one stored block moved to a free
    block-column of its row (the order stays row-major)."""
    from repro_torch.core.sparse import BCSR
    rows, cols = X.block_rows.tolist(), X.block_cols.tolist()
    taken = set(zip(rows, cols))
    for z in range(len(rows) - 1, -1, -1):
        nxt = (rows[z + 1], cols[z + 1]) if z + 1 < len(rows) else None
        for j in range(cols[z] + 1, X.nblocks):
            if (rows[z], j) not in taken and (nxt is None
                                              or (rows[z], j) < nxt):
                cols[z] = j
                return BCSR(data=X.data, block_rows=X.block_rows,
                            block_cols=torch.tensor(cols, dtype=torch.int32),
                            n=X.n)
    raise AssertionError("no free block to move to")


def test_retried_unit_leaves_the_report_unchanged(tmp_path):
    """A transient sched/unit fault: the unit retries after repro's
    backoff, the curves and k_opt are the fault-free run's, and the report
    counts the retry; a deterministic fault fails fast after one
    attempt."""
    from repro_torch.resilience import (DeterministicFault, FaultPlan,
                                        FaultSpec, RetryPolicy, faults)
    X = _resume_operand()
    cfg = RescalkConfig(**RESUME_CFG)
    clean = SweepScheduler(cfg).run(X)
    retry = RetryPolicy(max_attempts=3, base_delay=0.001)
    sched = SweepScheduler(cfg, retry=retry)
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-transient", at=(1,))]})
    with faults.active(plan):
        res = sched.run(X)
    _same_sweep(res, clean)
    u = sched.report.units
    assert [(x.attempts, x.retries) for x in u] == [(1, 0), (2, 1)]
    assert u[1].backoff_seconds == retry.backoff(2, u[1].uid)
    assert sched.report.meta["n_retries"] == 1
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-deterministic", at=(0,))]})
    with faults.active(plan), pytest.raises(DeterministicFault):
        SweepScheduler(cfg, retry=retry).run(X)
    assert plan.hits == {"sched/unit": 1}


def test_pods_split_members_and_straggler_deadline():
    """n_pods groups each rank's members as ensemble_plan does (repro's
    plan); a retried attempt's deadline shrinks to factor x the median
    unit time once there is a baseline."""
    from repro.selection.scheduler import plan_sweep as j_plan
    from repro_torch.resilience import RetryPolicy
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=5,
                        rescal_iters=3, regress_iters=3)
    jcfg = JConfig(k_min=2, k_max=3, n_perturbations=5)
    for pods in (1, 2, 3):
        for mode, chunk in (("batched", None), ("grid", None),
                            ("grid", 4)):
            got = plan_sweep(cfg, mode=mode, n_pods=pods, grid_chunk=chunk)
            want = j_plan(jcfg, mode=mode, n_pods=pods, grid_chunk=chunk)
            assert [u.uid for u in got] == [u.uid for u in want]
    X = _resume_operand()
    one = SweepScheduler(cfg, draws=TorchDraws(0, "cpu")).run(X)
    sched = SweepScheduler(cfg, n_pods=2, draws=TorchDraws(0, "cpu"))
    two = sched.run(X)
    assert [u.members for u in sched.report.units] == [
        [0, 1, 2], [3, 4], [0, 1, 2], [3, 4]]
    assert two.k_opt == one.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(two, name), getattr(one, name),
                                   rtol=1e-5, atol=1e-6)
    sched = SweepScheduler(cfg, retry=RetryPolicy(deadline=60.0),
                           straggler_factor=2.0)
    assert sched._unit_deadline(0) == 60.0
    for i in range(4):
        sched.stragglers.record(i, 1.0)
    assert sched._unit_deadline(0) == 60.0
    assert sched._unit_deadline(1) == pytest.approx(2.0)
    assert SweepScheduler(cfg)._unit_deadline(1) is None


def test_process_grid_refuses_checkpoints_pods_and_retries():
    """The process grid takes checkpoints, pods and retries now (two
    attempts by default, as on one device and on repro's mesh); what it
    refuses is repro's mesh refusals: loop mode, and units that do not
    split over the grid's pods."""
    from repro_torch.dist.sharding import Grid
    from repro_torch.resilience import RetryPolicy
    cfg = RescalkConfig(k_min=2, k_max=2, n_perturbations=2)
    grid = Grid.at_rank(0, 1, 1, 1, "cpu")
    assert SweepScheduler(cfg, grid=grid).retry.max_attempts == 2
    for kw in (dict(ckpt_dir="ck"), dict(n_pods=2),
               dict(retry=RetryPolicy(max_attempts=2)),
               dict(mode="grid", grid_chunk=1)):
        SweepScheduler(cfg, grid=grid, **kw)
    with pytest.raises(ValueError, match="host-only"):
        SweepScheduler(cfg, grid=grid, mode="loop")
    with pytest.raises(ValueError, match="pods=2"):
        SweepScheduler(cfg, grid=Grid.at_rank(0, 2, 1, 1, "cpu"), n_pods=2)


def test_async_checkpoints_resume(tmp_path):
    """async_ckpt writes each unit on a thread, joined at the next
    checkpoint boundary and before SweepInterrupted: the resume reuses
    every computed unit."""
    from repro_torch.selection import SweepInterrupted
    X = _resume_operand()
    cfg = RescalkConfig(**RESUME_CFG)
    d = str(tmp_path / "ck")
    with pytest.raises(SweepInterrupted):
        SweepScheduler(cfg, mode="loop", ckpt_dir=d, async_ckpt=True,
                       stop_after_units=3).run(X)
    sched = SweepScheduler(cfg, mode="loop", ckpt_dir=d, async_ckpt=True)
    _same_sweep(sched.run(X), SweepScheduler(cfg, mode="loop").run(X))
    assert sched.report.n_reused == 3
