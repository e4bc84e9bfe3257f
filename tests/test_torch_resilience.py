"""repro_torch.resilience (fault plans, retry), dist.elastic's straggler
monitor and pod plan, and the port's fault seams, each held against
repro's."""
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import elastic as j_elastic
from repro.obs import trace as j_obs
from repro.resilience import FaultPlan as JPlan
from repro.resilience import FaultSpec as JSpec
from repro.resilience import RetryPolicy as JPolicy
from repro.resilience import SEAMS as J_SEAMS
from repro.resilience import faults as j_faults
from repro_torch.dist import elastic
from repro_torch.obs import trace as obs
from repro_torch.resilience import (SEAMS, DeadlineExceeded,
                                    DeterministicFault, FaultPlan, FaultSpec,
                                    RetryPolicy, RetryStats, TransientError)
from repro_torch.resilience import faults


@pytest.fixture
def tracer(tmp_path):
    """An installed obs.Tracer whose .events the tests inspect."""
    t = obs.Tracer(str(tmp_path / "trace"))
    prev = obs.install(t)
    yield t
    obs.install(prev)
    t.close()


def instants(t, name):
    return [e.get("args") or {} for e in t.events
            if e.get("ph") == "i" and e.get("name") == name]


# ---------------------------------------------------------------------------
# FaultPlan and the seams
# ---------------------------------------------------------------------------

def test_registry_is_repros():
    """The same seams in the same order (the seam lint rule reads either
    package's registry) and the same kinds."""
    assert SEAMS == J_SEAMS
    assert faults.KINDS == j_faults.KINDS


def test_unknown_seam_and_kind_rejected():
    with pytest.raises(ValueError, match="unknown seam"):
        FaultPlan({"no/such": [FaultSpec(kind="delay")]})
    with pytest.raises(ValueError, match="fault kind"):
        FaultSpec(kind="explode")


def test_plan_written_by_repro_fires_on_the_same_hits(tmp_path):
    """A plan saved by repro loads in the port, serializes to the same
    JSON, and fires on the same probe indices; and the other way round."""
    jplan = JPlan.from_json(json.dumps({"specs": {
        "ingest/chunk": [{"kind": "delay", "at": [1, 4], "seconds": 0.0}],
        "sched/unit": [{"kind": "delay", "always": True, "seconds": 0.0}],
        "ckpt/write": [{"kind": "truncate-file", "at": [0],
                        "fraction": 0.25}]}}))
    path = jplan.save(str(tmp_path / "plan.json"))
    plan = FaultPlan.load(path)
    assert json.loads(plan.to_json()) == json.loads(jplan.to_json())
    assert json.loads(JPlan.from_json(plan.to_json()).to_json()) == \
        json.loads(jplan.to_json())
    for p in (plan, jplan):
        for _ in range(6):
            p.fire("ingest/chunk")
        for _ in range(2):
            p.fire("sched/unit", uid="u")
    assert plan.fired == jplan.fired
    assert plan.hits == jplan.hits
    assert plan.summary() == jplan.summary()


def test_raise_kinds_classify():
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-transient", always=True)]})
    with pytest.raises(TransientError):
        plan.fire("sched/unit")
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-deterministic", always=True, message="m")]})
    with pytest.raises(DeterministicFault, match="sched/unit .hit 0.: m"):
        plan.fire("sched/unit")
    assert not RetryPolicy().is_transient(DeterministicFault("x"))
    assert RetryPolicy().is_transient(TransientError("x"))
    assert RetryPolicy().is_transient(OSError("x"))


@pytest.mark.parametrize("seed,nbytes", [(0, 64), (3, 16), (11, 5000)])
def test_corrupt_bytes_hits_repros_offsets(tmp_path, seed, nbytes):
    payload = bytes(range(256)) * 8
    files = []
    for name, plan_cls in (("port", FaultPlan), ("repro", JPlan)):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(payload)
        spec = {"kind": "corrupt-bytes", "always": True, "nbytes": nbytes,
                "seed": seed}
        plan_cls.from_json(json.dumps({"specs": {"ckpt/write": [spec]}})
                           ).fire("ckpt/write", path=path)
        files.append(open(path, "rb").read())
    assert files[0] == files[1] and files[0] != payload


def test_truncate_file_keeps_repros_share(tmp_path):
    sizes = []
    for name, plan_cls in (("port", FaultPlan), ("repro", JPlan)):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(b"x" * 1001)
        spec = {"kind": "truncate-file", "always": True, "fraction": 0.3}
        plan_cls.from_json(json.dumps({"specs": {"ckpt/write": [spec]}})
                           ).fire("ckpt/write", path=path)
        sizes.append(os.path.getsize(path))
    assert sizes[0] == sizes[1] == 300


@pytest.mark.parametrize("shape,seed", [((8,), 1), ((3, 5, 7), 2),
                                        ((4, 6), 9)])
def test_nan_poison_hits_repros_positions(shape, seed):
    """The same flat position per array as repro's, on torch tensors (a
    non-contiguous view too, poisoned in place) and numpy arrays; integer
    arrays are left alone."""
    spec = {"kind": "nan-poison", "always": True, "seed": seed}
    plan_json = json.dumps({"specs": {"ingest/chunk": [spec]}})
    ref = {"a": np.zeros(shape, np.float32), "b": np.zeros(shape, np.float32),
           "i": np.zeros(shape, np.int32)}
    JPlan.from_json(plan_json).fire("ingest/chunk", arrays=ref)
    base = torch.zeros((2,) + shape)
    got = {"a": torch.zeros(shape), "b": base[1],
           "i": torch.zeros(shape, dtype=torch.int32)}
    FaultPlan.from_json(plan_json).fire("ingest/chunk", arrays=got)
    for name in ("a", "b"):
        np.testing.assert_array_equal(np.isnan(got[name].numpy()),
                                      np.isnan(ref[name]))
        assert int(torch.isnan(got[name]).sum()) == 1
    assert not base[0].isnan().any()
    assert not got["i"].any()
    arr = np.zeros(shape, np.float32)
    FaultPlan.from_json(plan_json).fire("ingest/chunk", arrays=arr)
    np.testing.assert_array_equal(np.isnan(arr), np.isnan(ref["a"]))


def test_firing_emits_fault_inject_event(tracer):
    plan = FaultPlan({"serve/request": [
        FaultSpec(kind="delay", always=True, seconds=0.0)]})
    with faults.active(plan):
        faults.probe("serve/request", n=4)
    (ev,) = instants(tracer, "fault/inject")
    assert (ev["seam"], ev["kind"], ev["hit"], ev["n"]) == \
        ("serve/request", "delay", 0, 4)


def test_install_active_restore_and_zero_cost_off():
    assert faults.current() is None
    assert faults.probe("sched/unit", uid="off", attempt=0) is None
    plan = FaultPlan()
    with faults.active(plan):
        assert faults.current() is plan
        inner = FaultPlan()
        with faults.active(inner):
            assert faults.current() is inner
        assert faults.current() is plan
        assert faults.probe("sched/unit") is None
        assert plan.hits == {"sched/unit": 1}
    assert faults.current() is None


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_backoff_equals_repros():
    """crc32 jitter: the same sleep as repro's for every (seed, key,
    attempt), within the documented band, capped."""
    for seed in (0, 1, 7, 123):
        for base, cap, jitter in ((0.05, 5.0, 0.25), (0.1, 1.0, 0.5)):
            ours = RetryPolicy(base_delay=base, max_delay=cap,
                               jitter=jitter, seed=seed)
            theirs = JPolicy(base_delay=base, max_delay=cap, jitter=jitter,
                             seed=seed)
            for uid in ("", "u", "unit_k2_q0-3", "grid_k2q0-k3q1"):
                for attempt in range(0, 10):
                    got = ours.backoff(attempt, uid)
                    assert got == theirs.backoff(attempt, uid)
                    nominal = 0.0 if attempt <= 1 else min(
                        base * 2.0 ** (attempt - 2), cap)
                    assert nominal * (1 - jitter) <= got \
                        <= nominal * (1 + jitter)


def test_transient_retried_then_succeeds():
    calls, sleeps = [], []

    def fn(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise TransientError("flaky")
        return "ok"

    p = RetryPolicy(max_attempts=4, base_delay=0.5)
    result, stats = p.call(fn, key="u", sleep=sleeps.append)
    assert result == "ok" and calls == [0, 1, 2]
    assert stats.attempts == 3
    assert stats.backoff_seconds == pytest.approx(sum(sleeps))
    assert sleeps == [p.backoff(2, "u"), p.backoff(3, "u")]

    def j_fn(attempt):
        if attempt < 2:
            raise j_faults.TransientError("flaky")
        return "ok"

    j_sleeps = []
    _, j_stats = JPolicy(max_attempts=4, base_delay=0.5).call(
        j_fn, key="u", sleep=j_sleeps.append)
    assert sleeps == j_sleeps and stats == RetryStats(**vars(j_stats))


def test_deterministic_error_fails_fast(tracer):
    calls = []

    def fn(attempt):
        calls.append(attempt)
        raise ValueError("shape bug")

    with pytest.raises(ValueError, match="shape bug"):
        RetryPolicy(max_attempts=5).call(fn, key="u", sleep=lambda s: None)
    assert calls == [0]
    (ev,) = instants(tracer, "sched/fail_fast")
    assert ev["error"] == "ValueError" and ev["attempt"] == 1


def test_budget_exhaustion_reraises_original():
    with pytest.raises(TransientError, match="persistent"):
        RetryPolicy(max_attempts=3).call(
            lambda a: (_ for _ in ()).throw(TransientError("persistent")),
            sleep=lambda s: None)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


def test_classify_extends_taxonomy():
    flaky = {"armed": True}

    def fn(attempt):
        if flaky.pop("armed", None):
            raise KeyError("custom-transient")
        return attempt

    p = RetryPolicy(classify=lambda e: isinstance(e, KeyError))
    assert p.call(fn, sleep=lambda s: None)[0] == 1


def test_deadline_overrun_is_transient():
    import time as _time

    def fn(attempt):
        if attempt == 0:
            _time.sleep(5.0)
        return attempt

    result, stats = RetryPolicy(max_attempts=2, deadline=0.05).call(
        fn, sleep=lambda s: None)
    assert (result, stats.attempts) == (1, 2)
    assert issubclass(DeadlineExceeded, TransientError)
    seen = []
    RetryPolicy(deadline=10.0).call(
        lambda a: a, deadline_fn=lambda a: seen.append(a) or 10.0)
    assert seen == [0]


# ---------------------------------------------------------------------------
# dist.elastic
# ---------------------------------------------------------------------------

def test_straggler_monitor_matches_repros():
    rng = random.Random(4)
    durations = [rng.choice([1.0, 1.1, 0.9, 3.0, 7.5]) for _ in range(200)]
    for factor, window in ((2.0, 128), (2.5, 8), (1.5, 3)):
        ours = elastic.StragglerMonitor(factor=factor, window=window)
        theirs = j_elastic.StragglerMonitor(factor=factor, window=window)
        for i, s in enumerate(durations):
            assert ours.record(i, s) == theirs.record(i, s)
            assert ours.baseline == theirs.baseline
        assert ours.flagged == theirs.flagged and ours.times == theirs.times
    mon = elastic.StragglerMonitor(factor=2.0)
    assert mon.baseline is None and not mon.record(0, 100.0)


@pytest.mark.parametrize("r,pods,spares", [(10, 3, 1), (4, 1, 0), (4, 4, 2),
                                           (3, 5, 0), (7, 2, 3)])
def test_ensemble_plan_matches_repros(r, pods, spares):
    plan = elastic.ensemble_plan(r, pods, spares)
    assert plan == j_elastic.ensemble_plan(r, pods, spares)
    assert sorted(q for pod in plan for q in pod if q < r) == list(range(r))
    with pytest.raises(ValueError):
        elastic.ensemble_plan(r, 0)


def test_retry_loop_replays_and_warns_deprecated():
    executed = []
    armed = {"on": True}

    def run(i):
        if i == 3 and armed.pop("on", None):
            raise RuntimeError("injected")
        executed.append(i)

    with pytest.warns(DeprecationWarning, match="RetryPolicy"):
        elastic.retry_loop(run, range(6), restore=lambda: 2)
    assert executed == [0, 1, 2, 2, 3, 4, 5]

    def always(i):
        raise RuntimeError("persistent")

    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="persistent"):
        elastic.retry_loop(always, range(3), restore=lambda: 0,
                           max_restarts=1)


# ---------------------------------------------------------------------------
# The port's probe sites
# ---------------------------------------------------------------------------

def test_kernel_dispatch_fallback_is_counted_and_traced(tracer):
    """A fired budget-overflow runs the plain version for that call, bumps
    kernel_fallbacks() and emits repro's kernel/fallback argument names;
    the hit index counts calls."""
    from repro.kernels import ops as j_ops
    from repro_torch.kernels import ops
    A = torch.rand(5, 3)
    Num = torch.rand(5, 3)
    S = torch.rand(3, 3)
    want = ops.mu_update_a(A, Num, S, 1e-16)
    fb0 = ops.kernel_fallbacks()
    plan = FaultPlan({"kernel/dispatch": [
        FaultSpec(kind="budget-overflow", at=(1,))]})
    with faults.active(plan):
        for _ in range(3):
            assert torch.equal(ops.mu_update_a(A, Num, S, 1e-16), want)
    assert ops.kernel_fallbacks() - fb0 == 1
    assert plan.hits == {"kernel/dispatch": 3}
    assert [f["hit"] for f in plan.fired] == [1]
    (ev,) = instants(tracer, "kernel/fallback")
    assert ev["kernel"] == "mu_update_a" and ev["chosen"] == "ref"
    assert ev["requested_bytes"] == 4 * (15 + 15 + 9)
    # repro's event carries the same argument names
    jplan = JPlan({"kernel/dispatch": [
        JSpec(kind="budget-overflow", always=True)]})
    jt = j_obs.Tracer(None)
    prev = j_obs.install(jt)
    try:
        with j_faults.active(jplan):
            j_ops.mu_update_a(jnp.asarray(A.numpy()),
                              jnp.asarray(Num.numpy()),
                              jnp.asarray(S.numpy()), 1e-16, impl="ref")
    finally:
        j_obs.install(prev)
    (jev,) = [e.get("args") for e in jt.events
              if e.get("name") == "kernel/fallback"]
    assert set(jev) == set(ev)
    assert plan.fired[0]["kernel"] == "mu_update_a" \
        and plan.fired[0]["impl"] == "ref"


def test_kernel_dispatch_overflow_on_a_kernel_call_retries_the_unit(
        tracer, monkeypatch):
    """A fired budget-overflow on a call bound for the CUDA kernel runs no
    plain version: it is counted, traced with chosen="retry" and raised as
    a TransientError, so the unit retries on the kernel and the sweep
    equals the fault-free one.  ``_on_card`` is forced true, so the CPU
    stands in for the card (the wrappers' plain versions run the calls)."""
    from repro_torch.core import sparse as tsp
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.selection import RescalkConfig, SweepScheduler
    monkeypatch.setattr(ops, "_on_card", lambda tensors: True)
    A, Num, S = torch.rand(5, 3), torch.rand(5, 3), torch.rand(3, 3)
    fb0 = ops.kernel_fallbacks()
    with faults.active(FaultPlan({"kernel/dispatch": [
            FaultSpec(kind="budget-overflow", at=(0,))]})):
        with pytest.raises(TransientError, match="budget-overflow"):
            ops.mu_update_a(A, Num, S, 1e-16)
        ops.mu_update_a(A, Num, S, 1e-16)
    assert ops.kernel_fallbacks() - fb0 == 1
    (ev,) = instants(tracer, "kernel/fallback")
    assert ev["kernel"] == "mu_update_a" and ev["chosen"] == "retry"

    sp = tsp.random_bcsr(np.random.default_rng(5), m=2, n=64, bs=16,
                         block_density=0.4, device="cpu")
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                        rescal_iters=8, regress_iters=8,
                        kernel=KernelPolicy(use_fused=True))
    want = SweepScheduler(cfg, mode="loop").run(sp)
    sched = SweepScheduler(cfg, mode="loop",
                           retry=RetryPolicy(base_delay=0.001))
    with faults.active(FaultPlan({"kernel/dispatch": [
            FaultSpec(kind="budget-overflow", at=(3,))]})):
        got = sched.run(sp)
    rep = sched.report
    assert rep.meta["n_kernel_fallbacks"] == 1 and rep.meta["n_retries"] == 1
    assert [u.attempts for u in rep.units] == [2] + [1] * (len(rep.units)
                                                           - 1)
    assert got.k_opt == want.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        assert np.array_equal(getattr(got, name), getattr(want, name))


def test_ingest_chunk_probe_poisons_repros_positions():
    """COOBuilder.add is the ingest/chunk seam in both packages: one probe
    per chunk, a nan-poison hitting the same value."""
    from repro.io.triples import COOBuilder as JBuilder
    from repro_torch.io.triples import COOBuilder
    spec = {"kind": "nan-poison", "at": [1], "seed": 5}
    plan_json = json.dumps({"specs": {"ingest/chunk": [spec]}})
    rng = np.random.default_rng(0)
    chunks = [(rng.integers(0, 2, 6), rng.integers(0, 9, 6),
               rng.integers(0, 9, 6), rng.random(6).astype(np.float32))
              for _ in range(3)]
    outs = []
    for builder, plan_cls, active in (
            (COOBuilder, FaultPlan, faults.active),
            (JBuilder, JPlan, j_faults.active)):
        plan = plan_cls.from_json(plan_json)
        b = builder()
        with active(plan):
            for rels, rows, cols, vals in chunks:
                b.add(rels, rows, cols, vals.copy())
        assert plan.hits == {"ingest/chunk": 3}
        assert plan.fired[0]["chunk"] == 1
        coo = b.finalize()
        outs.append(np.isnan(coo.vals))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].sum() == 1


def test_ingest_runs_the_chunk_seam(tmp_path):
    """ingest_npz and ingest_tsv go through COOBuilder: a transient fault
    on the second chunk surfaces."""
    from repro_torch.io import ingest_npz
    path = str(tmp_path / "x.npz")
    np.savez(path, row=np.arange(10), rel=np.zeros(10, np.int64),
             col=np.arange(10), val=np.ones(10, np.float32))
    plan = FaultPlan({"ingest/chunk": [
        FaultSpec(kind="raise-transient", at=(1,))]})
    with faults.active(plan), pytest.raises(TransientError):
        ingest_npz(path, chunk=4)
    assert ingest_npz(path, chunk=4).nnz == 10


def test_serve_request_probe_fires_at_admission():
    from repro_torch.serve import (FactorBundle, Query, ServeConfig,
                                   ServeEngine)
    rng = np.random.default_rng(0)
    bundle = FactorBundle(A=rng.random((16, 3), np.float32),
                          R=rng.random((2, 3, 3), np.float32))
    eng = ServeEngine(bundle, ServeConfig(topk=3, batch=4), device="cpu")
    plan = FaultPlan({"serve/request": [
        FaultSpec(kind="raise-transient", at=(1,))]})
    with faults.active(plan):
        eng.query([Query("sro", 1, 0)])
        with pytest.raises(TransientError):
            eng.query([Query("sro", 2, 0)])
    assert plan.fired[0]["n"] == 1 and eng.batches == 1
