"""The port's telemetry (``repro_torch.obs``) against ``repro.obs``: the
mu-ratio formula, the tracer's records and exports, the metrics buffer's
layout after a batched ensemble fed ``repro``'s own draws, the cost model
and the byte ledger; the flags reaching every MU step and costing nothing
when off; and traced CLI runs whose artifacts pass the unchanged
``scripts/check_trace.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.compat import drain_effects
from repro.io import manifest_of as j_manifest_of
from repro.obs import costs as j_costs
from repro.obs import memory as j_memory
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro.selection import RescalkConfig as JConfig
from repro.selection import run_ensemble as j_run_ensemble
from repro.selection.report import UnitRecord as JUnitRecord
from repro_torch import convert
from repro_torch import obs as t_obs
from repro_torch.core import rescal as trescal
from repro_torch.core import sparse as tsparse
from repro_torch.io import manifest_of
from repro_torch.launch import rescalk_run, serve
from repro_torch.obs import costs, memory, metrics
from repro_torch.obs import trace as obs
from repro_torch.selection import (RescalkConfig, SweepScheduler,
                                   run_ensemble)
from repro_torch.selection.report import UnitRecord
from test_torch_selection import planted, repro_draws

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
CHECK_TRACE = str(REPO / "scripts" / "check_trace.py")


def check_trace(*args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, CHECK_TRACE, *map(str, args)],
                          capture_output=True, text=True, timeout=120)


@pytest.fixture
def tbuffer():
    buf = metrics.MetricsBuffer()
    prev = metrics.install_buffer(buf)
    yield buf
    metrics.install_buffer(prev)


def test_exports_match_repro():
    import repro.obs as jobs
    assert t_obs.__all__ == jobs.__all__


# ---------------------------------------------------------------------------
# update_ratio: repro's formula, per member
# ---------------------------------------------------------------------------

def seeded_pair(shape):
    """A factor and its MU-like update: 30% multiplicative noise."""
    rng = np.random.default_rng(0)
    old = rng.random(shape).astype(np.float32)
    new = (old * (1 + 0.3 * rng.standard_normal(shape))).astype(np.float32)
    return old, new


@pytest.mark.parametrize("shape", [(64, 5), (4, 64, 5)])
def test_update_ratio_matches_repro(shape):
    """Per member, mean(|new - old| / (|old| + 1e-30)), as repro's; the
    port's former ||new - old|| / ||old|| gave 0.2829 on the (64, 5) pair
    where repro gives 0.2345."""
    old, new = seeded_pair(shape)
    got = metrics.update_ratio(torch.from_numpy(old), torch.from_numpy(new))
    assert tuple(got.shape) == shape[:-2]
    want = [float(j_metrics.update_ratio(jnp.asarray(o), jnp.asarray(n)))
            for o, n in zip(old.reshape((-1,) + shape[-2:]),
                            new.reshape((-1,) + shape[-2:]))]
    np.testing.assert_allclose(got.numpy().reshape(-1), want, rtol=1e-6)
    if shape == (64, 5):
        assert round(want[0], 4) == 0.2345
        norm_ratio = np.linalg.norm(new - old) / np.linalg.norm(old)
        assert round(float(norm_ratio), 4) == 0.2829
        assert abs(float(got) - norm_ratio) > 0.04


def test_update_ratio_fixed_points():
    A = torch.ones(4, 2)
    assert float(metrics.update_ratio(A, A)) == 0.0
    assert float(metrics.update_ratio(A, 2 * A)) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Tracer: records, nesting, Chrome export, summarize
# ---------------------------------------------------------------------------

def drive(mod, out_dir):
    """The same spans and instants through either package's tracer."""
    tr = mod.Tracer(out_dir, meta={"run": "t"})
    prev = mod.install(tr)
    try:
        with mod.span("sched/plan", mode="batched"):
            pass
        with mod.span("sched/execute", uid="u0", attempt=1):
            with mod.span("sched/reduce", k=2):
                mod.event("serve/cache", hits=1)
        with pytest.raises(KeyError):
            with mod.span("serve/request", n=3):
                raise KeyError("x")
        with mod.timed("serve/score", batch=4) as sw:
            pass
        assert sw.seconds >= 0
    finally:
        mod.install(prev)
        tr.close()
    return tr


def strip(events):
    return [{k: v for k, v in e.items()
             if k not in ("ts", "pid", "tid", "dur")}
            | ({"args": {a: b for a, b in e["args"].items()
                         if a != "unix_time"}} if "args" in e else {})
            for e in events]


def test_tracer_records_and_exports_match_repro(tmp_path):
    t = drive(obs, str(tmp_path / "t"))
    j = drive(j_trace, str(tmp_path / "j"))
    assert strip(t.events) == strip(j.events)
    on_disk = [json.loads(line)
               for line in (tmp_path / "t" / "trace.jsonl").read_text()
               .splitlines()]
    assert strip(on_disk) == strip(t.events)
    ends = [e for e in t.events if e["ph"] == "E"]
    assert [e["name"] for e in ends] == [
        "sched/plan", "sched/reduce", "sched/execute", "serve/request",
        "serve/score"]
    assert ends[3]["args"]["outcome"] == "error"
    assert all(e["dur"] >= 0 for e in ends)
    for tr, sub in ((t, "t"), (j, "j")):
        tr.export_chrome(str(tmp_path / sub / "chrome.json"))
    tc = json.loads((tmp_path / "t" / "chrome.json").read_text())
    jc = json.loads((tmp_path / "j" / "chrome.json").read_text())
    assert strip(tc["traceEvents"]) == strip(jc["traceEvents"])
    assert tc["displayTimeUnit"] == jc["displayTimeUnit"]
    summ = t.summarize().splitlines()
    assert [line.split()[:2] for line in summ] == \
        [line.split()[:2] for line in j.summarize().splitlines()]
    assert summ[-1] == "compile events: 0"
    assert check_trace(tmp_path / "t").returncode == 2  # no chrome file
    t.export_chrome(str(tmp_path / "t" / "trace_chrome.json"))
    assert check_trace(tmp_path / "t").returncode == 0


def test_tracing_scopes_install_and_sampler():
    assert obs.current() is None
    with obs.tracing(sample_memory=True, sample_interval=0.01) as tr:
        assert obs.current() is tr
    assert obs.current() is None
    assert tr.memory_sampler.peak_bytes > 0
    assert any(e["name"] == "mem/sample" for e in tr.events)


# ---------------------------------------------------------------------------
# MetricsBuffer: ring, member layout, bulk host copies, repro's layout
# ---------------------------------------------------------------------------

def test_ring_buffer_drops_oldest():
    buf = metrics.MetricsBuffer(capacity=3)
    for i in range(5):
        buf.append("t", {"v": float(i)})
    assert len(buf) == 3 and buf.dropped == 2
    np.testing.assert_allclose(buf.trajectory("t", "v"), [2, 3, 4])
    assert "dropped 2" in buf.summarize()


def test_member_records_expand_and_copy_in_bulk(tmp_path, monkeypatch):
    """A record of (r,) values stands for r points (a 0-d value repeats);
    tensors stay unconverted until _FLUSH_EVERY records are pending."""
    monkeypatch.setattr(metrics, "_FLUSH_EVERY", 3)
    buf = metrics.MetricsBuffer()
    for it in range(2):
        buf.append("s", {"step": it, "err": torch.arange(4.0) + 10 * it})
    assert all(torch.is_tensor(rec["err"]) for _, _, rec in buf.records)
    buf.append("s", {"step": 2, "err": torch.arange(4.0) + 20})
    assert not any(torch.is_tensor(v) for _, _, rec in buf.records
                   for v in rec.values())
    buf.append("w", {"vec": np.ones((2, 3))})
    assert buf.tags() == ["s", "w"]
    np.testing.assert_array_equal(buf.trajectory("s", "step"),
                                  np.repeat([0, 1, 2], 4))
    np.testing.assert_array_equal(
        buf.trajectory("s", "err"),
        np.concatenate([np.arange(4.0) + 10 * i for i in range(3)]))
    assert buf.trajectory("w", "vec").shape == (1, 2, 3)
    assert buf.trajectory("missing", "v").size == 0
    assert len(list(buf.iter_tag("s"))) == 12
    buf.save_npz(str(tmp_path / "m.npz"))
    with np.load(tmp_path / "m.npz") as d:
        assert sorted(d.files) == ["s.err", "s.step", "w.vec"]


def test_metrics_layout_matches_repro_after_batched_ensemble(tbuffer):
    """10 MU iterations of 4 members on repro's draws: the same keys and
    shapes (iterations x members points), values at rtol 1e-4.  repro's
    per-member callbacks do not arrive in member order within an
    iteration, so each iteration's 4 values are compared sorted."""
    sp = planted(seed=1)
    jcfg = JConfig(k_min=3, k_max=3, n_perturbations=4, rescal_iters=10,
                   seed=5, trace_metrics=True)
    jbuf = j_metrics.MetricsBuffer()
    prev = j_metrics.install_buffer(jbuf)
    try:
        j_run_ensemble(sp, 3, jcfg, mode="batched")
        drain_effects()
    finally:
        j_metrics.install_buffer(prev)
    tcfg = RescalkConfig(k_min=3, k_max=3, n_perturbations=4,
                         rescal_iters=10, seed=5, trace_metrics=True)
    run_ensemble(convert.bcsr(sp, device="cpu"), 3, tcfg,
                 repro_draws(jcfg, sp))
    want, got = jbuf.to_arrays(), tbuffer.to_arrays()
    assert sorted(got) == sorted(want) == [
        f"core.sparse.sparse_mu_step.{n}"
        for n in ("a_norm", "mu_ratio", "r_norm", "rel_error")]
    assert len(tbuffer) == 10
    for key in want:
        assert got[key].shape == want[key].shape == (40,)
        np.testing.assert_allclose(np.sort(got[key].reshape(10, 4), axis=1),
                                   np.sort(want[key].reshape(10, 4), axis=1),
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# The flags reach every MU step, and cost nothing when off
# ---------------------------------------------------------------------------

FLAG_CASES = [("bcsr", "batched"), ("bcsr", "grid"), ("dense", "batched"),
              ("dense", "loop"), ("dense", "grid")]
STEP_TAGS = {("bcsr", "batched"): "core.sparse.sparse_mu_step",
             ("bcsr", "grid"): "core.sparse.masked_sparse_mu_step",
             ("dense", "batched"): "core.rescal.mu_step_batched",
             ("dense", "loop"): "core.rescal.mu_step_batched",
             ("dense", "grid"): "core.rescal.masked_mu_step"}


def flag_operand(kind):
    sp = planted(n=48, bs=16, m=2)
    t = convert.bcsr(sp, device="cpu")
    if kind == "bcsr":
        return t
    return tsparse.to_dense(t)


@pytest.mark.parametrize("kind,mode", FLAG_CASES)
def test_flags_reach_every_mu_step_and_cost_nothing_off(monkeypatch, kind,
                                                         mode):
    """trace_metrics and sanitize off, no tracer installed: no step calls
    record_metrics, no check runs and every span is the shared null
    context.  On: one record and one enabled check per MU iteration per
    member group, under the step's tag."""
    calls, checks = [], []

    def spy(tag, **values):
        calls.append((tag, sorted(values)))

    real_sanitize = tsparse.sanitize_state

    def sanitize_spy(A, R, **kw):
        checks.append(kw["enabled"])
        return real_sanitize(A, R, **kw)

    for mod in (tsparse, trescal):
        monkeypatch.setattr(mod, "record_metrics", spy)
        monkeypatch.setattr(mod, "sanitize_state", sanitize_spy)
    X = flag_operand(kind)
    assert obs.current() is None and metrics.get_buffer() is None
    assert obs.span("sched/execute", uid="u") is obs._NULL
    base = dict(k_min=2, k_max=3, n_perturbations=2, rescal_iters=3,
                regress_iters=3)
    SweepScheduler(RescalkConfig(**base), mode=mode).run(X)
    assert calls == [] and not any(checks)
    checks.clear()
    cfg = RescalkConfig(**base, trace_metrics=True, sanitize=True)
    SweepScheduler(cfg, mode=mode).run(X)
    groups = {"batched": 2, "loop": 4, "grid": 1}[mode]
    assert len(calls) == 3 * groups
    assert {tag for tag, _ in calls} == {STEP_TAGS[kind, mode]}
    assert checks.count(True) == 3 * groups


# ---------------------------------------------------------------------------
# Cost model and byte ledger: equal to repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,k", [(256, 4, 3), (16384, 8, 5),
                                   (131072, 8, 2)])
def test_cost_models_match_repro(n, m, k):
    assert costs.dense_mu_cost(n, m, k) == j_costs.dense_mu_cost(n, m, k)
    assert costs.bcsr_mu_cost(m, n // 16, 128, k) == \
        j_costs.bcsr_mu_cost(m, n // 16, 128, k)


def test_cost_table_rows_match_repro():
    sp = planted()
    t = convert.bcsr(sp, device="cpu")
    dense = tsparse.to_dense(t)
    fields = dict(members=[0, 1], reused=False, retries=0)
    mine = [UnitRecord(uid="unit_k2_q0-1", k=2, seconds=0.5, **fields),
            UnitRecord(uid="grid_k2q0-k3q1", k=-1, seconds=0.0,
                       cells=[[2, 0], [2, 1], [3, 0]], **fields)]
    theirs = [JUnitRecord(**{f: getattr(r, f) for f in (
        "uid", "k", "members", "seconds", "reused", "retries", "cells")})
        for r in mine]
    for top, jop in ((t, sp), (dense, jnp.asarray(dense.numpy()))):
        rows = costs.cost_table(mine, top, iters=7)
        assert rows == j_costs.cost_table(theirs, jop, iters=7)
        assert costs.format_cost_table(rows) == \
            j_costs.format_cost_table(rows)
        assert rows[0]["xla_gflop"] is None and "-" in \
            costs.format_cost_table(rows).splitlines()[2]
    assert [costs.unit_ks(r) for r in mine] == \
        [j_costs.unit_ks(r) for r in theirs]


def test_memory_ledger_matches_repro(tmp_path):
    sp = planted(n=128)
    man, jman = manifest_of(convert.bcsr(sp, device="cpu")), j_manifest_of(sp)
    assert memory.accounted_ensemble_bytes(man, n_members=4, k_max=5) == \
        j_memory.accounted_ensemble_bytes(jman, n_members=4, k_max=5)
    kw = dict(per_k={2: {"argument": 10, "output": 4, "temp": 7,
                         "peak": 21}, 3: {}},
              peak_host_bytes=123, peak_device_bytes=None,
              accounted_sweep_bytes=99, kernel_fallbacks=0,
              meta={"n_units": 2})
    led = memory.MemoryLedger.from_manifest(man, **kw)
    jled = j_memory.MemoryLedger.from_manifest(jman, **kw)
    assert led.to_dict() == jled.to_dict()
    assert led.summary_line() == jled.summary_line()
    assert led.device_peak() == jled.device_peak() == 21
    led.save(str(tmp_path / "t.json"))
    jled.save(str(tmp_path / "j.json"))
    assert j_memory.MemoryLedger.load(str(tmp_path / "t.json")) == jled
    assert memory.MemoryLedger.load(str(tmp_path / "j.json")) == led


def test_cpu_runs_report_no_device_numbers():
    sp = convert.bcsr(planted(), device="cpu")
    assert memory.device_watermark("cpu") is None
    assert memory.device_watermark(None) is None
    assert memory.measure_mu_memory(sp, [2, 3]) == {}
    host = memory.read_host_memory()
    assert host["rss_bytes"] > 0 and host["hwm_bytes"] >= host["rss_bytes"]


# ---------------------------------------------------------------------------
# Traced CLI runs pass the unchanged scripts/check_trace.py
# ---------------------------------------------------------------------------

def sparse_npz(path: Path, n=128, m=2, bs=16, per=40, seed=0) -> Path:
    """A small COO file whose stored blocks are a few of the nb^2 (the
    diagonal and three more), so the BCSR is smaller than the dense
    tensor it represents."""
    rng = np.random.default_rng(seed)
    blocks = [(i, i) for i in range(n // bs)] + [(0, 3), (2, 5), (6, 1)]
    row = np.concatenate([bi * bs + rng.integers(0, bs, per)
                          for bi, _ in blocks])
    col = np.concatenate([bj * bs + rng.integers(0, bs, per)
                          for _, bj in blocks])
    np.savez(path, row=row, rel=rng.integers(0, m, row.size), col=col,
             val=rng.uniform(0.5, 1.5, row.size).astype(np.float32))
    return path


SWEEP_ARGS = ["--bs", "16", "--k-min", "2", "--k-max", "3", "--r", "3",
              "--iters", "10"]


@pytest.fixture(scope="module")
def traced_sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traced")
    data = sparse_npz(tmp / "x.npz")
    res, rep = rescalk_run.main([
        "--device", "cpu", "--data", str(data), *SWEEP_ARGS,
        "--use-fused-kernel", "--sanitize", "--trace", str(tmp / "tr"),
        "--report", str(tmp / "r.json")])
    return tmp, res, rep


def test_traced_sweep_passes_check_trace(traced_sweep):
    tmp, res, rep = traced_sweep
    out = check_trace(tmp / "tr", "--report", tmp / "r.json",
                      "--expect-metrics", "--expect-memory")
    assert out.returncode == 0, out.stdout
    assert "0 compile events" in out.stdout
    names = {p.name for p in (tmp / "tr").iterdir()}
    assert names == {"trace.jsonl", "trace_chrome.json", "metrics.npz",
                     "summary.txt", "memory.json"}
    with np.load(tmp / "tr" / "metrics.npz") as d:
        assert d["core.sparse.sparse_mu_step.rel_error"].shape == (60,)
    led = json.loads((tmp / "tr" / "memory.json").read_text())
    assert led["runtime"]["peak_device_bytes"] is None
    assert led["runtime"]["peak_host_bytes"] > 0
    assert led["per_k"] == {} and led["fallbacks"] == {"count": 0}
    assert all(u.peak_host_bytes > 0 and u.peak_device_bytes is None
               for u in rep.units)
    summary = (tmp / "tr" / "summary.txt").read_text()
    for word in ("sched/execute", "ingest/npz", "ingest/blockify",
                 "sched/reduce", "compile events: 0", "xla_GF",
                 "memory ledger (bcsr)"):
        assert word in summary


def test_traced_sweep_metrics_match_repro_cli_layout(traced_sweep):
    """repro's CLI on the same file and flags writes a metrics.npz of the
    same keys and shapes (its draws differ, so its values do)."""
    tmp, _, _ = traced_sweep
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.rescalk_run", "--data",
         str(tmp / "x.npz"), *SWEEP_ARGS, "--trace", str(tmp / "jtr"),
         "--report", str(tmp / "jr.json")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with np.load(tmp / "tr" / "metrics.npz") as t, \
            np.load(tmp / "jtr" / "metrics.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert {k: t[k].shape for k in t.files} == \
            {k: j[k].shape for k in j.files}


def test_traced_dense_grid_sweep_passes_check_trace(tmp_path):
    """The CLI's default path (the synthetic dense tensor), cross-k grid
    mode in chunks: chunk units, masked-step metrics, dense ledger."""
    rescalk_run.main(["--device", "cpu", "--n", "32", "--m", "2",
                      "--k-true", "2", "--k-min", "2", "--k-max", "3",
                      "--r", "2", "--iters", "5", "--mode", "grid",
                      "--grid-chunk", "2", "--trace", str(tmp_path / "tr"),
                      "--report", str(tmp_path / "r.json")])
    out = check_trace(tmp_path / "tr", "--report", tmp_path / "r.json",
                      "--expect-metrics", "--expect-memory")
    assert out.returncode == 0, out.stdout
    with np.load(tmp_path / "tr" / "metrics.npz") as d:
        assert d["core.rescal.masked_mu_step.rel_error"].shape == (20,)
        assert d["core.rescal.masked_mu_step.step"].shape == (20,)


@pytest.mark.parametrize("spec,kind", [
    ("virtual:bcsr:n=512,m=2,k=3,bs=32,density=0.1,seed=0", "bcsr"),
    ("virtual:bcsr:n=512,m=2,k=3,bs=32,density=0.1,grid=2,seed=0",
     "bcsr-sharded"),
])
def test_traced_virtual_sweep_passes_check_trace(tmp_path, spec, kind):
    """--trace on a virtual spec: a grid-2 layout's manifest keeps its
    bcsr-sharded kind in memory.json, the per-rank bytes and the cost
    table run on the merged BCSR, and check_trace.py passes."""
    rescalk_run.main(["--device", "cpu", "--data", spec, "--k-min", "2",
                      "--k-max", "3", "--r", "2", "--iters", "5",
                      "--trace", str(tmp_path / "tr"),
                      "--report", str(tmp_path / "r.json")])
    out = check_trace(tmp_path / "tr", "--report", tmp_path / "r.json",
                      "--expect-metrics", "--expect-memory")
    assert out.returncode == 0, out.stdout
    ledger = json.loads((tmp_path / "tr" / "memory.json").read_text())
    assert ledger["ledger"]["kind"] == kind
    assert ledger["ledger"]["compression"] > 1.0


def test_traced_serve_passes_check_trace(traced_sweep, tmp_path):
    tmp, _, _ = traced_sweep
    out = serve.main(["--device", "cpu", "--factors", str(tmp / "r.bundle"),
                      "--queries", "random:200", "--requests", "5",
                      "--batch", "16", "--trace", str(tmp_path / "st")])
    res = check_trace(tmp_path / "st")
    assert res.returncode == 0, res.stdout
    events = [json.loads(line) for line in
              (tmp_path / "st" / "trace.jsonl").read_text().splitlines()]
    begins = [e["name"] for e in events if e["ph"] == "B"]
    assert begins.count("serve/request") == 5
    assert begins.count("serve/score") == out.stats["batches"] > 0
    caches = [e for e in events if e["name"] == "serve/cache"]
    assert len(caches) == 5
    assert caches[-1]["args"]["hits"] == out.stats["hits"]


@pytest.mark.parametrize("traced", [False, True])
def test_reload_hashes_again_only_when_traced(tmp_path, monkeypatch, traced):
    """The serve/reload instant carries the new bundle's digest; untraced,
    nothing hashes the factors beyond the load's own check (one digest)."""
    from repro_torch.serve import FactorBundle, ServeConfig, ServeEngine
    rng = np.random.default_rng(0)
    A, R = rng.random((40, 3), dtype=np.float32), rng.random(
        (2, 3, 3), dtype=np.float32)
    engine = ServeEngine(FactorBundle(A=A, R=R), ServeConfig(topk=4),
                         device="cpu")
    FactorBundle(A=A[:30], R=R).save(str(tmp_path / "new"))
    hashed = []
    real_digest = FactorBundle.digest
    monkeypatch.setattr(FactorBundle, "digest",
                        lambda self: hashed.append(1) or real_digest(self))
    tracer = obs.Tracer(None) if traced else None
    prev = obs.install(tracer)
    try:
        assert engine.reload(str(tmp_path / "new")).n == 30
    finally:
        obs.install(prev)
    assert len(hashed) == 1 + int(traced)
    if traced:
        events = [e for e in tracer.events if e["name"] == "serve/reload"]
        assert [e["ph"] for e in events] == ["B", "i", "E"]
        assert events[1]["args"]["digest"] == real_digest(
            FactorBundle.load(str(tmp_path / "new")))


# ---------------------------------------------------------------------------
# Spans inside the MU engine, its collectives and the ensemble
# ---------------------------------------------------------------------------

def span_tree(events):
    """The closed spans as nested (name, args, children) in record order;
    args are the closing record's."""
    root, stack = [], []
    for e in events:
        if e["ph"] == "B":
            node = [e["name"], None, []]
            (stack[-1][2] if stack else root).append(node)
            stack.append(node)
        elif e["ph"] == "E":
            node = stack.pop()
            assert node[0] == e["name"]
            node[1] = e["args"]
    assert not stack
    return root


def shape_of(node):
    """(name, children's shapes), collectives as "grid"."""
    name, _, kids = node
    return (name, tuple(shape_of(k) for k in kids))


GRID2 = (("grid/all-reduce", ()),) * 2


def expected_iter(kind: str, schedule: str, m: int):
    if schedule == "batched":
        kids = (("mu/gram", GRID2), ("mu/products", ()),
                ("mu/r_update", GRID2), ("mu/a_update", GRID2))
    else:
        one = ("mu/slice", (("mu/products", ()), ("mu/r_update", GRID2),
                            ("mu/a_update", GRID2)))
        # the sliced BCSR body tiles its operands once, before the slices
        tiles = (("mu/products", ()),) if kind == "bcsr" else ()
        kids = ((("mu/gram", GRID2),) + tiles + (one,) * m
                + (("mu/a_update", ()),))
    return ("mu/iter", kids)


def record_grid():
    from repro_torch.dist.sharding import Grid
    return Grid.at_rank(0, 1, 1, 1, "cpu", record=True)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", ["batched", "sliced"])
@pytest.mark.parametrize("kind", ["dense", "bcsr"])
def test_mu_iteration_span_tree(kind, schedule, fused):
    """One iteration of each engine body: mu/iter over the four phases
    (per slice in the sliced bodies), every collective a grid/* span
    inside a phase, and the closing record's collective count 6 (batched)
    or 2 + 4m (sliced)."""
    from repro_torch.dist.engine import DistRescalConfig, get_mu_iter
    from repro_torch.kernels.policy import KernelPolicy
    X = flag_operand(kind)
    m = X.m if kind == "bcsr" else X.shape[-3]
    n = X.n if kind == "bcsr" else X.shape[-1]
    g = torch.Generator().manual_seed(0)
    A = torch.rand(n, 3, generator=g)
    R = torch.rand(m, 3, 3, generator=g)
    cfg = DistRescalConfig(schedule=schedule,
                           kernel=KernelPolicy(use_fused=fused))
    grid = record_grid()
    with obs.tracing() as tr:
        A1, R1 = get_mu_iter(kind, schedule)(grid, X, A, R, cfg)
    tree = span_tree(tr.events)
    assert [shape_of(node) for node in tree] == [
        expected_iter(kind, schedule, m)]
    args = tree[0][1]
    assert args["collectives"] == (6 if schedule == "batched" else 2 + 4 * m)
    assert args["collectives"] == grid.collectives
    if schedule == "sliced":
        slices = [k for k in tree[0][2] if k[0] == "mu/slice"]
        assert [s[1]["t"] for s in slices] == list(range(m))
    # tracing changes no number
    A0, R0 = get_mu_iter(kind, schedule)(record_grid(), X, A, R, cfg)
    torch.testing.assert_close(A1, A0, rtol=0, atol=0)
    torch.testing.assert_close(R1, R0, rtol=0, atol=0)


@pytest.mark.parametrize("schedule,m", [("sliced", 3), ("sliced", 5),
                                        ("batched", 3)])
def test_bcsr_iteration_tiles_its_operands_twice(monkeypatch, schedule, m):
    """A fused BCSR iteration lays A^(j) and A^(i) out for bcsr_xa_xta
    twice, whatever m: the batched body in its one call, the sliced body
    once before its m calls (2m when each call tiles its own).  The
    closing mu/iter record's ``tilings`` says so; a plain policy tiles
    nothing."""
    from repro_torch.dist import engine
    from repro_torch.kernels.policy import KernelPolicy
    X = tsparse.random_bcsr(np.random.default_rng(m), m=m, n=48, bs=16,
                            block_density=0.3, device="cpu")
    g = torch.Generator().manual_seed(m)
    A, R = torch.rand(48, 3, generator=g), torch.rand(m, 3, 3, generator=g)
    body = engine.get_mu_iter("bcsr", schedule)

    def tilings(fused: bool):
        cfg = engine.DistRescalConfig(schedule=schedule,
                                      kernel=KernelPolicy(use_fused=fused))
        with obs.tracing() as tr:
            out = body(record_grid(), X, A, R, cfg)
        return span_tree(tr.events)[0][1]["tilings"], out

    got, (A1, R1) = tilings(True)
    assert got == 2
    assert tilings(False)[0] == 0
    monkeypatch.setattr(engine, "prepare_products", lambda *a, **k: None)
    got, (A0, R0) = tilings(True)
    assert got == (2 * m if schedule == "sliced" else 2)
    assert torch.equal(A1, A0) and torch.equal(R1, R0)


def test_untraced_spans_open_no_profiler_range(monkeypatch):
    """No tracer: every span is the shared null context and the profiler
    range is never entered; with one, each span enters it once."""
    from repro_torch.dist.engine import DistRescalConfig, get_mu_iter
    calls = []
    real = obs._open_range
    monkeypatch.setattr(obs, "_open_range",
                        lambda name: calls.append(name) or real(name))
    X = flag_operand("dense")
    A, R = torch.rand(X.shape[-1], 3), torch.rand(X.shape[-3], 3, 3)
    step = get_mu_iter("dense", "sliced")
    assert obs.current() is None
    assert obs.span("mu/iter") is obs._NULL
    with obs.span("mu/iter") as closing:
        assert closing is None
    step(record_grid(), X, A, R, DistRescalConfig(schedule="sliced"))
    assert calls == []
    with obs.tracing() as tr:
        step(record_grid(), X, A, R, DistRescalConfig(schedule="sliced"))
    assert calls == [e["name"] for e in tr.events if e["ph"] == "B"]


def test_spans_are_profiler_user_annotations():
    """Under torch.profiler on the CPU the program's spans are user
    annotations of the same names; with no profiler recording, a traced
    span opens no range."""
    from repro_torch.dist.engine import DistRescalConfig, get_mu_iter
    X = flag_operand("bcsr")
    A, R = torch.rand(X.n, 3), torch.rand(X.m, 3, 3)
    step = get_mu_iter("bcsr", "batched")
    with obs.tracing() as tr:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(record_grid(), X, A, R, DistRescalConfig())
    names = [e["name"] for e in tr.events if e["ph"] == "B"]
    annotated = [ev.name() for ev in prof.profiler.kineto_results.events()
                 if ev.is_user_annotation()]
    assert sorted(annotated) == sorted(names)
    assert {"mu/iter", "mu/gram", "mu/products", "mu/r_update",
            "mu/a_update", "grid/all-reduce"} <= set(annotated)
    assert obs._open_range("mu/iter") is None


def test_select_path_spans(tmp_path, monkeypatch):
    """A sweep on the (recording) 1 x 1 grid: each unit's member pipeline
    is ens/perturb, ens/mu (holding the MU iterations), ens/normalize and
    ens/errors; each rank's reduction is reduce/cluster,
    reduce/silhouettes, reduce/regress and reduce/error.  The trace file
    is written at the end of each unit (after its reduction)."""
    X = flag_operand("dense")
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2, rescal_iters=2,
                        regress_iters=2)
    flushed = []
    real_flush = obs.Tracer.flush

    def flush(tracer):
        flushed.append(tracer.events[-1])
        real_flush(tracer)

    with obs.tracing(str(tmp_path)) as tr:
        monkeypatch.setattr(obs.Tracer, "flush", flush)
        SweepScheduler(cfg, mode="batched", grid=record_grid()).run(X)
        monkeypatch.setattr(obs.Tracer, "flush", real_flush)
    assert [(e["ph"], e["name"]) for e in flushed] == \
        [("E", "sched/reduce")] * 2
    tree = span_tree(tr.events)
    execs = [n for n in tree if n[0] == "sched/execute"]
    reduces = [n for n in tree if n[0] == "sched/reduce"]
    assert len(execs) == len(reduces) == 2
    for node in execs:
        kids = node[2]
        assert [k[0] for k in kids] == ["ens/perturb", "ens/mu",
                                        "ens/normalize", "ens/errors"]
        assert [k[0] for k in kids[1][2]] == ["mu/iter"] * 2
    for node in reduces:
        assert [k[0] for k in node[2]] == [
            "reduce/cluster", "reduce/silhouettes", "reduce/regress",
            "reduce/error"]


def test_tracer_writes_in_batches(tmp_path, monkeypatch):
    """The file holds the records up to the last flush (and every
    FLUSH_EVERY records); close writes the rest, equal to the records in
    memory."""
    monkeypatch.setattr(obs, "FLUSH_EVERY", 8)
    path = tmp_path / "trace.jsonl"

    def on_disk():
        return [json.loads(line) for line in path.read_text().splitlines()]

    tr = obs.Tracer(str(tmp_path))
    assert len(on_disk()) == 1            # the anchor record
    with tr.span("mu/iter"):
        tr.event("kernel/fallback")
    assert len(on_disk()) == 1
    with tr.span("sched/execute", uid="u"):
        with tr.span("mu/iter"):
            pass
    assert len(on_disk()) == 1            # a span's close writes nothing
    tr.flush()
    assert on_disk() == tr.events
    n = len(tr.events)
    for _ in range(3):
        with tr.span("grid/all-reduce"):
            pass
    assert len(on_disk()) == n            # 6 records pending, under 8
    with tr.span("grid/all-reduce"):
        pass
    assert len(on_disk()) == n + 8        # the 8th record wrote them all
    tr.event("serve/cache")
    tr.close()
    assert on_disk() == tr.events


def test_tracer_flush_keeps_records_appended_during_it(tmp_path):
    """A record that another thread (the host-memory sampler) appends
    while a flush writes is not counted as written: the next flush or
    close writes it, and the file equals the records in memory."""
    import threading
    tr = obs.Tracer(str(tmp_path))
    with tr.span("sched/execute", uid="u"):
        pass
    real = tr._file

    class Racing:
        """The file, with one record appended from a second thread
        during the first write."""
        fired = False

        def write(self, text):
            if not self.fired:
                self.fired = True
                t = threading.Thread(target=tr.event,
                                     args=("mem/sample",),
                                     kwargs={"rss_bytes": 1})
                t.start()
                t.join()
            return real.write(text)

        def flush(self):
            real.flush()

        def close(self):
            real.close()

    tr._file = Racing()
    n = len(tr.events)
    tr.flush()
    assert len(tr.events) == n + 1 and tr._written == n
    tr.close()
    on_disk = [json.loads(line) for line in
               (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert on_disk == tr.events
    assert on_disk[-1]["name"] == "mem/sample"
