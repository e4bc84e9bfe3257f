"""The port's CLI end to end on the CPU, and the port's import rules."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import rescalk_run

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def write_npz(path, n=70, m=2, k=3, seed=0):
    """A planted rank-k COO tensor: entities in k communities, links
    within and between linked communities, values from A R A^T."""
    rng = np.random.default_rng(seed)
    comm = np.arange(n) * k // n
    A = np.zeros((n, k))
    A[np.arange(n), comm] = rng.uniform(0.5, 1.0, n)
    R = rng.uniform(0.1, 1.0, (m, k, k))
    rel, row, col = np.nonzero(np.einsum("ia,mab,jb->mij", A, R, A) > 0)
    keep = rng.random(rel.shape[0]) < 0.6
    rel, row, col = rel[keep], row[keep], col[keep]
    val = np.einsum("ea,eab,eb->e", A[row], R[rel], A[col])
    np.savez(path, row=row, rel=rel, col=col, val=val.astype(np.float32))
    return path


def test_cli_end_to_end_on_cpu(tmp_path, capsys):
    data = write_npz(tmp_path / "x.npz")
    report = tmp_path / "report.json"
    res, rep = rescalk_run.main(
        ["--data", str(data), "--bs", "32", "--k-min", "2", "--k-max", "4",
         "--r", "3", "--iters", "30", "--use-fused-kernel",
         "--report", str(report), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"selected k_opt = {res.k_opt}" in out
    assert out.count("[sweep] k=") == 3
    saved = json.loads(report.read_text())
    assert saved["k_opt"] == res.k_opt and saved["ks"] == [2, 3, 4]
    assert len(saved["units"]) == 3 and saved["meta"]["device"] == "cpu"
    assert np.isfinite(res.rel_err).all()
    assert all((r.A_median >= 0).all() for r in res.per_k.values())
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("spec,kind", [
    ("virtual:bcsr:n=256,m=2,k=3,bs=32,density=0.25,seed=2", "bcsr"),
    ("virtual:bcsr:n=256,m=2,k=3,bs=32,density=0.25,grid=2,seed=2",
     "bcsr-sharded"),
    ("virtual:dense:n=48,m=2,k=3,grid=2,seed=1", "dense"),
])
def test_cli_virtual_spec_end_to_end_on_cpu(tmp_path, capsys, spec, kind):
    """--data virtual:...: repro's [io] line (the same manifest: the
    pattern is repro's), the sweep, the report and the bundle, whose
    manifest is the operand's (a grid = 1 spec collapses to one BCSR)."""
    from repro import io as jio
    from repro_torch.serve import FactorBundle
    report = tmp_path / "r.json"
    res, rep = rescalk_run.main(
        ["--data", spec, "--k-min", "2", "--k-max", "3", "--r", "2",
         "--iters", "20", "--use-fused-kernel", "--report", str(report),
         "--device", "cpu"])
    out = capsys.readouterr().out
    man = jio.manifest_of(jio.VirtualSpec.parse(spec))
    assert (f"[io] {man.kind} logical {man.logical_bytes / 2**30:.2f} GiB "
            f"-> resident {man.resident_bytes / 2**30:.3f} GiB "
            f"({man.compression:.0f}x)") in out
    assert "generated on cpu" in out
    assert f"selected k_opt = {res.k_opt}" in out
    saved = json.loads(report.read_text())
    assert saved["k_opt"] == res.k_opt and saved["ks"] == [2, 3]
    bundle = FactorBundle.load(saved["meta"]["bundle"])
    assert bundle.manifest["kind"] == kind
    assert bundle.n == 256 if kind != "dense" else bundle.n == 48
    assert np.isfinite(res.rel_err).all()


def test_cli_refuses_unknown_data(tmp_path):
    with pytest.raises(SystemExit, match="virtual:"):
        rescalk_run.main(["--data", str(tmp_path / "x.csv"),
                          "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown virtual spec field"):
        rescalk_run.main(["--data", "virtual:bcsr:n=64,m=1,k=2,zap=1",
                          "--device", "cpu"])


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    data = write_npz(tmp_path / "x.npz")
    with pytest.raises(RuntimeError, match="--device cpu"):
        rescalk_run.main(["--data", str(data), "--bs", "32"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        rescalk_run.main(["--data", "virtual:bcsr:n=256,m=2,k=3,bs=32"])


def test_cli_flags_match_repro_meanings():
    from repro.launch.rescalk_run import build_parser as repro_parser
    ours = rescalk_run.build_parser()
    theirs = repro_parser()
    mine = {a.dest: a for a in ours._actions}
    for dest in ("bs", "k_min", "k_max", "r", "iters", "criterion",
                 "report", "use_fused_kernel", "trace", "sanitize",
                 "ckpt_dir", "stop_after_units", "max_retries",
                 "retry_base_delay", "unit_deadline", "fault_plan",
                 "async_ckpt"):
        theirs_action = next(a for a in theirs._actions if a.dest == dest)
        assert mine[dest].default == theirs_action.default, dest
        assert mine[dest].type == theirs_action.type, dest
        assert mine[dest].option_strings == theirs_action.option_strings
    assert mine["device"].default == "cuda"
    # repro's CLI defines no flag the port lacks, apart from the mesh-free
    # dry-run knobs it never had
    assert {a.dest for a in theirs._actions} <= set(mine)


def test_port_imports_neither_jax_nor_repro(tmp_path):
    """Import every repro_torch module in a fresh interpreter: no jax, no
    repro (repro_torch itself is not a hit), no kernel build, and no
    process group."""
    code = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
from repro_torch.kernels import _build
import torch.distributed as dist
print(json.dumps({"modules": len(names), "bad": bad,
                  "built": _build.library.cache_info().currsize,
                  "groups": dist.is_available() and dist.is_initialized()}))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert got["modules"] >= 103
    assert got["bad"] == []
    assert got["built"] == 0
    assert got["groups"] is False


def test_cli_interrupt_resume_and_retry_on_cpu(tmp_path, capsys):
    """--stop-after-units prints repro's [sweep] line and returns; the
    resume with --ckpt-dir reuses the unit and equals an uninterrupted
    run; --fault-plan's transient fault is retried under --max-retries."""
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    spec = "virtual:bcsr:n=256,m=2,k=3,bs=32,density=0.25,seed=2"
    base = ["--data", spec, "--k-min", "2", "--k-max", "3", "--r", "2",
            "--iters", "8", "--use-fused-kernel", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    assert rescalk_run.main(
        base + ["--ckpt-dir", ck, "--stop-after-units", "1"]) == (None, None)
    out = capsys.readouterr().out
    assert ("[sweep] sweep interrupted after 1 computed units (1/2 done; "
            "rerun with the same ckpt_dir to resume)") in out
    assert "selected k_opt" not in out
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-transient", at=(0,))]}).save(
            str(tmp_path / "plan.json"))
    res, rep = rescalk_run.main(
        base + ["--ckpt-dir", ck, "--fault-plan", plan,
                "--retry-base-delay", "0.001", "--async-ckpt",
                "--report", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "[faults] " in out and "[retry] unit_k3_q0-1 attempt 1" in out
    assert [(u.reused, u.attempts) for u in rep.units] == [(True, 0),
                                                           (False, 2)]
    assert rep.meta["n_retries"] == 1 and faults.current() is None
    fresh, _ = rescalk_run.main(base)
    assert fresh.k_opt == res.k_opt
    np.testing.assert_array_equal(fresh.s_min, res.s_min)
    np.testing.assert_array_equal(fresh.rel_err, res.rel_err)
    with pytest.raises(faults.TransientError):
        rescalk_run.main(base + ["--fault-plan", plan, "--max-retries", "0"])


def test_chaos_drill_passes_on_cpu(tmp_path):
    """scripts/torch_chaos_drill.py at repro's drill size (n=512, m=2,
    k=3, bs=128, density 0.02, k = 2..3, r = 2, 10 iterations): every
    phase's report passes the unchanged scripts/check_trace.py, and the
    drill exits 0."""
    drill = os.path.join(SRC, "..", "scripts", "torch_chaos_drill.py")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, drill, "--device", "cpu", "--workdir",
         str(tmp_path / "drill")], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "[chaos-drill] OK" in out.stdout
    summary = json.loads(out.stdout.split("[chaos-drill] summary ")[1]
                         .splitlines()[0])
    assert summary["kill_reused"] == 1 and summary["kill_units"] == 2
    assert summary["overflow_attempts"] == 1
    for phase in ("phase0", "phase2", "phase3b", "phase5", "phase6b"):
        assert (tmp_path / "drill" / f"{phase}.log").exists()
