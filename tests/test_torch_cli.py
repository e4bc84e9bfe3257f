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


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    data = write_npz(tmp_path / "x.npz")
    with pytest.raises(RuntimeError, match="--device cpu"):
        rescalk_run.main(["--data", str(data), "--bs", "32"])


def test_cli_flags_match_repro_meanings():
    from repro.launch.rescalk_run import build_parser as repro_parser
    ours = rescalk_run.build_parser()
    theirs = repro_parser()
    mine = {a.dest: a for a in ours._actions}
    for dest in ("bs", "k_min", "k_max", "r", "iters", "criterion",
                 "report", "use_fused_kernel"):
        theirs_action = next(a for a in theirs._actions if a.dest == dest)
        assert mine[dest].default == theirs_action.default, dest
    assert mine["device"].default == "cuda"


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
    assert got["modules"] >= 25
    assert got["bad"] == []
    assert got["built"] == 0
    assert got["groups"] is False
