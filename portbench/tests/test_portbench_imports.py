"""A cell's run loads no module whose top-level name (before the first
dot, compared whole) is ``jax``, ``jaxlib``, ``flax``, ``repro`` or
``chip_smoke``; ``portbench/reference/`` imports nothing of the program;
and ``run.py`` prints no result without a card."""
import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT

from portbench.harness.cell import FORBIDDEN

TESTS = ROOT / "portbench" / "tests"
REFERENCE = ROOT / "portbench" / "reference"

RUN_SMALL = f"""
import json, sys, time
sys.path[:0] = [{str(TESTS)!r}, {str(ROOT)!r}, {str(ROOT / 'src')!r}]
from conftest import small_config
from portbench.harness import cell, spec
bench = spec.load_benchmark()
name = sys.argv[1]
cfg = small_config(spec.workload(bench, name)["config"])
out = cell.run_cell(bench, name, 3, 0.2, bool(int(sys.argv[2])), "cpu",
                    time.perf_counter(), config=cfg)
print(json.dumps({{"correct": out["correct"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["dense3tb.mu", "sparseeb.mu",
                                  "dense3tb.select"])
def test_cell_run_loads_no_forbidden_module(name, trace):
    out = subprocess.run([sys.executable, "-c", RUN_SMALL, name, str(trace)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["top"]) & set(FORBIDDEN)
    # the port's name begins with the JAX package's: compared whole
    assert "repro_torch" in got["top"]


def imports_of(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {top_level(n) for n in names}


def test_reference_imports_nothing_of_the_program():
    for path in sorted(REFERENCE.glob("*.py")):
        assert not imports_of(path) & {"repro_torch", *FORBIDDEN}, path
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import portbench.reference.mu, portbench.reference.sweep; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(ast.literal_eval(out.stdout))
    assert not loaded & {"repro_torch", *FORBIDDEN}


def test_forbidden_names_are_compared_whole():
    import types

    from portbench.harness import cell
    import repro_torch  # noqa: F401  (loaded, and not the JAX package)
    assert cell.forbidden_modules() == []
    sys.modules["repro.fake"] = types.ModuleType("repro.fake")
    try:
        assert cell.forbidden_modules() == ["repro.fake"]
    finally:
        del sys.modules["repro.fake"]


def test_run_without_a_card_prints_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "dense3tb.mu", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
