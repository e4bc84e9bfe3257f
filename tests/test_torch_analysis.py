"""repro_torch.analysis: the port's lint against repro's on repro's own
fixtures, each of its seven rules on a bad and a near-miss source, the
rules on mutated copies of the real tree, and the CLI contract.

Expected findings are marked in the sources themselves: every line that
carries ``#!`` (``//!`` in a ``.cu``) must be reported, and no other.
"""
import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import run_lint as repro_run_lint
from repro_torch.analysis import all_rules, run_lint
from repro_torch.analysis.rules import cuda_kernel
from repro_torch.analysis.rules.sanitizer_coverage import mu_functions

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
LINT_CLI = REPO / "scripts" / "torch_rescal_lint.py"

RULES = ("cuda-kernel", "device-isolation", "generator-discipline",
         "host-sync-hazard", "nonneg-sanitizer-coverage",
         "obs-metrics-coverage", "resilience-seam-coverage")


def lint_tree(root, files, rule):
    """Write ``files`` (relative path -> source) under ``root``, lint its
    ``src`` with ``rule`` alone; return (findings, expected) as sets of
    (path, line)."""
    expected = set()
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(text).lstrip("\n")
        p.write_text(text)
        for i, line in enumerate(text.splitlines(), 1):
            if "#!" in line or "//!" in line:
                expected.add((rel, i))
    res = run_lint([root / "src"], root=root, rules=[rule])
    return res, {(f.path, f.line) for f in res.findings}, expected


# ---------------------------------------------------------------------------
# (a) parity with repro.analysis on repro's fixtures and suppressions
# ---------------------------------------------------------------------------

PARITY = {"sanitizer_coverage": "nonneg-sanitizer-coverage",
          "obs_coverage": "obs-metrics-coverage"}


@pytest.mark.parametrize("kind", ["bad", "ok"])
@pytest.mark.parametrize("stem", sorted(PARITY))
def test_parity_with_repro_on_its_fixtures(stem, kind):
    path = FIXTURES / f"{stem}_{kind}.py"
    rule = PARITY[stem]
    ours = run_lint([path], root=REPO, rules=[rule])
    theirs = repro_run_lint([path], root=REPO, rules=[rule])
    assert [(f.rule, f.line) for f in ours.findings] == \
        [(f.rule, f.line) for f in theirs.findings]
    assert bool(ours.findings) == (kind == "bad")


SUPPRESSED = "nonneg-sanitizer-coverage"
STEP = "def mu_step_plain(X, A, R):\n    return A, R\n"
SUPPRESSIONS = {
    "none": (STEP, [(SUPPRESSED, 1)]),
    "trailing": (STEP.replace(
        "R):", "R):  # {p}: disable=" + SUPPRESSED + " -- fixture"), []),
    "standalone": ("# {p}: disable=" + SUPPRESSED + " -- deliberate\n"
                   "# (a continuation comment line)\n" + STEP, []),
    "naked": (STEP.replace("R):", "R):  # {p}: disable=" + SUPPRESSED),
              [("suppression", 1)]),
    "file": ("# {p}: disable-file=" + SUPPRESSED + " -- fixture\n" + STEP,
             []),
    "other-rule": (STEP.replace(
        "R):", "R):  # {p}: disable=obs-metrics-coverage -- wrong rule"),
        [(SUPPRESSED, 1)]),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSIONS))
def test_suppression_grammar_matches_repro(tmp_path, case):
    """The same grammar under each linter's prefix gives the same
    findings, and neither linter reads the other's prefix."""
    template, want = SUPPRESSIONS[case]
    ours_src, theirs_src = tmp_path / "ours.py", tmp_path / "theirs.py"
    ours_src.write_text(template.replace("{p}", "torch-lint"))
    theirs_src.write_text(template.replace("{p}", "rescal-lint"))
    ours = run_lint([ours_src], root=tmp_path, rules=[SUPPRESSED])
    theirs = repro_run_lint([theirs_src], root=tmp_path, rules=[SUPPRESSED])
    got = [(f.rule, f.line) for f in ours.findings]
    assert got == [(f.rule, f.line) for f in theirs.findings] == want
    # the other linter's directive is an ordinary comment to each
    def_line = next(i for i, ln in enumerate(
        theirs_src.read_text().splitlines(), 1) if ln.startswith("def "))
    for crossed in (
            run_lint([theirs_src], root=tmp_path, rules=[SUPPRESSED]),
            repro_run_lint([ours_src], root=tmp_path, rules=[SUPPRESSED])):
        assert [(f.rule, f.line) for f in crossed.findings] == \
            [(SUPPRESSED, def_line)]


# ---------------------------------------------------------------------------
# (b) every rule: its bad source, its near miss
# ---------------------------------------------------------------------------

K = "src/repro_torch/kernels/"
CASES = {
    "nonneg-sanitizer-coverage": ({
        "src/repro_torch/core/steps.py": """
            def mu_step_plain(X, A, R):  #!
                return A, R


            def _mu_iter_grid(grid, X, A, R):  #!
                return A, R


            def make_mu_step(cfg):
                return mu_step_plain
        """}, {
        "src/repro_torch/core/steps.py": """
            from repro_torch.analysis.sanitizer import sanitize_state


            def mu_step_plain(X, A, R, sanitize=False):
                return sanitize_state(A, R, where="x", enabled=sanitize)


            def get_mu_iter(name):
                return mu_step_plain
        """}),
    "obs-metrics-coverage": ({
        "src/repro_torch/core/steps.py": """
            def sparse_mu_step(sp, A, R, trace_metrics=False):  #!
                return A, R


            def build_mu_step(cfg):
                return sparse_mu_step
        """}, {
        "src/repro_torch/core/steps.py": """
            from repro_torch.obs.metrics import record_metrics


            def sparse_mu_step(sp, A, R, trace_metrics=False):
                if trace_metrics:
                    record_metrics("x", a_norm=A.sum())
                return A, R
        """}),
    "resilience-seam-coverage": ({
        "src/repro_torch/resilience/faults.py": """
            SEAMS = (  #!
                "a/once",
                "b/dead",
                "c/twice",
            )


            def probe(seam, **ctx):
                return None
        """,
        "src/repro_torch/user.py": """
            from repro_torch.resilience import faults
            from repro_torch.resilience import faults as _f


            def run(name):
                faults.probe("a/once")
                _f.probe("c/twice")  #!
                faults.probe("c/twice", step=1)  #!
                faults.probe("z/unregistered")  #!
                faults.probe(name)  #!
        """}, {
        "src/repro_torch/resilience/faults.py": """
            SEAMS = ("a/once", "c/twice")


            def probe(seam, **ctx):
                return None
        """,
        "src/repro_torch/user.py": """
            from repro_torch.resilience import faults as _f


            def run(name):
                _f.probe("a/once", path=name)


            def other():
                from repro_torch.resilience import faults
                faults.probe("c/twice")
        """}),
    "generator-discipline": ({
        "src/repro_torch/draws.py": """
            import torch
            from torch import randn as rn


            def draws(n, g, seeds):
                a = torch.rand(n)  #!
                b = rn(n)  #!
                c = torch.empty(n).uniform_(0.0, 1.0)  #!
                d = torch.multinomial(a, 2)  #!
                torch.manual_seed(0)  #!
                torch.cuda.manual_seed_all(0)  #!
                for s in seeds:
                    g.manual_seed(1234)  #!
                    a = a + torch.rand(n, generator=g)
                return a + b + c + d


            def dead(n):
                g = torch.Generator()  #!
                g.manual_seed(n)
                return n
        """}, {
        "src/repro_torch/draws.py": """
            import random

            import torch


            def draws(n, g, seeds, **kw):
                a = torch.rand(n, generator=g)
                b = torch.randn(n, **kw)
                c = torch.empty(n).uniform_(0.0, 1.0, generator=g)
                for s in seeds:
                    g.manual_seed(s)
                    a = a + torch.rand(n, generator=g)
                d = torch.poisson(a, g)
                return a + b + c + d + random.random()


            def live(n):
                g = torch.Generator()
                g.manual_seed(n)
                return torch.rand(n, generator=g)


            def returned(seed):
                return torch.Generator().manual_seed(seed)
        """}),
    "device-isolation": ({
        "src/repro_torch/device.py": """
            import jaxlib  #!
            import torch


            def strict_fp32():
                torch.backends.cuda.matmul.allow_tf32 = False
        """,
        "src/repro_torch/model.py": """
            import importlib

            import jax  #!
            import torch
            from repro.core import rescal  #!
            from torch import backends as tb


            def f():
                torch.backends.cuda.matmul.allow_tf32 = True  #!
                torch.set_float32_matmul_precision("high")  #!
                if torch.__version__ > "2":  #!
                    pass
                v = torch.version.cuda  #!
                has = hasattr(torch, "compile")  #!
                fn = getattr(torch.cuda, "memory_stats", None)  #!
                flag = tb.cudnn.allow_tf32  #!
                mod = importlib.import_module("repro.io")  #!
                try:  #!
                    import triton
                except ImportError:
                    triton = None
                return v, has, fn, flag, triton, mod, rescal, jax
        """}, {
        "src/repro_torch/device.py": """
            import torch


            def strict_fp32():
                torch.backends.cuda.matmul.allow_tf32 = False
        """,
        "src/repro_torch/model.py": """
            import torch

            from repro_torch import device


            def f(cfg):
                device.strict_fp32()
                dt = getattr(torch, cfg.dtype)
                dt2 = getattr(torch, cfg.dtype, None)
                try:
                    x = int(cfg.n)
                except ValueError:
                    x = 0
                return dt, dt2, x
        """}),
    "host-sync-hazard": ({
        "src/repro_torch/core/steps.py": """
            import numpy as np
            import torch


            def helper(A: torch.Tensor):
                return A.sum().item()  #!


            def mu_step_demo(X: torch.Tensor, A, R):
                G = torch.ones(2) * X.sum()
                n = float(G.sum())  #!
                m = int(X.shape[0])
                c = np.asarray(G)  #!
                torch.cuda.synchronize()  #!
                lst = R.tolist()  #!
                return helper(X) + n + m + c + lst
        """,
        K + "wrap.py": """
            import torch

            from . import _build


            def wrapper(x: torch.Tensor, eps: float):
                n = bool(x.any())  #!
                rc = _build.library().repro_k(x.data_ptr(), float(eps))
                _build.check(rc, "k")
                return n
        """}, {
        "src/repro_torch/core/steps.py": """
            import torch


            def mu_step_demo(X: torch.Tensor, A, R, eps: float = 1e-9):
                m = int(X.shape[0]) + int(X.numel()) + X.size(0)
                e = float(eps)
                G = A.T @ A
                return G * e * m


            def report(A: torch.Tensor):
                return A.sum().item()
        """,
        K + "wrap.py": """
            import torch

            from . import _build


            def wrapper(x: torch.Tensor, eps: float, causal: bool):
                rc = _build.library().repro_k(x.data_ptr(), float(eps),
                                              int(causal))
                _build.check(rc, "k")
                return x
        """}),
    "cuda-kernel": ({
        "chip_smoke.py": """
            from repro_torch.kernels import good
            good.good_op
        """,
        K + "csrc/k.cu": """
            extern "C" int repro_good(const float* x, int n, void* s) {
              return 0;
            }
            extern "C" int repro_unchecked(const float* x, void* s) {
              return 0;
            }
            extern "C" int repro_orphan(float* x, void* s) { return 0; }  //!
            extern "C" int repro_shared(void* s) { return 0; }
        """,
        K + "_build.py": """
            def library():
                return None


            def check(rc, name):
                return None
        """,
        K + "ref.py": """
            def ref_good(x):
                return x
        """,
        K + "good.py": """
            from . import _build
            from .ref import ref_good

            _launches = 0


            def launch_count():
                return _launches


            def reset_launch_count():
                return None


            def good_op(x):
                if x.device.type == "cpu":
                    return ref_good(x)
                rc = _build.library().repro_good(x.data_ptr(), 0, None)
                _build.check(rc, "good")
                return x


            def shared_a():
                lib = _build.library()
                rc = lib.repro_shared(None)  #!
                _build.check(rc, "shared")
        """,
        K + "bad.py": """
            from . import _build  #!


            def bad_op(x):
                try:
                    rc = _build.library().repro_unchecked(x, None)  #!
                except RuntimeError:
                    return x
                return rc


            def shared_b():
                rc = _build.library().repro_shared(None)  #!
                _build.check(rc, "shared")


            def typo():
                return _build.library().repro_missing  #!
        """,
        K + "tri.py": """
            def dots(a, b):
                import triton.language as tl
                x = tl.dot(a, b)  #!
                y = tl.dot(a, b, input_precision="tf32")  #!
                return x + y
        """}, {
        "chip_smoke.py": """
            from repro_torch.kernels import good
            good.good_op, good.topk_op
        """,
        K + "csrc/k.cu": """
            extern "C" int repro_good(const float* x, int n, void* s) {
              return 0;
            }
            extern "C" int repro_topk(const float* x, void* s) { return 0; }
        """,
        K + "_build.py": """
            def library():
                return None


            def check(rc, name):
                return None
        """,
        K + "ref.py": """
            def ref_good(x):
                return x
        """,
        K + "good.py": """
            from . import _build
            from .ref import ref_good

            _launches = 0


            def launch_count():
                return _launches


            def reset_launch_count():
                return None


            def good_op(x):
                if x.device.type == "cpu":
                    return ref_good(x)
                lib = _build.library()
                try:
                    rc = lib.repro_good(x.data_ptr(), 0, None)
                finally:
                    x = x
                _build.check(rc, "good")
                return x


            def _launch(x):
                launch = _build.library().repro_topk
                rc = launch(x.data_ptr(), None)
                _build.check(rc, "topk")
                return x


            def topk_op(x):
                return _launch(x)
        """,
        K + "tri.py": """
            def dots(a, b):
                import triton.language as tl
                return tl.dot(a, b, input_precision="ieee")
        """}),
}


def test_every_rule_has_a_case():
    assert set(CASES) == set(RULES) == set(all_rules())


@pytest.mark.parametrize("rule", RULES)
def test_rule_fires_on_bad_source(tmp_path, rule):
    res, got, expected = lint_tree(tmp_path, CASES[rule][0], rule)
    assert expected and got == expected, \
        "\n".join(f.format() for f in res.findings)
    assert {f.rule for f in res.findings} == {rule}


@pytest.mark.parametrize("rule", RULES)
def test_rule_silent_on_near_miss(tmp_path, rule):
    res, got, expected = lint_tree(tmp_path, CASES[rule][1], rule)
    assert not expected
    assert not got, "\n".join(f.format() for f in res.findings)


def test_dead_generator_is_a_warning(tmp_path):
    res, _, _ = lint_tree(tmp_path, CASES["generator-discipline"][0],
                          "generator-discipline")
    assert [f.line for f in res.warnings] == [19]
    assert "dead stream" in res.warnings[0].message


# ---------------------------------------------------------------------------
# the rules on the real tree
# ---------------------------------------------------------------------------

def test_mu_steps_found_on_the_real_tree():
    """Every MU step the sanitizer, telemetry and host-sync rules cover;
    make_mu_step and get_mu_iter are factories."""
    found = set()
    for rel in ("core/rescal.py", "core/sparse.py", "dist/engine.py"):
        tree = ast.parse((PORT / rel).read_text())
        found |= {(rel, fn.name) for fn in mu_functions(ast.walk(tree))}
    assert found == {
        ("core/rescal.py", "mu_step_batched"),
        ("core/rescal.py", "mu_step_sliced"),
        ("core/rescal.py", "masked_mu_step"),
        ("core/sparse.py", "sparse_mu_step"),
        ("core/sparse.py", "masked_sparse_mu_step"),
        ("dist/engine.py", "_mu_iter_batched"),
        ("dist/engine.py", "_mu_iter_sliced"),
        ("dist/engine.py", "_mu_iter_batched_sparse"),
        ("dist/engine.py", "_mu_iter_sliced_sparse"),
    }


def test_every_launcher_has_one_wrapper_on_the_real_tree():
    """The seven extern "C" launchers, each reached from one module."""
    known = cuda_kernel.entries(PORT / "kernels" / "csrc")
    assert sorted(known) == [
        "repro_bcsr_spmm", "repro_bcsr_xa_xta", "repro_flash_attention",
        "repro_flash_attention_sm90", "repro_fused_xa_xtb",
        "repro_mu_update_a", "repro_score_topk"]
    res = run_lint([PORT / "kernels"], root=REPO, rules=["cuda-kernel"])
    assert not res.findings, "\n".join(f.format() for f in res.findings)


# ---------------------------------------------------------------------------
# (c) mutations of the real tree
# ---------------------------------------------------------------------------

def _remove_check(text):
    return text.replace('    _build.check(rc, "bcsr_spmm")\n', "")


def _try_around_launch(text):
    """Wrap bcsr_spmm's `with` block (the launch) in try/except."""
    tree = ast.parse(text)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bcsr_spmm")
    w = next(n for n in fn.body if isinstance(n, ast.With))
    lines = text.splitlines(keepends=True)
    body = ["    " + ln for ln in lines[w.lineno - 1:w.end_lineno]]
    new = (["    try:\n"] + body +
           ["    except RuntimeError:\n",
            "        return ref_bcsr_spmm(sp, B)\n"])
    return "".join(lines[:w.lineno - 1] + new + lines[w.end_lineno:])


def _item_in_step(text):
    anchor = "    G = gram(A)\n"
    start = text.index("def mu_step_batched(")
    at = text.index(anchor, start) + len(anchor)
    return text[:at] + "    scale = G.sum().item()\n" + text[at:]


def _dead_seam(text):
    return text.replace('    "train/step",', '    "train/step",\n'
                        '    "train/new",')


MUTATIONS = {
    "check-removed": ("kernels/bcsr_spmm.py", _remove_check, "cuda-kernel"),
    "try-around-launch": ("kernels/bcsr_spmm.py", _try_around_launch,
                          "cuda-kernel"),
    "item-in-mu-step": ("core/rescal.py", _item_in_step,
                        "host-sync-hazard"),
    "seam-without-probe": ("resilience/faults.py", _dead_seam,
                           "resilience-seam-coverage"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_of_the_real_tree_is_caught(tmp_path, name):
    rel, mutate, rule = MUTATIONS[name]
    shutil.copytree(PORT, tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    copy = tmp_path / "src" / "repro_torch"
    clean = run_lint([copy], root=tmp_path, rules=[rule])
    assert not clean.findings, "\n".join(f.format() for f in clean.findings)
    target = copy / rel
    before = target.read_text()
    target.write_text(mutate(before))
    assert target.read_text() != before
    res = run_lint([copy], root=tmp_path, rules=[rule])
    assert res.errors, f"{rule} missed the mutation {name}"
    assert {f.path for f in res.findings} == {f"src/repro_torch/{rel}"}


# ---------------------------------------------------------------------------
# (d) the CLI
# ---------------------------------------------------------------------------

def run_cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, str(LINT_CLI), *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=120)


def test_cli_port_tree_is_clean_strictly():
    cp = run_cli("--strict", "src/repro_torch")
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert re.search(r"torch-rescal-lint: \d+ files, 0 error\(s\), "
                     r"0 warning\(s\)", cp.stdout)


def test_cli_defaults_to_the_port():
    cp = run_cli("--json")
    assert cp.returncode == 0, cp.stdout + cp.stderr
    out = json.loads(cp.stdout)
    assert out["files_checked"] == len(list(PORT.rglob("*.py")))
    assert out["rules"] == sorted(RULES)


def test_cli_list_rules_names_the_seven():
    cp = run_cli("--list-rules")
    assert cp.returncode == 0
    listed = [ln.split()[0] for ln in cp.stdout.splitlines() if ln.strip()]
    assert listed == sorted(RULES)


def test_cli_bad_source_exits_1(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n\ndef f(n):\n    return torch.rand(n)\n")
    cp = run_cli("--json", str(bad))
    assert cp.returncode == 1, cp.stdout
    out = json.loads(cp.stdout)
    assert [(f["rule"], f["line"]) for f in out["findings"]] == \
        [("generator-discipline", 5)]


@pytest.mark.parametrize("args", [("--rules", "no-such-rule"),
                                  ("does/not/exist",)])
def test_cli_usage_errors_exit_2(args):
    assert run_cli(*args).returncode == 2


def test_cli_warnings_fail_only_under_strict(tmp_path):
    src = tmp_path / "gen.py"
    src.write_text("import torch\n\n\ndef f(n):\n    g = torch.Generator()\n"
                   "    g.manual_seed(n)\n    return n\n")
    assert run_cli(str(src)).returncode == 0
    assert run_cli("--strict", str(src)).returncode == 1


def test_lint_imports_no_torch():
    """The linter is pure stdlib: importing it and listing the rules loads
    neither torch nor numpy nor jax."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.analysis import all_rules; all_rules(); "
            "print(sorted(m for m in ('torch', 'numpy', 'jax', 'repro') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
