"""cuda-kernel: every CUDA launcher has one wrapper, checked, counted,
twinned and driven on the card (the counterpart of ``repro``'s
``pallas-kernel``).

The port's kernels are ``extern "C"`` launchers in ``kernels/csrc/*.cu``,
loaded by ``kernels/_build.library()``.  For each launcher the rule
checks that

  * it is reached from exactly one module of ``kernels/`` as
    ``_build.library().<launcher>``, called there or bound to a name
    first (``lib = _build.library()`` then ``lib.<launcher>`` counts
    too); an attribute of the library that no ``.cu`` declares is an
    error.  "Reached from no module" is judged only when every module of
    that ``kernels/`` directory is linted;
  * the function that reaches it also calls ``_build.check(...)``, which
    raises on the launch's CUDA error code;
  * no ``try`` with an ``except`` encloses the launcher's access or the
    check in that function: a kernel that fails raises, it never falls
    back to its plain version in silence (``try``/``finally`` is fine);
  * the module defines ``launch_count`` and ``reset_launch_count`` and
    imports a ``ref_*`` plain twin from ``kernels/ref.py``;
  * ``chip_smoke.py`` (the first one found above the ``kernels/``
    directory, read as text, never imported) names the wrapper: the
    public function that reaches the launcher, or the public functions
    of the module that call the private one that does.

And in every file: a Triton ``tl.dot`` must pass
``input_precision="ieee"`` — the port's fp32 products are true fp32,
never TF32 (``device.strict_fp32``).

``pallas-kernel``'s other checks have no counterpart: a CUDA kernel
indexes its buffers with plain integers (the int-index idiom is a Pallas
lowering's), and ``nvcc``'s flags are fixed in ``_build.py`` for every
kernel (no per-call compiler-params class to route).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Set

from ..framework import (ERROR, Finding, Rule, dotted, ends_with,
                         enclosing_function, functions, parent, register,
                         resolve_alias)

ENTRY_RE = re.compile(
    r'extern\s+"C"\s+(?:[A-Za-z_][\w:<>]*[\s*&]+)+?([A-Za-z_]\w*)\s*\(')
LIBRARY = "_build.library"
CHECK = "_build.check"
COUNTERS = ("launch_count", "reset_launch_count")
SMOKE = "chip_smoke.py"


def entries(csrc: Path) -> Dict[str, tuple]:
    """launcher name -> (.cu path, line) of every ``extern "C"`` entry."""
    out: Dict[str, tuple] = {}
    for cu in sorted(csrc.glob("*.cu")):
        text = cu.read_text()
        for m in ENTRY_RE.finditer(text):
            out.setdefault(m.group(1),
                           (cu, text.count("\n", 0, m.start()) + 1))
    return out


def calls_to(tree: ast.AST, aliases, suffix: str) -> List[ast.Call]:
    """The calls in ``tree`` of a dotted name ending with ``suffix``
    (``_build.library``, through any alias)."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and ends_with(resolve_alias(dotted(n.func), aliases), suffix)]


def _in_try(node: ast.AST, fn) -> bool:
    """True when a ``try`` with handlers in ``fn`` has ``node`` in its
    body."""
    child, p = node, parent(node)
    while p is not None and p is not fn:
        if isinstance(p, ast.Try) and p.handlers and child in p.body:
            return True
        child, p = p, parent(p)
    return False


class _Access:
    """One ``<library>.<launcher>`` in a kernel module."""

    def __init__(self, src, fn, node: ast.Attribute):
        self.src, self.fn, self.node = src, fn, node
        self.launcher = node.attr


def _accesses(src, aliases) -> List[_Access]:
    out = []
    for fn in functions(src.nodes):
        libs = calls_to(fn, aliases, LIBRARY)
        bound = {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and n.value in libs for t in n.targets
                 if isinstance(t, ast.Name)}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute):
                continue
            v = node.value
            if v in libs or (isinstance(v, ast.Name) and v.id in bound):
                if enclosing_function(node) is fn:
                    out.append(_Access(src, fn, node))
    return out


def _wrappers(tree: ast.Module, fn) -> Set[str]:
    """The public functions of the module that are, or reach through
    plain-name calls, ``fn``."""
    top = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if not fn.name.startswith("_") and top.get(fn.name) is fn:
        return {fn.name}
    out = set()
    for name, node in top.items():
        if name.startswith("_"):
            continue
        seen, frontier = set(), [name]
        while frontier:
            cur = frontier.pop()
            if cur in seen or cur not in top:
                continue
            seen.add(cur)
            frontier += [c.func.id for c in ast.walk(top[cur])
                         if isinstance(c, ast.Call)
                         and isinstance(c.func, ast.Name)]
        if fn.name in seen:
            out.add(name)
    return out


def _find_smoke(kernels_dir: Path):
    for d in kernels_dir.resolve().parents:
        if (d / SMOKE).is_file():
            return d / SMOKE
    return None


@register
class CudaKernel(Rule):
    name = "cuda-kernel"
    description = ("each CUDA launcher: one wrapper module, _build.check, "
                   "no try/except fallback, launch counters, a ref_* "
                   "twin, named by chip_smoke.py; tl.dot in ieee")

    def check_file(self, src, ctx):
        aliases = src.aliases
        for call in src.nodes:
            if not (isinstance(call, ast.Call) and ends_with(
                    resolve_alias(dotted(call.func), aliases),
                    "triton.language.dot")):
                continue
            prec = next((kw.value for kw in call.keywords
                         if kw.arg == "input_precision"), None)
            if not (isinstance(prec, ast.Constant) and prec.value == "ieee"):
                yield Finding(
                    self.name, src.rel, call.lineno, call.col_offset,
                    'tl.dot without input_precision="ieee" rounds fp32 '
                    'operands to TF32 — the port\'s products are true fp32',
                    ERROR)

    def check_project(self, ctx):
        groups: Dict[Path, list] = {}
        for src in ctx.files:
            d = src.path.resolve().parent
            if d.name == "kernels" and (d / "csrc").is_dir():
                groups.setdefault(d, []).append(src)
        for d, srcs in sorted(groups.items()):
            yield from self._check_dir(d, srcs, ctx)

    def _check_dir(self, d: Path, srcs, ctx):
        known = entries(d / "csrc")
        linted = {s.path.resolve() for s in srcs}
        complete = all(p.resolve() in linted for p in d.glob("*.py"))
        smoke = _find_smoke(d)
        smoke_text = smoke.read_text() if smoke else None
        reach: Dict[str, list] = {}
        for src in srcs:
            aliases = src.aliases
            acc = _accesses(src, aliases)
            if not acc:
                continue
            yield from self._check_module(src, aliases, acc, known,
                                          smoke, smoke_text)
            for a in acc:
                if a.launcher in known:
                    reach.setdefault(a.launcher, []).append(a)
        for launcher, (cu, line) in sorted(known.items()):
            sites = reach.get(launcher, [])
            mods = sorted({a.src.rel for a in sites})
            if not mods and complete:
                yield Finding(
                    self.name, ctx.rel(cu), line, 0,
                    f"launcher {launcher} is reached from no module of "
                    f"kernels/ — a kernel with no wrapper is never run",
                    ERROR)
            elif len(mods) > 1:
                for a in sites:
                    yield Finding(
                        self.name, a.src.rel, a.node.lineno,
                        a.node.col_offset,
                        f"launcher {launcher} is reached from "
                        f"{len(mods)} modules ({', '.join(mods)}) — one "
                        f"wrapper owns each kernel and its count", ERROR)

    def _check_module(self, src, aliases, acc, known, smoke, smoke_text):
        for a in acc:
            where = (src.rel, a.node.lineno, a.node.col_offset)
            if a.launcher not in known:
                yield Finding(self.name, *where,
                              f"library attribute {a.launcher!r} is no "
                              f"extern \"C\" launcher of kernels/csrc",
                              ERROR)
                continue
            checks = calls_to(a.fn, aliases, CHECK)
            if not checks:
                yield Finding(
                    self.name, *where,
                    f"'{a.fn.name}' launches {a.launcher} but never "
                    f"passes its return code to _build.check(...) — a "
                    f"refused launch would go unnoticed", ERROR)
            for node in [a.node] + checks:
                if _in_try(node, a.fn):
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        f"try/except around {a.launcher}'s launch or check "
                        f"in '{a.fn.name}' — a failing kernel must raise, "
                        f"not fall back in silence", ERROR)
            names = _wrappers(src.tree, a.fn)
            if smoke_text is None:
                yield Finding(self.name, *where,
                              f"no {SMOKE} above kernels/ to drive "
                              f"{a.launcher} on the card", ERROR)
            elif not any(re.search(rf"\b{re.escape(n)}\b", smoke_text)
                         for n in names):
                yield Finding(
                    self.name, *where,
                    f"{smoke.name} names no wrapper of {a.launcher} "
                    f"({', '.join(sorted(names)) or 'no public function'})"
                    f" — every kernel is checked on the card", ERROR)
        top = {n.name for n in src.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for counter in COUNTERS:
            if counter not in top:
                yield Finding(self.name, src.rel, 1, 0,
                              f"kernel module defines no {counter}() — "
                              f"the main path's launches go uncounted",
                              ERROR)
        if not any(ends_with(full.rsplit(".", 1)[0], "ref")
                   and full.rsplit(".", 1)[-1].startswith("ref_")
                   for full in aliases.values()):
            yield Finding(self.name, src.rel, 1, 0,
                          "kernel module imports no ref_* plain twin from "
                          "kernels/ref.py", ERROR)
