"""nonneg-sanitizer-coverage: every MU step threads the runtime sanitizer
(the counterpart of ``repro``'s rule of the same name).

The paper's §4 multiplicative updates preserve non-negativity *given*
non-negative inputs and a correct eps guard; a single bad kernel breaks
the invariant silently (errors just drift).
``repro_torch.analysis.sanitizer.sanitize_state`` makes the invariant
checkable at run time, but only if every MU-step implementation calls
it.  Any function whose name matches the MU-step pattern (``*mu_step*`` /
``*mu_iter*``, excluding ``make_*`` / ``get_*`` / ``build_*``
factories) must contain a ``sanitize_state(...)`` call.  In the port
these are ``core/rescal.py``'s and ``core/sparse.py``'s steps and
``dist/engine.py``'s grid iterations.
"""
from __future__ import annotations

import ast
import re

from ..framework import ERROR, Finding, Rule, dotted, register

MU_NAME_RE = re.compile(r"(^|_)mu_(step|iter)")
FACTORY_PREFIXES = ("make_", "get_", "build_")
HOOK_NAME = "sanitize_state"


def mu_functions(nodes):
    """The MU-step implementations among a module's ``nodes`` (factories
    excluded)."""
    return [fn for fn in nodes
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and MU_NAME_RE.search(fn.name)
            and not fn.name.startswith(FACTORY_PREFIXES)]


def calls_hook(fn: ast.AST, hook: str) -> bool:
    """True when ``fn``'s body calls ``hook`` (by any dotted path)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            if d.split(".")[-1] == hook:
                return True
    return False


@register
class SanitizerCoverage(Rule):
    name = "nonneg-sanitizer-coverage"
    description = ("every MU-step implementation must call "
                   "sanitize_state(...)")

    def check_file(self, src, ctx):
        for fn in mu_functions(src.nodes):
            if calls_hook(fn, HOOK_NAME):
                continue
            yield Finding(
                self.name, src.rel, fn.lineno, fn.col_offset,
                f"MU step '{fn.name}' does not call {HOOK_NAME}(...) — "
                f"thread the sanitizer hook (enabled flag defaulting to "
                f"False) so the config's sanitize flag covers this path",
                ERROR)
