"""resilience-seam-coverage: the fault-seam registry matches the probe
sites (the counterpart of ``repro``'s rule of the same name).

The fault-injection contract (``repro_torch.resilience.faults``) is only
worth anything if the registry and the code agree: a seam listed in
``SEAMS`` with no ``faults.probe("<seam>")`` call site is a *dead seam*
(a chaos plan targeting it silently never fires), and a ``probe()`` call
with a seam the registry does not know is an *unregistered injection
point* (``FaultPlan`` would reject it, so no plan can reach it).  This
rule checks both directions, plus the invariant the chaos drill relies
on: every registered seam is probed at EXACTLY one call site, so a
plan's per-seam hit counters have a single meaning.

Call sites are recognized through the import-alias map (``faults.probe``,
``_faults.probe``, ...); the first argument must be a string literal —
a computed seam name defeats static registry checking and is itself an
error.  ``resilience/faults.py`` is exempt (it holds the registry and
the ``probe`` implementation, not probe sites).
"""
from __future__ import annotations

import ast

from ..framework import (ERROR, Finding, Rule, dotted, ends_with,
                         register, resolve_alias)

REGISTRY_PATH = "resilience/faults.py"
PROBE = "faults.probe"


@register
class ResilienceSeamCoverage(Rule):
    name = "resilience-seam-coverage"
    description = ("every registered fault seam is probed at exactly one "
                   "call site; unregistered or computed probe() targets "
                   "are errors")

    def check_project(self, ctx):
        regs = [f for f in ctx.files if f.rel.endswith(REGISTRY_PATH)]
        if not regs:
            # Self-contained mode: a linted file that defines its own
            # literal SEAMS tuple acts as the registry, and its own
            # probe() calls count as sites.
            regs = [f for f in ctx.files
                    if self._parse_seams(f.tree)[0] is not None]
        if not regs:
            return      # linting a subtree without the registry
        reg = regs[0]
        seams, seams_line = self._parse_seams(reg.tree)
        if seams is None:
            yield Finding(self.name, reg.rel, 1, 0,
                          "no literal SEAMS tuple found — the seam "
                          "registry must be statically parseable", ERROR)
            return
        sites: dict[str, list[tuple[str, int, int]]] = {}
        for src in ctx.files:
            if src.rel.endswith(REGISTRY_PATH):
                continue
            aliases = src.aliases
            for node in src.nodes:
                if not isinstance(node, ast.Call):
                    continue
                full = resolve_alias(dotted(node.func), aliases)
                if not ends_with(full, PROBE):
                    continue
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        "faults.probe() seam must be a string literal so "
                        "the seam registry stays statically checkable",
                        ERROR)
                    continue
                if arg.value not in seams:
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        f"unregistered injection point {arg.value!r} — "
                        f"add it to resilience.faults.SEAMS (registered: "
                        f"{sorted(seams)})", ERROR)
                    continue
                sites.setdefault(arg.value, []).append(
                    (src.rel, node.lineno, node.col_offset))
        for seam in sorted(seams):
            locs = sites.get(seam, [])
            if not locs:
                yield Finding(
                    self.name, reg.rel, seams_line, 0,
                    f"dead seam {seam!r}: registered in SEAMS but probed "
                    f"at no call site — a FaultPlan targeting it can "
                    f"never fire", ERROR)
            elif len(locs) > 1:
                where = ", ".join(f"{r}:{ln}" for r, ln, _ in locs)
                for rel, line, col in locs:
                    yield Finding(
                        self.name, rel, line, col,
                        f"seam {seam!r} is probed at {len(locs)} call "
                        f"sites ({where}) — exactly one is allowed so the "
                        f"plan's hit counter has a single meaning", ERROR)

    @staticmethod
    def _parse_seams(tree: ast.AST):
        """The literal SEAMS tuple and its line, or (None, 0)."""
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == "SEAMS"
                       for t in node.targets):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                    for e in node.value.elts):
                return ({e.value for e in node.value.elts}, node.lineno)
        return None, 0
