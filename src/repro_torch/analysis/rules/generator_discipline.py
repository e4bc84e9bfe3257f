"""generator-discipline: every random draw names its ``torch.Generator``
(the counterpart of ``repro``'s ``key-discipline``).

``repro`` threads ``jax.random`` keys; the port threads explicit
generators (``device.seeded_generator`` derives one independent stream
per tuple of words, as ``fold_in`` does).  A draw from torch's global
generator depends on every draw made before it anywhere in the process,
so member inits, perturbations and data would change with the order of
unrelated code.  The rule reports

  * a ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
    ``bernoulli``/``multinomial``/``poisson`` call, or an in-place
    ``uniform_``/``normal_``/``exponential_``/``random_``/``bernoulli_``/
    ``cauchy_``/``log_normal_``/``geometric_``, without ``generator=``
    (error; a ``**kwargs`` splat may carry it and is not judged)
  * any ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]`` /
    ``torch.random.manual_seed`` / ``torch.seed`` (error: it reseeds the
    process-wide generator every other draw shares)
  * ``g.manual_seed(s)`` inside a loop (in its function) where ``s``
    names nothing bound in that loop — every iteration repeats the same
    draws (error)
  * a generator created and seeded in a function and then used for
    nothing but ``manual_seed`` — passed to no draw, returned or stored
    nowhere (warning: a dead stream)

Python's ``random`` and numpy's generators are not torch draws and are
not checked.
"""
from __future__ import annotations

import ast
from typing import Set

from ..framework import (ERROR, WARNING, Finding, Rule, dotted,
                         enclosing_function, functions, parent, register,
                         resolve_alias)

DRAWS = {f"torch.{n}" for n in ("rand", "randn", "randint", "randperm",
                                "normal", "bernoulli", "multinomial",
                                "poisson")}
INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                 "bernoulli_", "cauchy_", "log_normal_", "geometric_"}
GLOBAL_SEEDS = {"torch.manual_seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.random.manual_seed",
                "torch.seed"}
GENERATOR = "torch.Generator"


def _has_generator(call: ast.Call, full: str) -> bool:
    if any(kw.arg in ("generator", None) for kw in call.keywords):
        return True
    # torch.poisson(input, generator) takes it positionally
    return full == "torch.poisson" and len(call.args) >= 2


def _loop_bound(loop: ast.AST) -> Set[str]:
    """Names (re)bound by a loop: its target and its body's stores."""
    names: Set[str] = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        names |= {n.id for n in ast.walk(loop.target)
                  if isinstance(n, ast.Name)}
    for stmt in loop.body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                names.add(n.id)
    return names


def _enclosing_loops(node: ast.AST):
    """The for/while loops around ``node``, up to its function."""
    out = []
    p = parent(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
        if isinstance(p, (ast.For, ast.AsyncFor, ast.While)):
            out.append(p)
        p = parent(p)
    return out


def _is_generator_ctor(node: ast.AST, aliases) -> bool:
    """``torch.Generator(...)`` or ``torch.Generator(...).manual_seed(s)``."""
    if not isinstance(node, ast.Call):
        return False
    full = resolve_alias(dotted(node.func), aliases)
    if full == GENERATOR:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "manual_seed"
            and _is_generator_ctor(node.func.value, aliases))


@register
class GeneratorDiscipline(Rule):
    name = "generator-discipline"
    description = ("torch draws name their generator; no global seeding; "
                   "no loop-invariant reseeding; no dead generators")

    def check_file(self, src, ctx):
        aliases = src.aliases
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            full = resolve_alias(dotted(node.func), aliases)
            if full in DRAWS and not _has_generator(node, full):
                yield Finding(
                    self.name, src.rel, node.lineno, node.col_offset,
                    f"{full}() without generator= draws from torch's "
                    f"global generator — pass an explicit torch.Generator "
                    f"(device.seeded_generator)", ERROR)
            elif full in GLOBAL_SEEDS:
                yield Finding(
                    self.name, src.rel, node.lineno, node.col_offset,
                    f"{full}() reseeds the process-wide generator — seed "
                    f"an explicit torch.Generator instead", ERROR)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in INPLACE_DRAWS and \
                    not _has_generator(node, full):
                yield Finding(
                    self.name, src.rel, node.lineno, node.col_offset,
                    f".{node.func.attr}() without generator= draws from "
                    f"torch's global generator — pass an explicit "
                    f"torch.Generator", ERROR)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "manual_seed" and \
                    full not in GLOBAL_SEEDS:
                yield from self._loop_invariant_seed(node, src)
        for fn in functions(src.nodes):
            yield from self._dead_generators(fn, src, aliases)

    def _loop_invariant_seed(self, call: ast.Call, src):
        loops = _enclosing_loops(call)
        if not loops:
            return
        used = {n.id for a in call.args for n in ast.walk(a)
                if isinstance(n, ast.Name)}
        if any(used & _loop_bound(loop) for loop in loops):
            return
        yield Finding(
            self.name, src.rel, call.lineno, call.col_offset,
            "manual_seed() inside a loop with a seed that does not change "
            "with the loop — every iteration repeats the same draws; "
            "derive the seed from the loop index", ERROR)

    def _dead_generators(self, fn, src, aliases):
        # generators this function (not a nested one) creates
        made = {}           # name -> [line, seeded]
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    enclosing_function(node) is fn and \
                    _is_generator_ctor(node.value, aliases):
                made[node.targets[0].id] = [
                    node.lineno,
                    getattr(node.value.func, "attr", "") == "manual_seed"]
        used = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Name) and node.id in made
                    and isinstance(node.ctx, ast.Load)):
                continue
            p = parent(node)
            if isinstance(p, ast.Attribute) and p.attr == "manual_seed" \
                    and isinstance(parent(p), ast.Call):
                made[node.id][1] = True
            else:
                used.add(node.id)
        for name, (line, seeded) in made.items():
            if seeded and name not in used:
                yield Finding(
                    self.name, src.rel, line, 0,
                    f"generator '{name}' is seeded but passed to no draw "
                    f"— a dead stream; use it or delete it", WARNING)

