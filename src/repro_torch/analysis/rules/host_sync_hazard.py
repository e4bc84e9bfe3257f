"""host-sync-hazard: no host synchronisation inside an MU iteration or a
kernel wrapper (the counterpart of the first check of ``repro``'s
``recompile-hazard``, which flags ``.item()`` / ``float()`` / ``np.*`` on
traced values).

CUDA work is queued: a step that reads a tensor's value on the host waits
for everything queued before it, so the card idles once per MU iteration
while Python catches up.  The rule checks

  * the bodies of the MU-step implementations (``*mu_step*`` /
    ``*mu_iter*``, factories excluded, as ``nonneg-sanitizer-coverage``
    finds them),
  * the public functions of every kernel wrapper (a module under
    ``kernels/`` that reaches ``_build.library()``),
  * and the module-local closure of plain-name calls they make,

and reports

  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and any
    ``.synchronize()`` (``torch.cuda.synchronize()``, a stream's or an
    event's)
  * ``float()`` / ``int()`` / ``bool()`` of a tensor expression
  * a numpy call (``np.*``) given a tensor expression.

A tensor expression is one the rule can see is a tensor: a name
annotated ``torch.Tensor`` or bound from one, a ``torch.*`` call, a
tensor's method or arithmetic over tensors.  Metadata (``.shape``,
``.size()``, ``.numel()``, ``.stride()``, ``.data_ptr()``, ``.dtype``,
``.device``) is host state and never counts.  An unannotated parameter
or an attribute of another object (``state.A``) is not known to be a
tensor, so ``float()`` of one is not reported: the method calls above
are, whatever their receiver.  Hooks imported from other modules
(``sanitize_state``, ``record_metrics``) are off unless asked for and are
not followed.

``recompile-hazard``'s second check (value-derived Python scalars fed to
a jitted program's static arguments) has no counterpart: the port
compiles no program per argument value.
"""
from __future__ import annotations

import ast
from typing import Dict, Set

from ..framework import ERROR, Finding, Rule, dotted, register, resolve_alias
from .cuda_kernel import LIBRARY, calls_to
from .sanitizer_coverage import mu_functions

SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
CASTS = {"float", "int", "bool"}
META_METHODS = {"size", "dim", "numel", "nelement", "stride", "data_ptr",
                "element_size", "is_contiguous", "storage_offset",
                "get_device", "is_floating_point", "is_complex"}
TENSOR_ATTRS = {"T", "mT", "H", "mH", "data", "grad", "real", "imag"}
TENSOR_BUILTINS = {"abs", "max", "min", "sum", "round"}
HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.")
HOST_TORCH = {"torch.device", "torch.Size", "torch.Generator", "torch.finfo",
              "torch.iinfo", "torch.is_tensor", "torch.is_grad_enabled",
              "torch.no_grad", "torch.get_default_dtype", "torch.dtype"}
NUMPY = "numpy"


def _annotated_tensor(ann) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


class _Tensors:
    """Which expressions of one function are tensors."""

    def __init__(self, fn, aliases: Dict[str, str]):
        self.aliases = aliases
        a = fn.args
        self.names: Set[str] = {
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if _annotated_tensor(p.annotation)}
        if a.vararg is not None and _annotated_tensor(a.vararg.annotation):
            self.names.add(a.vararg.arg)
        binds = [n for n in ast.walk(fn)
                 if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
        for _ in range(2):          # a name bound from a later-bound one
            for b in binds:
                tensor = (isinstance(b, ast.AnnAssign)
                          and _annotated_tensor(b.annotation)) or \
                    (b.value is not None and self.of(b.value))
                if not tensor:
                    continue
                targets = b.targets if isinstance(b, ast.Assign) \
                    else [b.target]
                for t in targets:
                    self.names |= {n.id for n in ast.walk(t)
                                   if isinstance(n, ast.Name)}

    def of(self, e) -> bool:
        """True when ``e`` is visibly a tensor."""
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            return e.attr in TENSOR_ATTRS and self.of(e.value)
        if isinstance(e, ast.Call):
            return self._call(e)
        if isinstance(e, ast.BinOp):
            return self.of(e.left) or self.of(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.of(e.operand)
        if isinstance(e, ast.Subscript):
            return self.of(e.value)
        if isinstance(e, ast.Compare):
            return self.of(e.left) or any(self.of(c) for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.of(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.of(e.body) or self.of(e.orelse)
        return False

    def _call(self, call: ast.Call) -> bool:
        full = resolve_alias(dotted(call.func), self.aliases)
        if full.startswith("torch."):
            return full not in HOST_TORCH and \
                not full.startswith(HOST_TORCH_PREFIXES)
        if isinstance(call.func, ast.Attribute):
            return call.func.attr not in META_METHODS | SYNC_METHODS and \
                self.of(call.func.value)
        if isinstance(call.func, ast.Name) and \
                call.func.id in TENSOR_BUILTINS:
            return any(self.of(a) for a in call.args)
        return False


@register
class HostSyncHazard(Rule):
    name = "host-sync-hazard"
    description = ("no host sync (.item(), float(tensor), np.*(tensor), "
                   "synchronize) in an MU iteration or a kernel wrapper")

    def check_file(self, src, ctx):
        aliases = src.aliases
        funcs: Dict[str, ast.AST] = {}
        for node in src.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, node)
        roots = [fn.name for fn in mu_functions(src.nodes)]
        if "kernels/" in src.rel and calls_to(src.tree, aliases, LIBRARY):
            roots += [n.name for n in src.tree.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and not n.name.startswith("_")]
        np_names = {local for local, full in aliases.items()
                    if full == NUMPY}
        seen: Set[str] = set()
        reported: Set[tuple] = set()    # a nested def is walked twice
        frontier = list(roots)
        while frontier:
            name = frontier.pop()
            if name in seen or name not in funcs:
                continue
            seen.add(name)
            fn = funcs[name]
            for f in self._check_body(fn, src, aliases, np_names):
                if (f.line, f.col) not in reported:
                    reported.add((f.line, f.col))
                    yield f
            frontier += [n.func.id for n in ast.walk(fn)
                         if isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Name)]

    def _check_body(self, fn, src, aliases, np_names):
        tensors = _Tensors(fn, aliases)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = None
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in SYNC_METHODS:
                what = f".{node.func.attr}()"
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in CASTS and node.args and \
                    tensors.of(node.args[0]):
                what = f"{node.func.id}() of a tensor"
            elif (dotted(node.func) or "").split(".")[0] in np_names and \
                    any(tensors.of(a) for a in node.args):
                what = f"numpy call {dotted(node.func)}() on a tensor"
            if what:
                yield Finding(
                    self.name, src.rel, node.lineno, node.col_offset,
                    f"{what} in '{fn.name}' waits for the device — once "
                    f"per MU iteration or kernel call; keep the value on "
                    f"the device or hoist it out of the loop", ERROR)
