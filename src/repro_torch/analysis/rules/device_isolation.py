"""device-isolation: backend switches and feature probes live in
``device.py`` only, and the port imports nothing of JAX or ``repro``
(the counterpart of ``repro``'s ``compat-isolation``).

``device.strict_fp32`` is the one place that switches TF32 off, and
``kernels/_build.py`` the one place that probes the toolchain; a second
switch elsewhere would make a result depend on which module ran first.
Outside ``repro_torch/device.py`` and ``kernels/_build.py`` the rule
bans

  * any use of ``torch.backends.*`` (a write switches a backend flag, a
    read probes one)
  * ``torch.set_float32_matmul_precision(...)``
  * reads of ``torch.__version__`` / ``torch.version.*``
  * ``hasattr(<torch module>, "<name>")`` and ``getattr(<torch module>,
    "<name>", default)`` probes.  Only a literal name is a probe (it
    names a feature); a computed name, such as a dtype read from a
    config, is a lookup by value and is not reported
  * ``try: import ...`` / ``except ImportError`` gates (an optional
    dependency switched on by its presence)

and everywhere, the two files included, any import of ``jax``,
``jaxlib`` or ``repro`` (the JAX package the port is held against in
its tests, never at run time).
"""
from __future__ import annotations

import ast

from ..framework import ERROR, Finding, Rule, dotted, register, resolve_alias

EXEMPT_SUFFIXES = ("repro_torch/device.py", "kernels/_build.py")
BANNED_ROOTS = {"jax", "jaxlib", "repro"}
SWITCH_CALLS = {"torch.set_float32_matmul_precision"}
GUARDED = ("torch.backends", "torch.version", "torch.__version__")
GATE_ERRORS = {"ImportError", "ModuleNotFoundError"}


def _torch_rooted(name: str) -> bool:
    return name == "torch" or name.startswith("torch.")


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED_ROOTS


@register
class DeviceIsolation(Rule):
    name = "device-isolation"
    description = ("backend switches and feature probes belong in "
                   "device.py; no jax/jaxlib/repro import in the port")

    def check_file(self, src, ctx):
        yield from self._banned_imports(src)
        if src.rel.endswith(EXEMPT_SUFFIXES):
            return
        aliases = src.aliases
        for node in src.nodes:
            if isinstance(node, (ast.Attribute, ast.Name)):
                area = self._guarded(node, aliases)
                if area:
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        f"{area} read or switched outside device.py — "
                        f"call device.strict_fp32() (or add the switch or "
                        f"probe there)", ERROR)
            elif isinstance(node, ast.Call):
                full = resolve_alias(dotted(node.func), aliases)
                if full in SWITCH_CALLS:
                    yield Finding(self.name, src.rel, node.lineno,
                                  node.col_offset,
                                  f"{full}() outside device.py", ERROR)
                elif self._is_probe(node, aliases):
                    target = resolve_alias(dotted(node.args[0]), aliases)
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        f"{node.func.id}() probe on {target}: feature "
                        f"detection belongs in device.py", ERROR)
            elif isinstance(node, ast.Try) and self._is_gate(node):
                yield Finding(
                    self.name, src.rel, node.lineno, node.col_offset,
                    "try/except ImportError gate: an optional dependency "
                    "switched on by its presence belongs in device.py",
                    ERROR)

    def _banned_imports(self, src):
        for node in src.nodes:
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and \
                    (dotted(node.func) or "") in ("importlib.import_module",
                                                  "__import__") and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                mods = [node.args[0].value]
            for mod in mods:
                if _banned(mod):
                    yield Finding(
                        self.name, src.rel, node.lineno, node.col_offset,
                        f"import of {mod!r}: the port imports neither JAX "
                        f"nor repro (its tests compare the two)", ERROR)

    @staticmethod
    def _guarded(node, aliases) -> str:
        """The guarded torch namespace ``node`` enters (``torch.backends``,
        ``torch.version``, ``torch.__version__``), else "".  An attribute
        chain is reported once, where it enters; a name imported from
        the namespace, wherever it is used."""
        full = resolve_alias(dotted(node), aliases)
        if isinstance(node, ast.Attribute):
            return full if full in GUARDED else ""
        if node.id not in aliases or not isinstance(node.ctx, ast.Load):
            return ""
        return next((g for g in GUARDED
                     if full == g or full.startswith(g + ".")), "")

    @staticmethod
    def _is_probe(call: ast.Call, aliases) -> bool:
        if not isinstance(call.func, ast.Name) or len(call.args) < 2 or \
                call.func.id not in ("hasattr", "getattr"):
            return False
        if call.func.id == "getattr" and len(call.args) < 3:
            return False     # a two-argument getattr raises: a lookup
        name = call.args[1]
        if not (isinstance(name, ast.Constant) and
                isinstance(name.value, str)):
            return False     # computed name: a lookup by value
        return _torch_rooted(resolve_alias(dotted(call.args[0]), aliases))

    @staticmethod
    def _is_gate(node: ast.Try) -> bool:
        imports = any(isinstance(stmt, (ast.Import, ast.ImportFrom))
                      for stmt in node.body)
        if not imports:
            return False
        for handler in node.handlers:
            t = handler.type
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if e is not None and (dotted(e) or "") in GATE_ERRORS:
                    return True
        return False
