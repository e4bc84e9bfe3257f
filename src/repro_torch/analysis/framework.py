"""Plugin AST-lint framework for the port's linter (``torch-rescal-lint``;
the counterpart of ``repro/analysis/framework.py``).

Pure stdlib by design: the linter runs anywhere (a lint job, a laptop
without CUDA) in a few seconds, so nothing in this module or in
``rules/`` imports torch, numpy or runtime code of the port.

Concepts
--------
``Rule`` subclasses register themselves with :func:`register`; each rule
implements ``check_file`` (per-file findings) and/or ``check_project``
(cross-file findings — e.g. "this launcher is reached from one module").
:func:`run_lint` parses every ``.py`` under the given paths once, hands the
shared :class:`LintContext` to every rule, then applies suppressions.

Suppressions are trailing or preceding comments under the port's own
prefix (``repro``'s linter reads ``rescal-lint:``, this one
``torch-lint:``, so neither reads the other's)::

    y = x.item()  # torch-lint: disable=host-sync-hazard -- why

    # torch-lint: disable=host-sync-hazard -- once per call, not per step
    n = int(counts.max())

    # torch-lint: disable-file=generator-discipline -- reference draws

A suppression without a ``-- justification`` tail is itself reported
(rule ``suppression``): every disable carries its reason inline.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "SourceFile", "LintContext", "Rule", "register",
    "all_rules", "run_lint", "dotted", "resolve_alias",
]

ERROR = "error"
WARNING = "warning"
PROG = "torch-rescal-lint"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                       # repo-relative posix path
    line: int
    col: int
    message: str
    severity: str = ERROR

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.severity}: "
                f"[{self.rule}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


_DISABLE_RE = re.compile(
    r"#\s*torch-lint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"(?:\s+--\s*(?P<why>\S.*))?\s*$")


class SourceFile:
    """One parsed module: AST, raw lines, and suppression tables."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.nodes = list(ast.walk(self.tree))   # every rule walks them
        self.aliases = import_aliases(self.tree)
        # line -> set of disabled rule names; "all" disables everything
        self.line_disables: Dict[int, set] = {}
        self.file_disables: set = set()
        self.bad_suppressions: List[Tuple[int, str]] = []
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DISABLE_RE.search(tok.string)
                if not m:
                    continue
                row, col = tok.start
                names = {r.strip() for r in m.group("rules").split(",")
                         if r.strip()}
                if not m.group("why"):
                    self.bad_suppressions.append(
                        (row, "suppression without a '-- justification' tail"))
                if m.group("file"):
                    self.file_disables |= names
                    continue
                # trailing comment guards its own line; a standalone comment
                # guards the next code line (skipping blank/comment lines,
                # so multi-line justifications stay adjacent)
                trailing = self.lines[row - 1][:col].strip() != ""
                target = row
                if not trailing:
                    target = row + 1
                    while target <= len(self.lines):
                        stripped = self.lines[target - 1].strip()
                        if stripped and not stripped.startswith("#"):
                            break
                        target += 1
                self.line_disables.setdefault(target, set()).update(names)
        except tokenize.TokenError:
            pass

    def suppressed(self, finding: Finding) -> bool:
        names = self.line_disables.get(finding.line, set()) | \
            self.file_disables
        return finding.rule in names or "all" in names


class LintContext:
    """Everything rules can see: all parsed files plus the scan root."""

    def __init__(self, root: Path, files: Sequence[SourceFile]):
        self.root = root
        self.files = list(files)
        self.by_rel = {f.rel: f for f in self.files}

    def rel(self, path: Path) -> str:
        """``path`` relative to the scan root (posix), as findings name
        files that are not Python sources (``.cu``)."""
        try:
            return path.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            return path.as_posix()


class Rule:
    """Base class; subclasses set ``name`` and override the check hooks."""

    name: str = ""
    description: str = ""

    def check_file(self, src: SourceFile,
                   ctx: LintContext) -> Iterable[Finding]:
        return ()

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global rule registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    _REGISTRY[rule.name] = rule
    return cls


def all_rules() -> Dict[str, Rule]:
    # import for side effect: rule modules self-register
    from . import rules  # noqa: F401
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# shared AST helpers


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local name -> dotted module/object it refers to.  A relative
    import keeps its leading dots (``from . import _build`` maps
    ``_build`` to ``._build``), so rules match it by its last segments
    (:func:`ends_with`)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            sep = "" if base.endswith(".") else "."
            for a in node.names:
                out[a.asname or a.name] = f"{base}{sep}{a.name}"
    return out


def resolve_alias(name: Optional[str], aliases: Dict[str, str]) -> str:
    """Expand the first segment of a dotted name through the alias map."""
    if not name:
        return ""
    head, _, rest = name.partition(".")
    full = aliases.get(head, head)
    return f"{full}.{rest}" if rest else full


def ends_with(full: str, suffix: str) -> bool:
    """True when dotted ``full`` ends with the whole segments ``suffix``
    (``repro_torch.resilience.faults.probe`` and ``faults.probe`` end
    with ``faults.probe``; ``myfaults.probe`` does not)."""
    return full == suffix or full.endswith("." + suffix)


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_lint_parent", None)


def enclosing_function(node: ast.AST):
    """The function ``node`` lies in (None at module level); needs
    :func:`attach_parents`."""
    p = parent(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef)):
        p = parent(p)
    return p


def functions(nodes):
    """Every (possibly nested) function definition among ``nodes``."""
    return [n for n in nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# ---------------------------------------------------------------------------
# driver


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_checked: int
    rules_run: List[str]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def to_json(self) -> str:
        return json.dumps({
            "files_checked": self.files_checked,
            "rules": self.rules_run,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "findings": [f.to_json() for f in self.findings],
        }, indent=2)

    def format_human(self) -> str:
        lines = [f.format() for f in self.findings]
        lines.append(f"{PROG}: {self.files_checked} files, "
                     f"{len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)


def _collect_py(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    # dedupe, keep order
    seen, uniq = set(), []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def run_lint(paths: Sequence[str | Path], *,
             root: str | Path | None = None,
             rules: Optional[Sequence[str]] = None) -> LintResult:
    """Lint every .py under ``paths``; return suppression-filtered findings."""
    paths = [Path(p) for p in paths]
    root_path = Path(root) if root else Path.cwd()
    registry = all_rules()
    selected = {n: r for n, r in registry.items()
                if rules is None or n in rules}

    files: List[SourceFile] = []
    findings: List[Finding] = []
    for py in _collect_py(paths):
        try:
            rel = py.resolve().relative_to(root_path.resolve()).as_posix()
        except ValueError:
            rel = py.as_posix()
        try:
            files.append(SourceFile(py, rel, py.read_text()))
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("parse", rel,
                                    getattr(e, "lineno", 1) or 1, 0,
                                    f"could not parse: {e}", ERROR))

    ctx = LintContext(root_path, files)
    for src in files:
        attach_parents(src.tree)
        for line, why in src.bad_suppressions:
            findings.append(Finding("suppression", src.rel, line, 0, why,
                                    ERROR))
    for name, rule in sorted(selected.items()):
        for src in files:
            findings.extend(rule.check_file(src, ctx))
        findings.extend(rule.check_project(ctx))

    kept = [f for f in findings
            if f.path not in ctx.by_rel or
            not ctx.by_rel[f.path].suppressed(f)]
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(kept, len(files), sorted(selected))
