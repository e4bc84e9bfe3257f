"""repro_torch.analysis — the port's static lint and its runtime checks
(the counterpart of ``repro.analysis``).

Two halves, deliberately decoupled:

  * ``framework`` / ``rules`` — a pure-stdlib AST lint pass (no torch
    import, so ``scripts/torch_rescal_lint.py`` runs on any Python),
    whose rules hold the port to its own contracts: sanitizer and
    telemetry hooks in every MU step, the fault-seam registry, explicit
    generators, device isolation, no host sync in an MU iteration, and
    one checked, counted, twinned wrapper per CUDA launcher.
  * ``sanitizer`` — the runtime factor sanitizer.  It imports torch, so
    its names load on first use.
"""
from .framework import (Finding, LintContext, Rule, SourceFile, all_rules,
                        register, run_lint)

_SANITIZER = ("FactorSanitizerError", "check_factors", "last_failure",
              "reset_failures", "sanitize_state")

__all__ = ["Finding", "LintContext", "Rule", "SourceFile", "all_rules",
           "register", "run_lint", *_SANITIZER]


def __getattr__(name):
    if name in _SANITIZER:
        from . import sanitizer
        return getattr(sanitizer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
