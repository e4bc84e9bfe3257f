"""Runtime checks of the port (the torch counterpart of ``repro.analysis``;
the static linter stays in ``repro.analysis`` and lints this package too)."""
from .sanitizer import FactorSanitizerError, sanitize_state

__all__ = ["FactorSanitizerError", "sanitize_state"]
