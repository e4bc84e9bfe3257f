"""Runtime checks of the port (the torch counterpart of ``repro.analysis``;
the static linter stays in ``repro.analysis`` and lints this package too)."""
from .sanitizer import (FactorSanitizerError, check_factors, last_failure,
                        reset_failures, sanitize_state)

__all__ = ["FactorSanitizerError", "check_factors", "last_failure",
           "reset_failures", "sanitize_state"]
