"""obs-metrics-coverage: every MU step threads the telemetry hook (the
counterpart of ``repro``'s rule of the same name).

The port's observability layer (``repro_torch.obs``) only sees
convergence if every MU-step implementation calls ``record_metrics(...)``
behind its ``trace_metrics`` flag — a step that skips the hook is a
silent hole in the per-iteration trajectories (``--trace`` runs would
report convergence for some steps and nothing for others).  Same shape
as ``nonneg-sanitizer-coverage``: any function whose name matches the
MU-step pattern (``*mu_step*`` / ``*mu_iter*``, excluding ``make_*`` /
``get_*`` / ``build_*`` factories) must contain a ``record_metrics(...)``
call.  The zero-cost-off contract lives at the call site (the ``if
trace_metrics:`` guard), which this rule deliberately does not inspect;
tests/test_torch_obs.py pins the guard.
"""
from __future__ import annotations

from ..framework import ERROR, Finding, Rule, register
from .sanitizer_coverage import calls_hook, mu_functions

HOOK_NAME = "record_metrics"


@register
class ObsMetricsCoverage(Rule):
    name = "obs-metrics-coverage"
    description = ("every MU-step implementation must call "
                   "record_metrics(...) behind its trace_metrics flag")

    def check_file(self, src, ctx):
        for fn in mu_functions(src.nodes):
            if calls_hook(fn, HOOK_NAME):
                continue
            yield Finding(
                self.name, src.rel, fn.lineno, fn.col_offset,
                f"MU step '{fn.name}' does not call {HOOK_NAME}(...) — "
                f"call the repro_torch.obs.metrics hook behind an `if "
                f"trace_metrics:` guard so --trace covers this path",
                ERROR)
