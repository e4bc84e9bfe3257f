"""Mean duration of the port's ``sched/execute`` spans (one per unit
attempt, closed after the unit's device synchronisation)."""
import statistics


def read(ctx):
    spans = ctx.timeline.span_seconds("sched/execute")
    return statistics.fmean(spans) if spans else None
