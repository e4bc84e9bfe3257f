"""Mean duration of the port's ``sched/reduce`` spans (one per rank's
reduction: clustering, silhouettes, regression, relative error)."""
import statistics


def read(ctx):
    spans = ctx.timeline.span_seconds("sched/reduce")
    return statistics.fmean(spans) if spans else None
