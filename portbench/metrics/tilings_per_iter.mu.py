"""BCSR operand tilings per MU iteration: the mean ``tilings`` count that
the program's closing ``mu/iter`` records carry (``dist/engine.py``;
``kernels/bcsr_fused.py``'s ``tiling_count`` over the iteration, counted
while tracing).  None where the records carry no such count."""
import statistics


def read(ctx):
    counts = [rec["args"]["tilings"] for rec in ctx.timeline.spans
              if rec.get("ph") == "E" and rec.get("name") == "mu/iter"
              and "tilings" in rec.get("args", {})]
    return statistics.fmean(counts) if counts else None
