"""Collectives per MU iteration: the mean ``collectives`` count that the
program's closing ``mu/iter`` records carry (``dist/engine.py``; the
grid's collectives made inside the iteration, counted while tracing)."""
import statistics


def read(ctx):
    counts = [rec["args"]["collectives"] for rec in ctx.timeline.spans
              if rec.get("ph") == "E" and rec.get("name") == "mu/iter"
              and "collectives" in rec.get("args", {})]
    return statistics.fmean(counts) if counts else None
