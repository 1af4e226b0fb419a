"""Milliseconds of refits (both models' short chains) a bootstrap simulation,
from ``LRTResult.timings["refits_s"]`` over the window's calls.  Over ranks:
the mean (a time)."""


def read(ctx):
    sims = sum(r["sims"] for r in ctx.records)
    return 1e3 * sum(r["timings"]["refits_s"] for r in ctx.records) / sims if sims else None
