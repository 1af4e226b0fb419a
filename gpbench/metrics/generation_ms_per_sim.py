"""Milliseconds of simulation (TK95, E13, noise) a bootstrap simulation, from
``LRTResult.timings["generation_s"]`` over the window's calls.  Over ranks:
the mean (a time; every rank generates every chunk whole)."""


def read(ctx):
    sims = sum(r["sims"] for r in ctx.records)
    return 1e3 * sum(r["timings"]["generation_s"] for r in ctx.records) / sims if sims else None
