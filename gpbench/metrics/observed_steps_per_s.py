"""Ensemble-sampler steps of the observed fits completed over the window,
per second, their MAP fits and autocorrelation checks inside it (host
clock, from the window's start to the end of its last call)."""


def read(ctx):
    steps = sum(r["steps"] for r in ctx.records)
    return steps / ctx.window_s if steps else None
