"""Bootstrap simulations completed over the window, per second: each generated,
refit under both models and refined (host clock, from the window's start to
the end of its last call).  Over ranks: rank 0's (its window; every rank's
call returns the whole result, so the simulations are counted once)."""

OVER_RANKS = "rank0"


def read(ctx):
    sims = sum(r["sims"] for r in ctx.records)
    return sims / ctx.window_s if sims else None
