"""The refits' celerite kernel launches a bootstrap simulation, from the op's
launch counter over the window's calls (the refine's two a chunk taken out).
The plain version on a host counts none: nothing to read.  Over ranks: the
sum (each rank launches for its own rows)."""

OVER_RANKS = "sum"


def read(ctx):
    sims = sum(r["sims"] for r in ctx.records)
    launches = sum(r["refit_launches"] for r in ctx.records)
    return launches / sims if sims and launches > 0 else None
