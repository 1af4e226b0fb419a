"""Stretch-move steps a refit run (one ``batched_max_loglike`` call, two a
chunk: the null's and the alternative's), from the port's counter
``LRTResult.timings["refit_steps"]`` over the window's calls.  Read from a
run on a card; nothing to read on the host (the plain versions stand in
there) or from a port without the counter.  Over ranks: rank 0's (the ranks
step together: the early stop is voted over them once a step)."""

OVER_RANKS = "rank0"


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    records = [r for r in ctx.records if "refit_steps" in r["timings"]]
    chunk = ctx.config["chunk"]
    runs = sum(2 * -(-(r["sims"] + 1) // chunk) for r in records)  # the matched observed row rides along
    return sum(r["timings"]["refit_steps"] for r in records) / runs if runs else None
