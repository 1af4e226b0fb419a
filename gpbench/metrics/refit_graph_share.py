"""The share of the refits' stretch-move steps that ran as replays of a
captured CUDA graph (every step of a refit run after its first, when the run
is alone on its card), from the port's counters
``LRTResult.timings["refit_graph_steps"]`` over ``["refit_steps"]`` across
the window's calls.  Read from a run on a card; nothing to read on the host
(the refits step eagerly there) or from a port without the counter.  Over
ranks: rank 0's (every rank replays its own run's steps alike)."""

OVER_RANKS = "rank0"


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    records = [r for r in ctx.records if "refit_graph_steps" in r["timings"]]
    steps = sum(r["timings"]["refit_steps"] for r in records)
    return sum(r["timings"]["refit_graph_steps"] for r in records) / steps if steps else None
