"""Host milliseconds a refit step spends in the early stop's vote over the
processes (``lrt.process_any``: gloo's all-reduce of one flag, its round
trip and the wait for the slowest rank), in the traced turn: the seconds of
the benchmark's own timer around ``lrt.process_any`` (``ranks.py``, on for
the traced turn only), summed over this rank's calls, over the traced
turn's refit steps (``timings["refit_steps"]``; one vote a step).  Nothing
to read from a run of one process, which has no vote.  Over ranks: the
mean."""


def read(ctx):
    votes = getattr(ctx.traced, "process_any_s", None)
    steps = sum(r["timings"]["refit_steps"] for r in ctx.traced.records) if votes else 0
    return 1e3 * sum(votes) / steps if steps else None
