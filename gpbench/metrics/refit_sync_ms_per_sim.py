"""Milliseconds a bootstrap simulation that the host spends in the refits'
early stop, where it waits once a step for the card's answer: the summed
durations of the port's ``refits.early_stop`` spans in the traced turn over
the traced turn's simulations.  Nothing to read without a device trace or
without spans.  Over ranks: the mean (a time)."""
from gpbench.spans import host_seconds, traced_spans


def read(ctx):
    spans = traced_spans(ctx)
    sims = sum(r["sims"] for r in ctx.traced.records) if spans else 0
    wait = host_seconds(spans, {"refits.early_stop"}) if sims else None
    return None if wait is None else 1e3 * wait / sims
