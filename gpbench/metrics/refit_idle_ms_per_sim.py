"""Milliseconds a bootstrap simulation in which the card is idle while the host
is in the refits: the card-idle seconds inside the port's ``lrt.refits``
spans in the traced turn (``gpbench/spans.py``; the spans are on the
profiler's clock) over the traced turn's simulations.  Nothing to read
without a device trace or without spans (a port that records none).  Over
ranks: the mean (a time)."""
from gpbench.spans import idle_inside, traced_spans


def read(ctx):
    spans = traced_spans(ctx)
    sims = sum(r["sims"] for r in ctx.traced.records) if spans else 0
    idle = idle_inside(spans, ctx.traced.trace, {"lrt.refits"}) if sims else None
    return None if idle is None else 1e3 * idle / sims
