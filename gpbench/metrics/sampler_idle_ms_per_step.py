"""Milliseconds a step in which the observed sampler's card is idle: the
card-idle seconds inside the port's ``sampler.segment`` and
``sampler.autocorr`` spans in the traced turn (the MAP fit left out) over
the traced turn's sampler steps.  Nothing to read without a device trace or
without spans."""
from gpbench.spans import idle_inside, traced_spans


def read(ctx):
    spans = traced_spans(ctx)
    steps = sum(r["steps"] for r in ctx.traced.records) if spans else 0
    idle = idle_inside(spans, ctx.traced.trace, {"sampler.segment", "sampler.autocorr"}) if steps else None
    return None if idle is None else 1e3 * idle / steps
