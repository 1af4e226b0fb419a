"""Milliseconds a bootstrap call in which the card is idle while the host makes
the call's simulator (with Kraft noise, its tables): the card-idle seconds
inside the port's ``lrt.simulator`` spans in the traced turn
(``gpbench/spans.py``) over the traced turn's calls.  Nothing to read
without a device trace or without that span (a port that records none)."""
from gpbench.spans import idle_inside, traced_spans


def read(ctx):
    spans = traced_spans(ctx)
    idle = idle_inside(spans, ctx.traced.trace, {"lrt.simulator"}) if spans else None
    return None if idle is None else 1e3 * idle / len(ctx.traced.records)
