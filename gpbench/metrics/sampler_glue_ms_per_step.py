"""Milliseconds a step in which the observed sampler's card is idle: the
window's ``timings["sampling_s"]`` a step (untraced calls, so no profiler
cost inside) less the card's busy seconds a step in the traced turn, the
gradient kernel's (the MAP fits') taken out.  The MAP fits' few other
kernels count as the sampler's."""
from gpbench.trace import busy_seconds


def read(ctx):
    traced = ctx.traced
    if traced is None or not traced.trace.device or not ctx.records:
        return None
    sampling = sum(r["sampling_s"] for r in ctx.records) / sum(r["steps"] for r in ctx.records)
    grad = sum(e - s for name, s, e in traced.trace.device if "grad_kernel" in name)
    busy = (busy_seconds(traced.trace.device) - grad) / sum(r["steps"] for r in traced.records)
    return 1e3 * (sampling - busy)
