"""Milliseconds of one MAP fit of the observed data, from
``GPModelling.timings["map_fit_s"]`` over the window's calls."""


def read(ctx):
    return 1e3 * sum(r["map_fit_s"] for r in ctx.records) / len(ctx.records) if ctx.records else None
