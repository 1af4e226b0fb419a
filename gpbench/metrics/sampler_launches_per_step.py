"""The observed sampler's celerite launches a step, from
``GPModelling.timings["sampling_launches"]`` over the window's calls (the
plain version on a host counts none: nothing to read)."""


def read(ctx):
    steps = sum(r["steps"] for r in ctx.records)
    launches = sum(r["sampling_launches"] for r in ctx.records)
    return launches / steps if steps and launches > 0 else None
