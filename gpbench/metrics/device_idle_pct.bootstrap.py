"""The share of the traced bootstrap call in which no activity ran on the card,
in % (profiler).  Over ranks: the mean of each card's share."""


def read(ctx):
    traced = ctx.traced
    if traced is None or not traced.busy_s:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)
