"""Passes of the E13 loop a chunk of simulations (each pass ends in a host
sync), from the port's counter ``LRTResult.timings["e13_passes"]`` over the
window's calls, divided by their chunks that hold simulations.  Read from a
run on a card; nothing to read on the host, from a port without the
counter, or where no pass ran (Gaussian simulations)."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    records = [r for r in ctx.records if "e13_passes" in r["timings"]]
    chunk = ctx.config["chunk"]
    chunks = sum(-(-r["sims"] // chunk) for r in records)
    passes = sum(r["timings"]["e13_passes"] for r in records)
    return passes / chunks if chunks and passes else None
