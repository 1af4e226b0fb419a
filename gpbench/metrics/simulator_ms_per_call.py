"""Milliseconds a bootstrap call spends making its simulator, before the first
chunk (with Kraft noise, building its tables: ``KraftNoise`` tabulates the
Kraft+91 median and interval of every bin at N = 0..15), from
``LRTResult.timings["simulator_s"]`` (the ``lrt.simulator`` phase) over the
window's calls.  Nothing to read from a port without the timer."""


def read(ctx):
    records = ctx.records
    if not records or any("simulator_s" not in r["timings"] for r in records):
        return None
    return 1e3 * sum(r["timings"]["simulator_s"] for r in records) / len(records)
