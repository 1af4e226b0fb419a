"""Where the card is idle in a cell's traced turns, put down to the port's
spans, and what recording the spans costs.

    python -m gpbench.idle_split --workload <name> --seed <n> [--turns 4]

on a card, from the root of a checkout.  It makes the cell's set-up as a
run does (``run.py``), then traces ``--turns`` turns of the same calls (the
same call indices, so the same work) with ``torch.profiler``'s CUDA
activity, as a traced run does: in the order recorded, off, off, recorded
(off: the port's ``tracing`` sees no profiler, so its spans are the no-op).
It prints one JSON line: each turn's wall and busy seconds, the seconds
Python's garbage collector ran in it (and its full collections), and, for each
recorded turn, the card's idle seconds put down to each span's self time
(``spans.idle_by_span``, largest first), those under a root's own time and
outside every span, the share of the turn's idle (its wall less its busy
seconds) that lies under a span below a root, and the cell's span metrics
read on that turn.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

SPAN_METRICS = ("refit_idle_ms_per_sim", "refit_sync_ms_per_sim", "sampler_idle_ms_per_step")


def split(workload: str, seed: int, turns: int, device, overrides=None) -> dict:
    """The result line's object for ``turns`` traced turns of the cell
    ``workload`` on ``device`` (``overrides`` as ``run.run_cell``'s)."""
    import torch

    from gpbench import spans as sp
    from gpbench.run import PACKAGE_DIR, load_cell, load_module
    from gpbench.trace import busy_seconds, profile_call
    from mind_the_gaps_tpu_torch import tracing

    dirs = [PACKAGE_DIR]
    cell = load_cell(workload, Path.cwd(), dirs)
    for key, extra in (overrides or {}).items():
        getattr(cell, key).update(extra)
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=seed,
                          seconds=0.0, trace=True, device=device, control=False, dirs=dirs, records=[], traced=None,
                          state=None)
    driver = load_module(dirs, "drivers", cell.traffic["driver"])
    calls = int(getattr(driver, "CALLS_PER_TURN", 1))
    driver.setup(ctx)
    recorder, silent = tracing._profiler, SimpleNamespace(_is_profiler_enabled=False)
    names = [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS]
    out = {"workload": workload, "seed": seed, "torch": torch.__version__, "turns": []}
    collecting = [0.0, 0.0, 0]  # seconds in the collector, the current collection's start, full collections

    def collector(phase, info):
        if phase == "start":
            collecting[1] = time.perf_counter()
        else:
            collecting[0] += time.perf_counter() - collecting[1]
            collecting[2] += info["generation"] == 2

    gc.callbacks.append(collector)
    for i in range(turns):
        recording = i % 4 in (0, 3)
        tracing.clear()
        tracing._profiler = recorder if recording else silent
        collecting[0], collecting[2] = 0.0, 0
        def turn():  # the calls, and the collector's work in them (not in the profiler's own)
            return [driver.call(ctx, k) for k in range(calls)], dict(gc_s=collecting[0], full_gc=collecting[2])

        try:
            (records, collected), trace = profile_call(turn, device)
        finally:
            tracing._profiler = recorder
        busy = busy_seconds(trace.device)
        row = dict(recording=recording, window_s=trace.window_s, busy_s=busy, **collected)
        if recording:
            spans = sp.within(sp.program_spans(), trace)
            by_name, at_root, outside = sp.idle_by_span(spans, trace)
            idle = trace.window_s - busy
            ctx.traced = SimpleNamespace(records=records, trace=trace, busy_s=busy, window_s=trace.window_s)
            row.update(spans=len(spans), idle_s=idle, covered=sum(by_name.values()) / idle,
                       at_root_s=at_root, outside_s=outside,
                       by_span=sorted(by_name.items(), key=lambda kv: -kv[1]),
                       metrics={n: load_module(dirs, "metrics", n).read(ctx) for n in names})
        out["turns"].append(row)
    gc.callbacks.remove(collector)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpbench.idle_split", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from gpbench.run import _card

    if not torch.cuda.is_available():
        print("gpbench.idle_split: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = split(args.workload, args.seed, args.turns, device)
    out["card"] = _card(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
