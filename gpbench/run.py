"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python -m gpbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration and a traffic
mix; the traffic names a driver (``drivers/<driver>.py``) that makes the
set-up and issues whole calls of the port.  The run:

1. refuses to run (exit 3, no result) without as many CUDA cards as the
   cell asks for; a cell of four cards runs as its configuration's
   ``ranks`` processes, one a card (``ranks.py``: the launcher and the
   rank's run, the steps below on every rank, rank 0 deciding the window
   and printing);
2. makes the data and the set-up from ``--seed`` and warms up every shape
   the window uses (``setup_s``: from the start of the process, the
   launcher's in a cell of ranks, to the window's start);
3. issues calls back to back, starting a turn of calls (one, or the
   driver's ``CALLS_PER_TURN`` for a traffic whose calls alternate) only
   while the window is under ``--seconds`` (a closed loop: one script, one
   call after another), and measures from the window's start to the end
   of the last call;
4. with ``--trace 1``, traces one more turn (not in the window) with
   ``torch.profiler``;
5. reads the peak device memory, frees the program's state, and judges
   the window's answers against the plain reference (``correct``);
6. refuses to print (exit 4) if the process holds JAX or the JAX package;
7. prints the compared numbers beside their limits on standard error, and
   the result as the last line of standard output: the cell's end-to-end
   metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``,
   and under ``host`` the host's speed at the window's start and end
   (``host_speed``): the numbers of a host-bound cell follow it.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PROCESS_START = time.perf_counter()

# one thread for the host's math libraries, set before they load: a run is one process with few threads, so
# that other work on the machine's cores moves its numbers less
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

PACKAGE_DIR = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mind_the_gaps_tpu"})

__all__ = ["main", "run_cell", "context", "load_cell", "load_module", "forbidden_modules"]


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def _find(dirs, kind: str, name: str, suffix: str) -> Path:
    for d in dirs:
        path = Path(d) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under {[str(d) for d in dirs]}")


def load_module(dirs, kind: str, name: str):
    """The module ``<dir>/<kind>/<name>.py`` from the first of ``dirs`` that
    has it (a metric's name may hold dots, so it is loaded by path)."""
    path = _find(dirs, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"gpbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, dirs) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json``: its entry, configuration,
    traffic, limits and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"gpbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(_find(dirs, "traffic", cell["traffic"], ".json").read_text())
    limits = json.loads(_find(dirs, "limits", name, ".json").read_text())
    return SimpleNamespace(
        name=name, chips=int(cell["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    import torch

    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return f"{name}, {out.stdout.strip() or 'power limit not read'}"
    except (OSError, subprocess.SubprocessError):
        return f"{name}, power limit not read"


def host_speed() -> dict:
    """The host's speed now: the milliseconds of a fixed piece of Python
    work (the kind of work that issues the port's launches) and the mean
    clock of the cores in ``/proc/cpuinfo`` (None where it cannot be read)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    probe_ms = 1e3 * (time.perf_counter() - t0)
    try:
        mhz = [float(line.split(":")[1]) for line in Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
    except OSError:
        mhz = []
    return {"probe_ms": probe_ms, "cpu_mhz": sum(mhz) / len(mhz) if mhz else None}


def context(workload: str, seed: int, seconds: float, trace: bool, *, root, device, dirs=(), overrides=None,
            control: bool = False, mesh=None):
    """(the run's context, the cell's driver, the calls of a turn) before the
    set-up: the cell, its files merged with ``overrides``, and the run's
    settings.  ``mesh``: the processes' mesh of a rank (``ranks.py``), None
    in a run of one process."""
    root = Path(root)
    dirs = [Path(d) for d in dirs] + [PACKAGE_DIR]
    cell = load_cell(workload, root, dirs)
    for key, extra in (overrides or {}).items():
        getattr(cell, key).update(extra)
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), device=device, mesh=mesh, control=control,
                          dirs=dirs, records=[], traced=None, state=None)
    driver = load_module(dirs, "drivers", cell.traffic["driver"])
    return ctx, driver, int(getattr(driver, "CALLS_PER_TURN", 1))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root=".", device=None, dirs=(),
             overrides=None, control: bool = False, process_start: float = None) -> dict:
    """One run of a cell; returns the result (the last line's object).

    ``device``: "cuda" (the first card) or "cpu" (tests: the plain versions
    of the port's kernels).  ``dirs``: directories searched for traffic,
    limits, drivers and metrics before this package's.  ``overrides``:
    {"config": {...}, "traffic": {...}, "limits": {...}} merged over the
    files' values (the tests' small sizes).  ``control``: run the cell's
    control in place of the program (see ``drivers/``)."""
    import torch

    device = torch.device(device or "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    ctx, driver, turn = context(workload, seed, seconds, trace, root=root, device=device, dirs=dirs,
                                overrides=overrides, control=control)
    driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.host = {"start": host_speed()}
    start = PROCESS_START if process_start is None else process_start
    t0 = time.perf_counter()
    ctx.setup_s = t0 - start
    failed = 0
    while not failed and time.perf_counter() - t0 < ctx.seconds:
        for _ in range(turn):
            try:
                t_call = time.perf_counter()
                ctx.records.append(driver.call(ctx, len(ctx.records)))
                ctx.records[-1]["call_s"] = time.perf_counter() - t_call
            except Exception as exc:  # a call that raises ends the window and the run is not correct
                failed += 1
                print(f"gpbench: call {len(ctx.records)} raised {type(exc).__name__}: {exc}", file=sys.stderr)
                break
    ctx.window_s = time.perf_counter() - t0
    ctx.host["end"] = host_speed()
    ctx.failed = failed
    ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if ctx.trace and not failed:
        _traced_turn(ctx, driver, turn)
    _free(ctx, driver)
    return _result(ctx, driver, _metric_values(ctx, ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end))


def _traced_turn(ctx, driver, turn: int):
    """One more turn of calls under the profiler (on a card), not counted in
    the window."""
    from gpbench.trace import Trace, busy_seconds, profile_call

    def calls():
        return [driver.call(ctx, len(ctx.records) + i) for i in range(turn)]

    if ctx.device.type == "cuda":
        records, trace = profile_call(calls, ctx.device)
    else:  # a host run has no device trace: the calls run, the trace is empty
        t0 = time.perf_counter()
        records = calls()
        trace = Trace(window_s=time.perf_counter() - t0)
    ctx.traced = SimpleNamespace(records=records, trace=trace, busy_s=busy_seconds(trace.device),
                                 window_s=trace.window_s)


def _metric_values(ctx, metrics):
    out = {}
    for m in metrics:
        value = load_module(ctx.dirs, "metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _free(ctx, driver):
    """Drop the program's state once the window and the traced turn are over."""
    import torch

    driver.free(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _result(ctx, driver, metrics: dict) -> dict:
    """The result line's object of a run whose state is freed: ``correct``
    from the driver's check, beside ``metrics`` (the values to report)."""
    import torch

    from gpbench.trace import device_ops, idle_gaps

    t0 = time.perf_counter()
    checks, problems = driver.check(ctx) if ctx.records else ({}, ["no call completed in the window"])
    calls = ", ".join(f"{r['call_s']:.3f}" for r in ctx.records)
    print(f"gpbench: set-up {ctx.setup_s:.3f} s, {len(ctx.records)} calls in {ctx.window_s:.3f} s ({calls}), "
          f"check {time.perf_counter() - t0:.3f} s; host speed {ctx.host}", file=sys.stderr)
    correct = not ctx.failed and not problems and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    for p in problems:
        print(f"gpbench: {p}", file=sys.stderr)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": len(ctx.records) + ctx.failed, "failed": ctx.failed,
              "metrics": metrics, "device": device}
    if ctx.trace and ctx.traced is not None:
        device["busy_s"], device["window_s"] = ctx.traced.busy_s, ctx.traced.window_s
        result["breakdown"] = {"device_ops": device_ops(ctx.traced.trace.device),
                               "idle_gaps": idle_gaps(ctx.traced.trace)}
    if ctx.device.type == "cuda":
        result["card"] = _card(ctx.device)
    result["host"] = ctx.host
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m gpbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    root = Path.cwd()
    cell = load_cell(args.workload, root, [PACKAGE_DIR])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    if cell.chips == 1:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=root)
    else:
        from gpbench.ranks import launch

        rc, result = launch(args.workload, args.seed, args.seconds, bool(args.trace), ranks=cell.config["ranks"],
                            root=root, start=PROCESS_START)
        if rc:
            return rc
    found = forbidden_modules()
    if found:
        print(f"gpbench: the process holds JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
