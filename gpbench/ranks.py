"""The rank path: a cell whose configuration states ``ranks`` runs as that
many processes of this Python on one host, one a card, as users run the
port over a node (``torchrun --nproc-per-node 4``).

``run.main`` calls ``launch`` for a cell of more than one card.  The
launcher builds the kernel libraries that the cell's driver names (its
``libraries(config)``; every library of the port for a driver that names
none) once, so that a cold checkout runs ``nvcc`` once, not once a rank;
then it starts ``python -m gpbench.ranks``
once a rank with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR=127.0.0.1`` and a free local ``MASTER_PORT``, and watches
them: if a rank exits with another code than 0, or the ranks run past
``--seconds`` + ``SETUP_ALLOWANCE_S``, it kills every rank still running and
returns that code (1 for the limit) with no result.  Gloo's own timeout
(30 minutes) is never waited for.  A rank dies with the launcher (Linux's
``PR_SET_PDEATHSIG``), so none outlives a launcher that was killed.

Each rank (``run_rank``) joins the group (``parallel.initialize``: on a
card, ``cuda:LOCAL_RANK``) and runs ``run.py``'s steps with
``ctx.mesh = parallel.process_mesh()``:

- set-up: the driver's, over the mesh (the bootstrap driver: rank 0 runs
  the observed fits and the others receive the posteriors; then every rank
  makes the same warm-up call), then a barrier.  ``setup_s`` is rank 0's,
  from the launcher's start to the window's start: the ranks' start is
  the user's to pay;
- window: before each turn rank 0 decides by its own clock whether the
  window is still under ``--seconds`` and broadcasts the decision, so every
  rank makes the same calls.  A call that raises ends its rank (exit 1),
  and with it the run;
- with ``--trace 1``, every rank traces one more turn on its own card, with
  the benchmark's timer around ``lrt.process_any`` (the early stop's vote
  over the processes; read by ``mesh_wait_ms_per_step``);
- every rank reads its peak memory, frees the program's state, reads its
  own metrics and looks for JAX in its ``sys.modules``; rank 0 gathers all
  of it (``all_gather_object`` over gloo), exits 4 if any rank holds JAX,
  judges ``correct`` from its own records (every rank's calls return the
  whole, gathered result), and hands the result to the launcher, which
  alone prints.

Each metric's value over the ranks is reduced as its reader's
``OVER_RANKS`` says (``over_ranks``): "mean" (times, idle shares, roofline
shares; the default), "sum" (counts of work that each rank does for its
own rows) or "rank0" (rank 0's: the window's rates and ``setup_s``, and
counts that every rank makes alike).  ``device.count`` is the ranks',
``memory_peak_bytes`` the fullest card's, ``busy_s`` the mean over the
ranks' traces, ``window_s`` rank 0's traced turn; ``breakdown`` is rank
0's trace.  ``per_rank`` holds each rank's own readings.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from gpbench.run import PACKAGE_DIR, _free, _metric_values, _result, _traced_turn, context, forbidden_modules, \
    host_speed, load_cell, load_module

__all__ = ["launch", "run_rank", "over_ranks", "reduction", "SETUP_ALLOWANCE_S"]

# the ranks' start, set-up, traced turn and check, beyond --seconds: the limit of a run's ranks (on four H100s a
# warm set-up of gauss4.bootstrap takes 33-41 s, its traced turn ~10 s, its check 18-28 s)
SETUP_ALLOWANCE_S = 240.0
POLL_S = 0.05
_SPEC, _LAUNCHER = "GPBENCH_RANK_SPEC", "GPBENCH_LAUNCHER_PID"
_PR_SET_PDEATHSIG = 1
REDUCTIONS = {"mean": lambda v: sum(v) / len(v), "sum": sum, "rank0": lambda v: v[0]}


def reduction(reader) -> str:
    """A metric reader's reduction over ranks: its ``OVER_RANKS``, "mean"
    where it states none."""
    return getattr(reader, "OVER_RANKS", "mean")


def over_ranks(how: str, values):
    """One value from each rank's (in rank order) by the reduction ``how``;
    None where some rank read nothing."""
    if any(v is None for v in values):
        return None
    return REDUCTIONS[how](values)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _terminated(signum, frame):
    raise SystemExit(128 + signum)  # the launcher's finally ends the ranks


def _watch(procs, limit_s: float) -> int:
    """Wait for every rank: 0 when each exited with 0; else the first other
    code seen (1 for a signal or for ``limit_s`` passed)."""
    deadline = time.monotonic() + limit_s
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                print(f"gpbench: rank {rank} exited with {code}; ending the other ranks", file=sys.stderr)
                return code if code > 0 else 1
        if all(code == 0 for code in codes):
            return 0
        if time.monotonic() > deadline:
            print(f"gpbench: the ranks ran past the launcher's limit of {limit_s:.0f} s; ending them", file=sys.stderr)
            return 1
        time.sleep(POLL_S)


def launch(workload: str, seed: int, seconds: float, trace: bool, *, ranks: int, root=".", device: str = "cuda",
           overrides=None, plants=(), start: float = None, limit_s: float = None):
    """Run the cell ``workload`` as ``ranks`` processes on this host; returns
    (exit code, rank 0's result or None).

    ``device``: "cuda" (rank r on ``cuda:r`` modulo the cards: four ranks may
    share one card) or "cpu" (tests: gloo ranks on the host with the port's
    plain versions).  ``overrides``: as ``run.run_cell``'s.
    ``plants``: "module:function" names each rank calls before it starts
    (a fault of ``faults.py``, a test's).  ``start``: the ``perf_counter``
    reading at which ``setup_s`` starts (by default now).  ``limit_s``: the
    ranks' wall limit, by default ``seconds + SETUP_ALLOWANCE_S``."""
    start = time.perf_counter() if start is None else start
    if device == "cuda":
        from mind_the_gaps_tpu_torch.ops import _build

        cell = load_cell(workload, Path(root), [PACKAGE_DIR])
        libraries = getattr(load_module([PACKAGE_DIR], "drivers", cell.traffic["driver"]), "libraries", None)
        _build.build(*(libraries(cell.config) if libraries else sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))))
    limit_s = float(seconds) + SETUP_ALLOWANCE_S if limit_s is None else float(limit_s)
    fd, result_path = tempfile.mkstemp(prefix="gpbench-rank0-", suffix=".json")
    os.close(fd)
    spec = {"workload": workload, "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
            "root": str(Path(root).resolve()), "device": device, "overrides": overrides or {},
            "plants": list(plants), "result": result_path,
            "start": time.monotonic() - (time.perf_counter() - start)}
    env = dict(os.environ, WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               **{_SPEC: json.dumps(spec), _LAUNCHER: str(os.getpid())})
    procs, result = [], None
    previous = signal.signal(signal.SIGTERM, _terminated)
    try:
        for rank in range(ranks):
            # a rank's standard output goes to standard error: the launcher's carries the result alone
            procs.append(subprocess.Popen([sys.executable, "-m", "gpbench.ranks"], cwd=PACKAGE_DIR.parent,
                                          env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=2))
        rc = _watch(procs, limit_s)
        text = Path(result_path).read_text() if rc == 0 else ""
        if rc == 0 and not text:
            print("gpbench: rank 0 exited with 0 and wrote no result", file=sys.stderr)
            rc = 1
        result = json.loads(text) if rc == 0 else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, previous)
        os.unlink(result_path)
    return rc, result


@contextlib.contextmanager
def _timed(module, name: str):
    """The seconds of each call of ``module.<name>`` (host clock) while the
    block runs, in the list it yields."""
    inner, seconds = getattr(module, name), []

    @functools.wraps(inner)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, inner)


def _from_rank0(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)])
    dist.broadcast(t, 0)
    return bool(t.item())


def run_rank(spec: dict) -> int:
    """One rank of a launched run (see the module's docstring); the exit code."""
    import torch
    import torch.distributed as dist

    from mind_the_gaps_tpu_torch import lrt, parallel

    for plant in spec["plants"]:
        module, name = plant.split(":")
        getattr(importlib.import_module(module), name)()
    device = parallel.initialize(device=spec["device"])
    rank, world = dist.get_rank(), dist.get_world_size()
    ctx, driver, turn = context(spec["workload"], spec["seed"], spec["seconds"], spec["trace"], root=spec["root"],
                                device=device, overrides=spec["overrides"], mesh=parallel.process_mesh())
    driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    ctx.host = {"start": host_speed()}
    t0 = time.perf_counter()
    ctx.setup_s = time.monotonic() - spec["start"]
    while _from_rank0(rank == 0 and time.perf_counter() - t0 < ctx.seconds):
        for _ in range(turn):
            t_call = time.perf_counter()
            ctx.records.append(driver.call(ctx, len(ctx.records)))
            ctx.records[-1]["call_s"] = time.perf_counter() - t_call
    ctx.window_s = time.perf_counter() - t0
    ctx.host["end"] = host_speed()
    ctx.failed = 0
    ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if ctx.trace:
        with _timed(lrt, "process_any") as votes:
            _traced_turn(ctx, driver, turn)
        ctx.traced.process_any_s = votes
    _free(ctx, driver)
    metrics = ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end
    mine = {"metrics": {name: v["value"] for name, v in _metric_values(ctx, metrics).items()},
            "memory_peak_bytes": int(ctx.memory_peak_bytes),
            "busy_s": None if ctx.traced is None else ctx.traced.busy_s, "forbidden": forbidden_modules()}
    everyone = [None] * world
    dist.all_gather_object(everyone, mine)
    parallel.shutdown()
    if rank != 0:
        return 0
    found = sorted({name for e in everyone for name in e["forbidden"]})
    if found:
        print(f"gpbench: a rank holds JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 4
    reduced = {}
    for m in metrics:
        value = over_ranks(reduction(load_module(ctx.dirs, "metrics", m["name"])),
                           [e["metrics"].get(m["name"]) for e in everyone])
        if value is not None:
            reduced[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = _result(ctx, driver, reduced)
    result["device"].update(count=world, memory_peak_bytes=max(e["memory_peak_bytes"] for e in everyone))
    if "busy_s" in result["device"]:
        result["device"]["busy_s"] = over_ranks("mean", [e["busy_s"] for e in everyone])
    checks = result.pop("checks")
    result["per_rank"] = [{k: e[k] for k in ("metrics", "memory_peak_bytes", "busy_s")} for e in everyone]
    result["checks"] = checks
    Path(spec["result"]).write_text(json.dumps(result))
    return 0


def _end_with(launcher: int):
    """Have the kernel kill this process when the launcher ends, and stop
    here if it has ended already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):  # not Linux: the launcher's finally is the only guard
        pass
    if os.getppid() != launcher:
        raise SystemExit("gpbench: the launcher ended before this rank started")


def main() -> int:
    _end_with(int(os.environ[_LAUNCHER]))
    return run_rank(json.loads(os.environ[_SPEC]))


if __name__ == "__main__":
    sys.exit(main())
