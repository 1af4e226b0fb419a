"""The celerite kernel's layouts timed against each other on a card: the
measurement behind ``ops.celerite.team_size``'s crossovers.

    python -m mind_the_gaps_tpu_torch.ops.layout_sweep [--per-sm 4,6,23,46,93,186,496] [--ptxas]
        [--profile DIR]

At each number of likelihoods an SM, the DRW + Lorentzian (R = 3) at N =
5000 on the main path's time grid, in two data layouts: float32 grouped
(the bootstrap's: 6 likelihoods a data column) and float64 one shared
column (the observed sampler's).  Every layout of ``TEAMS`` runs on the
same inputs in turns (each in order, then in the reverse order), each
reading the mean of ``reps`` launches from CUDA events after a warm-up;
a layout's time is the mean of its two readings.  Each layout's values are
held against the plain version on the first rows and against the 8-lane
layout on every row (float32 rtol 1e-4 and atol 1e-2, float64 rtol 1e-10,
the same -inf rows), and the rows whose bits differ from the 8-lane
layout's are counted.

``--ptxas``: registers, spills and shared memory of the R = 3 kernels,
from ``nvcc -Xptxas -v`` (compiled beside the libraries' build).
``--profile DIR``: a ``torch.profiler`` trace of one launch of each layout
at the bench's primary shape (65,536 rows, float32, one shared column)
written to DIR, with each kernel's device time, and the SASS of the float32
library there with the instruction count of each R = 3 kernel
(``cuobjdump``).  The last line printed is JSON.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, build, find_nvcc, library_path
from mind_the_gaps_tpu_torch.ops.celerite import TEAMS, _launch, celerite_log_likelihood_plain, team_size

__all__ = ["inputs", "sweep_point", "ptxas_report", "profile_primary", "sass_report", "PER_SM", "CASES"]

PER_SM = (4, 6, 23, 46, 93, 186, 496)
CASES = (("grouped", torch.float32), ("shared", torch.float64))
WALKERS_A_COLUMN = 6  # the bootstrap's half-step: 12 walkers, 6 a launch
PLAIN_ROWS = 258  # rows held against the plain version (a multiple of 6)


def _kernel():
    return DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)


def inputs(B: int, layout: str, dtype, device="cuda", n: int = 5000, seed: int = 0) -> dict:
    """The keyword arguments of one launch: ``B`` parameter rows about the
    DRW + Lorentzian's vector (5% normals), times ``cumsum(uniform(2, 8))``,
    y = 10 + N(0, 2) as one shared column (``shared``) or one column for
    every 6 rows (``grouped``, B a multiple of 6), diag 0.09, mean 10."""
    rng = np.random.default_rng(seed)
    kernel = _kernel()
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    th = kernel.get_parameter_vector() + 0.05 * rng.normal(size=(B, kernel.ndim))
    rows = (n,) if layout == "shared" else (B // WALKERS_A_COLUMN, n)
    return dict(coeffs=kernel.coefficients(torch.as_tensor(th, dtype=dtype, device=device)),
                t=torch.as_tensor(t, device=device),
                y=torch.as_tensor(10.0 + rng.normal(0.0, 2.0, rows), dtype=dtype, device=device),
                diag=torch.full(rows, 0.09, dtype=dtype, device=device),
                mean=torch.full((B,), 10.0, dtype=dtype, device=device),
                repeats=WALKERS_A_COLUMN if layout == "grouped" else 1)


def _head(args, m):
    """The first ``m`` rows of a launch's arguments."""
    head = dict(args, coeffs=type(args["coeffs"])(*(c[:m] for c in args["coeffs"])), mean=args["mean"][:m])
    if args["y"].dim() == 2:
        head["y"], head["diag"] = args["y"][:m // args["repeats"]], args["diag"][:m // args["repeats"]]
    return head


def _cuda_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_point(B: int, layout: str, dtype, reps: int = 3, device="cuda") -> dict:
    """Every layout at one batch: their times in turns, their largest error
    against the plain version on the first rows, and the rows whose bits
    differ from the 8-lane layout's.  Raises if a layout disagrees with
    the plain version there, or with the 8-lane layout on any row."""
    args = inputs(B, layout, dtype, device)
    outs = {f"L={team}": _launch(**args, team=team) for team in TEAMS}
    m = min(B, PLAIN_ROWS)
    m -= m % args["repeats"]
    ref = celerite_log_likelihood_plain(**_head(args, m)).double()
    finite = torch.isfinite(ref)
    eight = outs["L=8"].double()
    err, differ = {}, {}
    for label, out in outs.items():
        for what, x, y in (("the plain version", out[:m].double(), ref), ("L=8", out.double(), eight)):
            fin = torch.isfinite(y)
            if not torch.equal(torch.isfinite(x), fin):
                raise RuntimeError(f"{label} at B={B} {layout} {dtype}: the -inf rows differ from {what}'s")
            e = (x[fin] - y[fin]).abs()
            tol = 1e-10 * y[fin].abs() if dtype == torch.float64 else 1e-2 + 1e-4 * y[fin].abs()
            if not bool((e <= tol).all()):
                raise RuntimeError(f"{label} at B={B} {layout} {dtype}: disagrees with {what} "
                                   f"(max abs err {float(e.max())})")
        e = (out[:m].double() - ref)[finite].abs()
        err[label] = float(e.max()) if e.numel() else 0.0
        differ[label] = int((out != outs["L=8"]).sum())
    readings = {label: [] for label in outs}
    for team in TEAMS + TEAMS[::-1]:
        readings[f"L={team}"].append(_cuda_ms(lambda: _launch(**args, team=team), reps))
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return dict(layout=layout, dtype=str(dtype).replace("torch.", ""), B=B, per_sm=B / sm_count,
                ms={k: float(np.mean(v)) for k, v in readings.items()}, readings=readings, max_abs_err=err,
                rows_differ_from_8=differ, rule=team_size(B, sm_count, 1, 1))


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def ptxas_report() -> list:
    """[(dtype, kernel, registers, spill stores, spill loads, static shared
    bytes)] of the R = 3 packed kernels (the team bodies and the
    one-thread body) and their dense-S body, from ``nvcc -Xptxas -v``."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                         str(Path(tmp) / f"{name}.so"), str(CSRC_DIR / f"{name}.cu")],
                                        stderr=subprocess.PIPE, text=True)
                 for name in ("celerite_loglike_f32", "celerite_loglike_f64")}
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{err}")
            entries, current = {}, None
            for line in err.splitlines():
                hit = re.search(r"Compiling entry function '(\w+)'", line)
                if hit:
                    current = hit.group(1)
                    entries[current] = {}
                elif current:
                    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                    if spill:
                        entries[current]["spills"] = (int(spill.group(1)), int(spill.group(2)))
                    used = re.search(r"Used (\d+) registers", line)
                    if used:
                        smem = re.search(r"(\d+) bytes smem", line)
                        entries[current]["regs"] = int(used.group(1))
                        entries[current]["smem"] = int(smem.group(1)) if smem else 0
            for mangled, readable in zip(entries, _demangle(list(entries))):
                if re.search(r"<(float|double), 1, 1\b", readable):
                    e = entries[mangled]
                    rows.append((name[-3:], readable.split("(")[0], e.get("regs"), *e.get("spills", (None, None)),
                                 e.get("smem")))
    return rows


def profile_primary(out_dir, batch: int = 65_536, device="cuda") -> dict:
    """One launch of each layout at the bench's primary shape under
    ``torch.profiler``: {"kernels": {kernel name: device ms}}; the Chrome
    trace goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    args = inputs(batch, "shared", torch.float32, device)
    for team in TEAMS:
        _launch(**args, team=team)
    torch.cuda.synchronize()
    result = {"kernels": {}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for team in TEAMS:
            _launch(**args, team=team)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / "celerite_layouts_trace.json"))
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ("loglike_kernel" in ev.key or "lane_kernel" in ev.key):
            result["kernels"][ev.key] = dev_us / 1e3 / max(ev.count, 1)
    return result


def sass_report(out_dir) -> list:
    """[(kernel, SASS instructions)] of the R = 3 kernels of the float32
    library (``cuobjdump -sass``); the listing goes to ``out_dir``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library_path("celerite_loglike_f32"))], capture_output=True, text=True,
                          check=True).stdout
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / "celerite_loglike_f32.sass").write_text(text)
    counts, current = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\w+)", line)
        if hit:
            current = hit.group(1)
            counts[current] = 0
        elif current and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[current] += 1
    return [(readable.split("(")[0], counts[m]) for m, readable in zip(counts, _demangle(list(counts)))
            if re.search(r"<float, 1, 1\b", readable)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="The celerite kernel's layouts timed against each other on a card.")
    ap.add_argument("--per-sm", default=",".join(map(str, PER_SM)),
                    help="likelihoods an SM at which to time the layouts (comma-separated)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v for the R = 3 kernels")
    ap.add_argument("--profile", metavar="DIR", help="trace the layouts at the primary shape into DIR, with the "
                    "float32 library's SASS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_sweep times the kernel on a CUDA card")
    name = torch.cuda.get_device_name(0)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    record = {"device": name, "sm_count": sm_count}
    with ThreadPoolExecutor() as pool:
        libs = pool.submit(build, "celerite_loglike_f32", "celerite_loglike_f64")
        report = pool.submit(ptxas_report) if args.ptxas else None
        libs.result()
        record["ptxas"] = report.result() if report else []
    for row in record["ptxas"]:
        print(f"[ptxas] {row[0]} {row[1]}: {row[2]} registers, spill stores {row[3]} B, loads {row[4]} B, static "
              f"smem {row[5]} B", flush=True)
    if args.profile:
        record["profile"] = profile_primary(args.profile)
        for key, ms in record["profile"]["kernels"].items():
            print(f"[profile] {ms:.3f} ms a launch: {key[:160]}", flush=True)
        record["sass"] = sass_report(args.profile)
        for kernel, count in record["sass"]:
            print(f"[sass] {kernel}: {count} instructions", flush=True)
    record["points"] = []
    for per_sm in (int(x) for x in args.per_sm.split(",") if x):
        for layout, dtype in CASES:
            B = per_sm * sm_count
            if layout == "grouped":
                B -= B % WALKERS_A_COLUMN
            row = sweep_point(B, layout, dtype, reps=args.reps)
            record["points"].append(row)
            times = ", ".join(f"{k} {v:.3f} ms" for k, v in row["ms"].items())
            print(f"[sweep] {layout} R=3 {row['dtype']} B={B} ({row['per_sm']:.2f} per SM): {times}; rule "
                  f"L={row['rule']}; rows differing from L=8's bits {row['rows_differ_from_8']}; max abs err "
                  f"against plain {row['max_abs_err']} [{name}]", flush=True)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
