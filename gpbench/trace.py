"""The profiler reading: one call traced with ``torch.profiler``, reduced to
device intervals and host operations.

``profile_call`` runs a function under ``torch.profiler.profile`` (the
pattern of the port's ``ops/layout_sweep.py``) with the CUDA activity
alone, which records the device's activities and the host's CUDA runtime
calls but not every host operation (recording those too took the traced
calls 50-70% longer on the H100), synchronised on both sides, and returns
its result with a ``Trace``: every device activity (kernels, copies, sets)
and every host runtime call as (name, start s, end s) on the profiler's
clock, and the call's wall time.  The reductions below read only that plain
structure, so the tests feed them canned traces.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

__all__ = ["Trace", "profile_call", "busy_intervals", "busy_seconds", "device_ops", "idle_gaps", "celerite_launches"]

SCAN = 256  # host operations looked back over for one gap
_CELERITE = re.compile(r"\b(loglike_kernel|lane_kernel)<(float|double), ?(-?\d+), ?(-?\d+)")


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start, end): kernels, copies, sets
    host: list = field(default_factory=list)  # (name, start, end): the host's CUDA runtime calls
    window_s: float = 0.0  # the traced call's wall time, synchronised


def profile_call(fn, device):
    """(fn(), Trace) of one call of ``fn`` on the card ``device``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    trace = Trace(window_s=window)
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        item = (ev.name(), start, start + ev.duration_ns() * 1e-9)
        (trace.device if ev.device_type() == DeviceType.CUDA else trace.host).append(item)
    trace.device.sort(key=lambda e: e[1])
    trace.host.sort(key=lambda e: e[1])
    return out, trace


def busy_intervals(device, since: float = float("-inf")):
    """The union of the device activities' intervals (after ``since``), as a
    sorted list of disjoint (start, end)."""
    merged = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        s = max(s, since)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(x) for x in merged]


def busy_seconds(device, since: float = float("-inf")) -> float:
    """Seconds in which some device activity ran."""
    return sum(e - s for s, e in busy_intervals(device, since))


def device_ops(device, top: int = 10):
    """[[name, seconds]] of the device activities that took the most time,
    summed by name (names cut to 160 characters)."""
    totals = {}
    for name, s, e in device:
        totals[name[:160]] = totals.get(name[:160], 0.0) + (e - s)
    return [[n, v] for n, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10):
    """[[label, seconds]]: the device's idle time between its first and last
    activity, summed by what the host was doing at each gap's middle (the
    innermost host call there, such as a launch or a synchronisation;
    "host: between runtime calls" where none ran: the host in Python and
    PyTorch's dispatch), the largest ``top``."""
    busy = busy_intervals(trace.device)
    host = sorted(trace.host, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    totals = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = "host: between runtime calls"
        # the latest-starting host operation that still runs at mid is the innermost
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - SCAN), -1):
            if host[i][2] >= mid:
                label = host[i][0][:160]
                break
        totals[label] = totals.get(label, 0.0) + (s1 - e0)
    return [[n, v] for n, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def celerite_launches(device):
    """[(dtype, jr, jc, seconds)] of the celerite likelihood kernel's
    launches, from the kernels' template arguments; a launch of the
    runtime-width body (negative widths) has jr = jc = None."""
    out = []
    for name, s, e in device:
        m = _CELERITE.search(name)
        if m:
            dtype = "float32" if m.group(2) == "float" else "float64"
            jr, jc = int(m.group(3)), int(m.group(4))
            out.append((dtype, jr if jr >= 0 else None, jc if jc >= 0 else None, e - s))
    return out
