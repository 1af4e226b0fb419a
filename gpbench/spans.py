"""The port's spans laid over the profiler's trace.

The port records a span for each program step while a ``torch.profiler``
session runs (``mind_the_gaps_tpu_torch.tracing``), on the clock of the
profiler's events, so the traced turn's device gaps can be put down to the
step the host was in.  ``program_spans`` reads them from the port (None
where the port has no ``tracing`` module, as before it had one); the rest
are pure reductions on plain lists, as in ``trace.py``: spans as (name,
start s, end s, id, parent id) tuples (parent None for a root) and a
``trace.Trace``, so the tests feed them canned spans.
"""
from __future__ import annotations

from gpbench.trace import busy_intervals

__all__ = ["program_spans", "traced_spans", "within", "idle_intervals", "idle_inside", "host_seconds",
           "innermost", "idle_by_span"]


def program_spans():
    """The spans the port has recorded, as plain tuples; None where the port
    records none (it has no ``tracing`` module)."""
    try:
        from mind_the_gaps_tpu_torch import tracing
    except ImportError:
        return None
    return [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9, s.id, s.parent) for s in tracing.spans()]


def within(spans, trace):
    """The spans that overlap the trace's extent (its first event's start to
    its last event's end)."""
    events = trace.device + trace.host
    if not events:
        return []
    lo, hi = min(s for _, s, _ in events), max(e for _, _, e in events)
    return [sp for sp in spans if sp[2] > lo and sp[1] < hi]


def traced_spans(ctx):
    """The port's spans within a run's traced turn; None without a device
    trace or without spans there."""
    traced = getattr(ctx, "traced", None)
    if traced is None or not traced.trace.device:
        return None
    spans = program_spans()
    if spans is None:
        return None
    return within(spans, traced.trace) or None


def idle_intervals(busy, lo: float, hi: float):
    """The gaps in ``busy`` (sorted, disjoint (start, end)) within [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if e <= t:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = e
    if t < hi:
        out.append((t, hi))
    return out


def _overlap(a, b) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(spans, trace, names):
    """Seconds inside the spans named in ``names`` (their union) in which no
    device activity ran; None where no span has such a name."""
    inside = busy_intervals([sp[:3] for sp in spans if sp[0] in names])  # their union
    if not inside:
        return None
    return sum(e - s for s, e in inside) - _overlap(inside, busy_intervals(trace.device))


def host_seconds(spans, names):
    """The summed durations of the spans named in ``names``; None where no
    span has such a name."""
    found = [e - s for name, s, e, *_ in spans if name in names]
    return sum(found) if found else None


def innermost(spans):
    """Disjoint pieces (start, end, name, is_root) of the spans' extent, each
    put down to the innermost span open over it (the spans of one thread
    nest); time outside every span is left out."""
    pieces, stack, cursor = [], [], None  # stack: (end, name, is_root) of the open spans
    for name, s, e, _, parent in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][0] <= s:
            end, top, root = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, top, root))
            cursor = max(cursor, end)
        if stack and s > cursor:
            pieces.append((cursor, s, stack[-1][1], stack[-1][2]))
        stack.append((e, name, parent is None))
        cursor = s
    while stack:
        end, top, root = stack.pop()
        if end > cursor:
            pieces.append((cursor, end, top, root))
        cursor = max(cursor, end)
    return pieces


def idle_by_span(spans, trace):
    """The device's idle seconds from the traced turn's first event to its
    last, each put down to the innermost span the host was in (the span's
    self time): ({name: seconds}, seconds whose innermost span is a root,
    seconds outside every span)."""
    events = trace.device + trace.host
    if not events:
        return {}, 0.0, 0.0
    lo = min([s for _, s, _ in events] + [sp[1] for sp in spans])
    hi = max([e for _, _, e in events] + [sp[2] for sp in spans])
    idle = idle_intervals(busy_intervals(trace.device), lo, hi)
    by_name, at_root, i = {}, 0.0, 0
    for s, e, name, root in innermost(spans):
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            part = min(e, idle[j][1]) - max(s, idle[j][0])
            if part > 0:
                if root:
                    at_root += part
                else:
                    by_name[name] = by_name.get(name, 0.0) + part
            j += 1
    outside = sum(e - s for s, e in idle) - at_root - sum(by_name.values())
    return by_name, at_root, outside
