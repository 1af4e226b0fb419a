"""Spans of the port's program steps, on the profiler's host clock.

An operator who profiles a call of the port with ``torch.profiler`` gets,
beside the profiler's own events, one span for each program step the call
ran: its name, start and end, the span that caused it (its parent), the
root call it belongs to (one a ``protassov_lrt`` or ``derive_posteriors``
call) and a few integer counts.  Read them after the profile::

    from torch.profiler import ProfilerActivity, profile
    from mind_the_gaps_tpu_torch import tracing

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = protassov_lrt(...)
    for s in tracing.spans():
        print(s.name, s.start_ns, s.end_ns, s.parent, s.counts)

and lay them over the profiler's events: both are in nanoseconds on one
clock, so a device gap can be put down to the step the host was in.

**When a span records.**  Only while a ``torch.profiler`` session is active
in the process (``torch.autograd.profiler._is_profiler_enabled``, set and
cleared by the profiler itself).  Otherwise ``span`` returns one shared
no-op context: it reads no clock, makes no span and calls nothing of the
profiler.  There is no switch of its own.  A span never reads a device value, never synchronises
and never changes an operation or its order, so a traced call computes
what an untraced one does, bit for bit.

**The clock.**  Each edge is one read of ``time.perf_counter_ns``
(CLOCK_MONOTONIC), shifted to the profiler's clock by an offset read when a
root span opens.  The profiler stamps its events (``start_ns()`` of
``prof.profiler.kineto_results.events()``) in Unix-epoch nanoseconds, the
clock of ``time.time_ns``, in the CPU build and in the CUDA build: with
torch 2.11.0+cu128 on an H100, a span around a launch contains the
profiler's ``cudaLaunchKernel`` (which starts 7.5-136 us after the span
opens and ends 2.7-44 us before it closes), and one around
``torch.cuda.synchronize`` its ``cudaDeviceSynchronize`` (10-93 us after,
1.6-6.3 us before).

**Cost**, on the host of that H100: 0.52 us a span not recorded, 6.3 us a
span recorded.

**Storage.**  The newest ``MAX_SPANS`` spans are kept in memory, in the
order they closed (``spans()``; ``clear()`` empties the store).  The spans
of one host thread nest; each thread has its own stack of open spans.

``phase`` is a span that also adds its seconds to a ``timings`` dict under
a key, recording or not: the port's phase timers (``LRTResult.timings``,
``GPModelling.timings``) are phases, so the timer and the span read the
same two clock reads.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

__all__ = ["Span", "MAX_SPANS", "span", "phase", "traced", "spans", "clear"]

MAX_SPANS = 1 << 18  # a bootstrap call of 1023 simulations records ~10,000


class Span(NamedTuple):
    name: str
    start_ns: int  # on the profiler's clock (Unix-epoch nanoseconds)
    end_ns: int
    id: int
    parent: int  # the id of the span that caused it; None for a root
    root: int  # the id of its root span
    counts: dict


_store = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_offset = 0  # the profiler's clock less perf_counter_ns, read when a root span opens


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _clock_offset() -> int:
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    return wall - (p0 + p1) // 2


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "timings", "key", "t0", "id", "parent", "root")

    def __init__(self, name, counts, timings=None, key=None):
        self.name, self.counts, self.timings, self.key = name, counts, timings, key

    def __enter__(self):
        global _offset
        self.id = None
        if _profiler._is_profiler_enabled:
            stack = _stack()
            self.id = next(_ids)
            if stack:
                self.parent, self.root = stack[-1].id, stack[-1].root
            else:
                _offset = _clock_offset()
                self.parent, self.root = None, self.id
            stack.append(self)
        self.t0 = time.perf_counter_ns()
        return None if self.id is None else self.counts

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self.timings is not None and exc_type is None:
            self.timings[self.key] = self.timings.get(self.key, 0.0) + (t1 - self.t0) * 1e-9
        if self.id is not None:
            _stack().pop()
            _store.append(Span(self.name, self.t0 + _offset, t1 + _offset, self.id, self.parent, self.root,
                               self.counts))
        return False


def span(name: str, **counts):
    """A context that records the span ``name`` with integer ``counts``
    while a profiler session is active, and does nothing otherwise.  It
    gives its ``with`` block the counts dict while it records (a count
    known only at the block's end is added there), else None."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts)


def phase(name: str, timings: dict, key: str, **counts):
    """``span(name, **counts)`` that also adds its seconds to
    ``timings[key]`` (from 0.0) when its block ends without an exception,
    whether or not it records."""
    return _Span(name, counts, timings, key)


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The recorded spans, oldest first (by closing), as ``Span`` tuples."""
    return list(_store)


def clear() -> None:
    """Forget every recorded span."""
    _store.clear()
