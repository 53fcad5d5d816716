"""Spans of the port's own layers, kept in memory on the profiler's clock.

A span is a named interval of the host's work: its start and end in
nanoseconds, its own id, the id of the span open around it on the same
thread (its parent), an optional request id and a few attributes.  The
engine and the Trainer open spans at their layer boundaries
(``engine.step``, ``engine.decode``, ``train.forward``, ...; the README's
"Tracing the port" lists them).

**When it records.**  While :func:`enable` is in force, or while a
``torch.profiler`` is recording on the calling thread
(``torch.autograd._profiler_enabled``).  Otherwise :func:`span` returns
one shared no-op after that one check: it reads no clock and keeps
nothing.

**Clock.**  Timestamps are wall-clock nanoseconds, the clock on which the
profiler stamps its host and device events (kineto's ``start_ns``), so a
span can be set against a trace directly.  They are taken as
``perf_counter_ns`` plus one offset to ``time.time_ns``, measured when
recording turns on: at the first span after :func:`reset` or after a
span found recording off.  The callers' own ``time.perf_counter()``
readings can therefore open and close spans.

**Not profiler ranges.**  Spans are never ``record_function`` ranges: the
profiler draws a copy of every such range on the device's timeline,
where it would read as device work.

**Device time.**  A span given a CUDA ``device`` also records a pair of
``torch.cuda.Event`` on that device's current stream; their elapsed
time is read in :func:`snapshot` once both have completed.  No span waits
for the device.

**Counters.**  :func:`count` adds to a named host counter in
:data:`COUNTS`, recording or not: the callers count what they already
hold on the host (the MoE layer's routed pairs, ``models/moe.py``), and a
reader takes the difference over the steps it reads.

**Buffer.**  At most ``capacity`` spans (65,536) are kept; the oldest go
first and :attr:`Recorder.dropped` counts them.  :func:`snapshot` returns
them without draining, :func:`export_chrome` writes them as Chrome-trace
JSON.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

CAPACITY = 65_536
_profiler_enabled = torch.autograd._profiler_enabled


@dataclass(slots=True)
class SpanRecord:
    """One finished span.  ``device_ms`` is the elapsed time of its CUDA
    events, None until they have completed (or where it has none)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    rid: Optional[int] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    tid: int = 0
    device_ms: Optional[float] = None
    events: Any = None


class _Off:
    """The span of a recorder that is not recording: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def close(self, end: Optional[float] = None) -> None:
        return None


OFF = _Off()


class Span:
    """An open span.  ``close(end)`` ends it at ``end`` (a
    ``time.perf_counter()`` reading; default now); leaving its ``with``
    block closes it if it is still open."""
    __slots__ = ("_rec", "name", "start_ns", "id", "parent", "rid", "attrs",
                 "events", "_offset", "_open")

    def __init__(self, rec: "Recorder", name, start, sid, parent, rid,
                 attrs, events):
        self._rec, self.name = rec, name
        # both ends on the offset of the span's opening: its length is
        # exactly the difference of the two readings
        self._offset = rec._offset_ns
        self.start_ns = _perf_ns(start) + self._offset
        self.id, self.parent, self.rid = sid, parent, rid
        self.attrs, self.events, self._open = attrs, events, True

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, end: Optional[float] = None) -> None:
        if not self._open:
            return
        self._open = False
        rec = self._rec
        end_ns = _perf_ns(end) + self._offset
        if self.events is not None:
            self.events[1].record(self.events[2])
        stack = rec._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:
            stack.remove(self.id)
        rec._append(SpanRecord(
            self.name, self.start_ns, end_ns, self.id, self.parent, self.rid,
            self.attrs, threading.get_native_id(),
            events=None if self.events is None else self.events[:2]))


def _perf_ns(t: Optional[float]) -> int:
    """A ``time.perf_counter()`` reading (None: now) in nanoseconds."""
    return time.perf_counter_ns() if t is None else round(t * 1e9)


def _clock_offset_ns() -> int:
    """``time_ns - perf_counter_ns`` now, from the tightest of three
    bracketed readings."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class Recorder:
    """The buffer, the clock and the per-thread stacks of open spans."""

    def __init__(self, capacity: int = CAPACITY):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.forced = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._offset_ns = 0
        self._on = False            # the offset is this stretch's

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)

    def span(self, name: str, start: Optional[float] = None, *,
             rid: Optional[int] = None, device=None, **attrs):
        """Open a span (``start``: a ``time.perf_counter()`` reading,
        default now) as the child of the thread's innermost open span.
        ``device``: record CUDA events on it too, where it is a CUDA
        device.  Returns :data:`OFF` when not recording."""
        if not (self.forced or _profiler_enabled()):
            self._on = False
            return OFF
        if not self._on:
            self._offset_ns = _clock_offset_ns()
            self._on = True
        events = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True), stream)
            events[0].record(stream)
        stack = self._stack()
        sid = next(self._ids)
        sp = Span(self, name, start, sid, stack[-1] if stack else None,
                  rid, attrs, events)
        stack.append(sid)
        return sp

    def snapshot(self) -> List[SpanRecord]:
        """Every kept span, oldest first (the buffer is not drained), each
        ``device_ms`` read where its events have completed."""
        with self._lock:
            recs = list(self._buf)
        for r in recs:
            if r.events is not None and r.events[1].query():
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                r.events = None
        return recs

    def export_chrome(self, path) -> None:
        """Write the kept spans as Chrome-trace JSON (complete events, ``ts``
        in wall-clock microseconds, the process and thread ids the profiler
        gives its host events)."""
        pid = os.getpid()
        events = []
        for r in self.snapshot():
            args = dict(r.attrs, id=r.id, parent=r.parent)
            if r.rid is not None:
                args["rid"] = r.rid
            if r.device_ms is not None:
                args["device_ms"] = r.device_ms
            events.append({"ph": "X", "cat": "span", "name": r.name,
                           "pid": pid, "tid": r.tid, "ts": r.start_ns / 1e3,
                           "dur": (r.end_ns - r.start_ns) / 1e3,
                           "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": 0}, f)

    def reset(self) -> None:
        """Drop every kept span and the count of dropped ones; the next
        span measures the clock's offset again."""
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._on = False


COUNTS: Dict[str, int] = collections.Counter()


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] += int(n)


RECORDER = Recorder()
span = RECORDER.span
snapshot = RECORDER.snapshot
export_chrome = RECORDER.export_chrome
reset = RECORDER.reset


class _Enabled:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        disable()


def enable() -> _Enabled:
    """Record from now on, profiler or not, until :func:`disable` (or
    the end of ``with enable():``)."""
    RECORDER.forced = True
    return _Enabled()


def disable() -> None:
    RECORDER.forced = False
