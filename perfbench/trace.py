"""The traced stretch of a run: a padded ``torch.profiler`` trace and the
sums the per-layer metrics read from it.

The tracer drops a trace's first device events, more the longer the
process has run, so every trace opens with ``PAD_KERNELS`` empty spin
kernels (``torch.cuda._sleep``), waited for, before the work; everything up
to the pad's last surviving kernel is dropped from what is read.  A trace
in which no pad kernel survived reads as empty: its metrics are left out.
Busy time is the union of the device events' intervals (kernels, copies,
fills), so overlapping streams count once.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

PAD_KERNELS = 4000
PAD_NAME = "spin_kernel"
SPAN_PREFIX = "perfbench."


@dataclass
class Trace:
    """Device events (name, start ns, end ns) after the pad, in start
    order; host events (name, start ns, end ns); the traced wall seconds
    and the count of units of work (steps) traced."""
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    wall_s: float = 0.0
    pad_survived: bool = False

    @property
    def empty(self) -> bool:
        return not self.pad_survived or not self.device


class Tracer:
    """``start()`` opens the profiler and runs the pad; ``stop()`` waits
    for the device and closes it.  Disabled, both do nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.done = False
        self._prof = None
        self._t0 = 0.0
        self.wall_s = 0.0

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True

    def result(self) -> Optional[Trace]:
        if not self.done:
            return None
        return parse(self._prof, self.wall_s)


def _events(prof):
    """(name, is_device, start ns, end ns) of every event of the trace.
    The benchmark's spans (``SPAN_PREFIX``) are host events wherever the
    tracer draws them: their copies on the device's timeline ran nothing
    there."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = (str(e.device_type()).endswith("CUDA")
               and not name.startswith(SPAN_PREFIX))
        s = e.start_ns()
        out.append((name, dev, s, s + e.duration_ns()))
    return out


def parse(prof, wall_s: float) -> Trace:
    ev = _events(prof)
    device = sorted(((n, s, e) for n, d, s, e in ev if d),
                    key=lambda x: x[1])
    pads = [i for i, x in enumerate(device) if PAD_NAME in x[0]]
    host = sorted(((n, s, e) for n, d, s, e in ev if not d),
                  key=lambda x: x[1])
    if not pads:
        return Trace(wall_s=wall_s)
    after = device[pads[-1] + 1:]
    t_pad = device[pads[-1]][2]
    return Trace(device=after, host=[h for h in host if h[2] > t_pad],
                 wall_s=wall_s, pad_survived=True)


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def busy_seconds(trace: Trace) -> float:
    return union_seconds([(s, e) for _, s, e in trace.device])


def idle_share(trace: Trace) -> Optional[float]:
    """Percent of the traced wall with nothing running on the device."""
    if trace is None or trace.empty or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / trace.wall_s)


def kernel_seconds(trace: Trace, patterns: Sequence[str]) -> Tuple[float, int]:
    """(device seconds, launches) of the events whose name matches any of
    ``patterns`` (regular expressions)."""
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    hits = [(s, e) for n, s, e in trace.device if rx.search(n)]
    return sum(e - s for s, e in hits) / 1e9, len(hits)


def _gaps(trace: Trace, min_ns: int):
    gaps, end = [], None
    for _, s, e in trace.device:
        if end is not None and s - end >= min_ns:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _open_at(events, starts, t: int, look: int = 4000):
    """The latest-starting of ``events`` (sorted by start) open at ``t``,
    among the ``look`` that started last before it."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(events[max(0, i - look):i]):
        if e >= t:
            return name
    return None


def _host_label(spans, ops, t: int) -> str:
    """The benchmark span and the innermost host operation open at
    ``t``; none open means the host ran Python between operations."""
    span = _open_at(spans[0], spans[1], t)
    op = _open_at(ops[0], ops[1], t)
    return f"{span or 'outside spans'}: {op or 'python'}"


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The ``breakdown`` of a result line: device seconds by event name,
    and idle seconds by what the host was doing, each the ``top`` largest."""
    by_name: Dict[str, float] = {}
    for n, s, e in trace.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = [h for h in trace.host if h[0].startswith(SPAN_PREFIX)]
    ops = [h for h in trace.host if not h[0].startswith(SPAN_PREFIX)]
    spans = (spans, [h[1] for h in spans])
    ops = (ops, [h[1] for h in ops])
    gaps = sorted(_gaps(trace, 10_000), key=lambda g: g[0] - g[1])[:2000]
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        label = _host_label(spans, ops, (s + e) // 2)
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e9
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in device_ops],
            "idle_gaps": [[n[:120], v] for n, v in idle]}
