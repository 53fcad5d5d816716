"""The program's own spans (``repro_torch.telemetry.spans``), for the
per-layer metrics that read them.

The recorder records while a ``torch.profiler`` is recording, so a
``--trace 1`` run's traced stretch holds the spans of its traced steps:
the last ``engine.step`` or ``train.step`` spans, as many as the runner
counted (``traced_steps``).  Where the program has no recorder (a
checkout from before it) or recorded fewer of those spans, the readers
read None.  Span times are wall-clock nanoseconds, the profiler's clock,
so they can be set against ``run.trace`` directly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def records() -> Optional[list]:
    """Every span the program kept, or None."""
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    return spans.snapshot() or None


def traced_steps(run, name: str) -> Tuple[Optional[list], Optional[list]]:
    """(every span, the traced steps: the last ``traced_steps`` spans named
    ``name``), or (None, None)."""
    recs = records()
    c = run.counters.get("traced_steps")
    n = len(c) if isinstance(c, (list, tuple)) else int(c or 0)
    if recs is None or n == 0:
        return None, None
    steps = [r for r in recs if r.name == name][-n:]
    return (recs, steps) if len(steps) == n else (None, None)


def descendants(recs, roots, name: str) -> List[list]:
    """For each span of ``roots``, its descendants named ``name``."""
    by_id = {r.id: r for r in recs}
    index = {r.id: i for i, r in enumerate(roots)}
    out: List[list] = [[] for _ in roots]
    for r in recs:
        if r.name != name:
            continue
        p = r.parent
        while p is not None and p not in index:
            up = by_id.get(p)
            p = None if up is None else up.parent
        if p is not None:
            out[index[p]].append(r)
    return out


def minus(span, holes: Sequence) -> List[Tuple[int, int]]:
    """The stretches of ``span`` that no span of ``holes`` covers."""
    out, at = [], span.start_ns
    for h in sorted(holes, key=lambda h: h.start_ns):
        s, e = max(h.start_ns, span.start_ns), min(h.end_ns, span.end_ns)
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if span.end_ns > at:
        out.append((at, span.end_ns))
    return out


def idle_ns(regions: Sequence[Tuple[int, int]], device) -> int:
    """Nanoseconds of ``regions`` (disjoint) in which none of the device
    events ``device`` ((name, start, end), sorted by start) runs."""
    idle = 0
    for a, b in regions:
        busy, end = 0, a
        for _, s, e in device:
            if s >= b:
                break
            s, e = max(s, end), min(e, b)
            if e > s:
                busy += e - s
                end = e
        idle += (b - a) - busy
    return idle


def mean_device_ms(run, phase: str) -> Optional[float]:
    """Mean over the traced ``train.step`` spans of the device ms of their
    ``phase`` descendants (their CUDA events); None where any lacks it."""
    recs, steps = traced_steps(run, "train.step")
    if steps is None:
        return None
    per = descendants(recs, steps, phase)
    if not all(per) or any(r.device_ms is None for rs in per for r in rs):
        return None
    return sum(r.device_ms for rs in per for r in rs) / len(steps)
