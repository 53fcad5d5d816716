"""CPU tests of the per-layer metrics that read the program's spans
(``perfbench/spanread.py`` and the seven readers): each on synthetic spans
and a synthetic trace, each reading None with nothing recorded, and the
engine's idle time adding up with the idle outside it to the traced idle
share."""
import sys

import numpy as np
import pytest

from perfbench import harness, trace

harness.use_program()
from repro_torch.telemetry import spans  # noqa: E402
from repro_torch.telemetry.spans import SpanRecord  # noqa: E402

SERVE = ("engine_host_ms.serve", "decode_launch_ms.serve",
         "batch_occupancy.serve", "engine_idle_ms.serve")
TRAIN = ("fwd_ms.train", "bwd_ms.train", "adamw_ms.train")
CELL = {"engine": {"max_batch": 16}}


class _Spans:
    """Synthetic spans, each a child of the span it is given."""

    def __init__(self):
        self.recs = []

    def add(self, name, s, e, parent=None, **attrs):
        device_ms = attrs.pop("device_ms", None)
        r = SpanRecord(name, s, e, len(self.recs) + 1,
                       None if parent is None else parent.id, attrs=attrs,
                       device_ms=device_ms)
        self.recs.append(r)
        return r


def _serve_spans():
    sp = _Spans()
    sp.add("engine.step", 0, 500)                     # before the trace
    st = sp.add("engine.step", 1_000, 11_000)
    sp.add("engine.admit", 1_000, 1_500, st)
    pc = sp.add("engine.prefill_chunks", 1_500, 6_000, st)
    sp.add("engine.wait", 4_000, 6_000, pc)
    d = sp.add("engine.decode", 6_000, 9_000, st, rows=12)
    sp.add("engine.wait", 8_000, 9_000, d)
    sp.add("engine.bookkeeping", 9_000, 11_000, st)
    st = sp.add("engine.step", 12_000, 20_000)
    d = sp.add("engine.decode", 12_000, 18_000, st, rows=16)
    sp.add("engine.wait", 15_000, 18_000, d)
    sp.add("engine.wait", 11_000, 12_000)             # outside any step
    return sp.recs


DEVICE = [("k", 1_200, 1_400), ("k", 2_000, 5_000), ("k", 6_500, 8_500),
          ("k", 12_500, 13_000)]


def _trace():
    return trace.Trace(device=list(DEVICE), wall_s=21e-6, pad_survived=True)


def _run(counters, t=None):
    return harness.Run(CELL, {}, counters, t)


@pytest.fixture
def recorded(monkeypatch):
    def put(recs):
        monkeypatch.setattr(spans, "snapshot", lambda: list(recs))
    return put


def test_serve_readers_on_synthetic_spans(recorded):
    recorded(_serve_spans())
    run = _run({"traced_steps": [None, None]}, _trace())
    read = {m: harness.metric_reader(m)(run) for m in SERVE}
    # host: step 1 10000 - 2000 - 1000 waited, step 2 8000 - 3000
    assert read["engine_host_ms.serve"] == pytest.approx(6_000 / 1e6)
    # decode enqueue: 3000 - 1000 and 6000 - 3000
    assert read["decode_launch_ms.serve"] == pytest.approx(2_500 / 1e6)
    assert read["batch_occupancy.serve"] == pytest.approx(87.5)
    # idle, outside the waits: [1000, 4000) 800, [6000, 8000) 500,
    # [9000, 11000) 2000, [12000, 15000) 2500, [18000, 20000) 2000
    assert read["engine_idle_ms.serve"] == pytest.approx(3_900 / 1e6)


def test_engine_idle_adds_up_to_the_idle_share(recorded):
    """Idle inside the steps (out of their waits) times the steps, plus the
    idle everywhere else in the traced window, is the idle share of the
    window: counted here on a nanosecond grid."""
    recs = _serve_spans()
    recorded(recs)
    t = _trace()
    idle_ms = harness.metric_reader("engine_idle_ms.serve")(
        _run({"traced_steps": [None, None]}, t))
    wall = round(t.wall_s * 1e9)
    busy = np.zeros(wall, bool)
    for _, s, e in t.device:
        busy[s:e] = True
    inside = np.zeros(wall, bool)
    steps = [r for r in recs if r.name == "engine.step"][-2:]
    for st in steps:
        inside[st.start_ns:st.end_ns] = True
    for r in recs:
        if r.name == "engine.wait":
            inside[r.start_ns:r.end_ns] = False
    outside = int((~busy & ~inside).sum())
    assert idle_ms * 1e6 * len(steps) + outside == pytest.approx(
        trace.idle_share(t) / 100 * wall)


def test_train_readers_average_the_device_time_of_the_traced_steps(recorded):
    sp = _Spans()
    old = sp.add("train.step", 0, 10)
    sp.add("train.forward", 0, 5, old, device_ms=999.0)
    for i, (f, b, o) in enumerate(((200.0, 400.0, 100.0),
                                   (220.0, 420.0, 110.0))):
        st = sp.add("train.step", 100 + 50 * i, 140 + 50 * i)
        sp.add("train.forward", 100 + 50 * i, 110 + 50 * i, st, device_ms=f)
        sp.add("train.backward", 110 + 50 * i, 130 + 50 * i, st,
               device_ms=b)
        sp.add("train.optimizer", 130 + 50 * i, 140 + 50 * i, st,
               device_ms=o)
    recorded(sp.recs)
    run = _run({"traced_steps": 2})
    got = {m: harness.metric_reader(m)(run) for m in TRAIN}
    assert got == {"fwd_ms.train": 210.0, "bwd_ms.train": 410.0,
                   "adamw_ms.train": 105.0}
    # a phase whose events have not completed (or that has none) reads None
    sp.recs[-1].device_ms = None
    assert harness.metric_reader("adamw_ms.train")(run) is None
    assert harness.metric_reader("fwd_ms.train")(run) == 210.0


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_each_reader_reads_none_with_nothing_recorded(metric, recorded,
                                                      monkeypatch):
    read = harness.metric_reader(metric)
    counters = {"traced_steps": 2 if metric in TRAIN else [None, None]}
    recorded([])
    assert read(_run(counters, _trace())) is None
    # spans, but fewer traced steps than the runner counted
    recorded(_serve_spans()[1:3])
    assert read(_run(counters, _trace())) is None
    # no traced steps counted
    recorded(_serve_spans())
    assert read(_run({"traced_steps": []}, _trace())) is None
    # a program with no span recorder
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry.spans", None)
    import repro_torch.telemetry as tele
    monkeypatch.delattr(tele, "spans")
    assert read(_run(counters, _trace())) is None


def test_engine_idle_reads_none_without_a_trace(recorded):
    recorded(_serve_spans())
    read = harness.metric_reader("engine_idle_ms.serve")
    assert read(_run({"traced_steps": [None, None]}, None)) is None
    assert read(_run({"traced_steps": [None, None]},
                     trace.Trace(wall_s=1.0))) is None
