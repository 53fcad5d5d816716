"""The port's span recorder (``repro_torch.telemetry.spans``) on the CPU:
off it records nothing and hands out one no-op; spans nest under the
thread's open span and carry request ids; a ``torch.profiler`` turns
recording on and off; the clock's offset is measured once each time
recording turns on; the buffer drops its oldest spans and counts them; a
span's clock is the profiler's (a span encloses the kineto interval of the
op it wraps).  The engine's spans come from the same clock readings as
``decode_step_times`` and ``prefill_s``; the Trainer's step and the mesh
step record their three phases.  This file imports nothing of JAX."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_mesh_train_ranks as R
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine
from repro_torch.telemetry import spans
from repro_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing_and_returns_the_shared_noop():
    a = spans.span("engine.step", step=1)
    b = spans.span("other", device="cpu")
    assert a is spans.OFF and b is spans.OFF
    with a as inner:
        inner.close(2.0)
    assert spans.snapshot() == []


def test_spans_nest_and_carry_request_ids():
    with spans.enable():
        with spans.span("outer", step=3):
            with spans.span("inner", rid=5):
                with spans.span("leaf", rid=5):
                    pass
        with spans.span("second"):
            pass
    assert spans.span("after") is spans.OFF
    recs = {r.name: r for r in spans.snapshot()}
    assert set(recs) == {"outer", "inner", "leaf", "second"}
    assert recs["outer"].parent is None and recs["second"].parent is None
    assert recs["inner"].parent == recs["outer"].id
    assert recs["leaf"].parent == recs["inner"].id
    assert (recs["inner"].rid, recs["leaf"].rid) == (5, 5)
    assert recs["outer"].rid is None
    assert recs["outer"].attrs == {"step": 3}
    o, i = recs["outer"], recs["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    # snapshot does not drain
    assert len(spans.snapshot()) == 4


def test_a_span_closed_at_a_reading_reuses_it():
    with spans.enable():
        t0 = time.perf_counter()
        with spans.span("a", t0, n=4) as sp:
            t1 = time.perf_counter()
            sp.close(t1)
    (r,) = spans.snapshot()
    assert abs((r.end_ns - r.start_ns) / 1e9 - (t1 - t0)) < 1e-6
    assert r.attrs == {"n": 4}


def test_the_profiler_turns_recording_on_and_off():
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("during"):
            torch.ones(4).sum()
    with spans.span("after"):
        pass
    assert [r.name for r in spans.snapshot()] == ["during"]


def test_the_clock_offset_is_measured_once_each_time_recording_turns_on(
        monkeypatch):
    taken = []
    real = spans._clock_offset_ns

    def counted():
        taken.append(real())
        return taken[-1]
    monkeypatch.setattr(spans, "_clock_offset_ns", counted)
    with spans.enable():
        for _ in range(5):
            with spans.span("a"):
                pass
    assert len(taken) == 1
    with spans.span("off"):                 # finds recording off
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("b"):
                pass
    assert len(taken) == 2
    with spans.enable():
        with spans.span("c"):               # no span ran off since
            pass
        spans.reset()
        with spans.span("d"):
            pass
    assert len(taken) == 3
    recs = spans.snapshot()
    assert [r.name for r in recs] == ["d"]
    # the span's wall-clock start is its perf_counter reading plus the
    # offset taken when it opened
    assert abs(recs[0].start_ns - time.time_ns()) < 1e9


def test_the_buffer_drops_the_oldest_and_counts_them():
    rec = spans.Recorder(capacity=4)
    rec.forced = True
    for i in range(6):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.snapshot()] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2
    rec.reset()
    assert rec.snapshot() == [] and rec.dropped == 0


def test_a_span_encloses_the_kineto_interval_of_its_op():
    """The span clock is the profiler's: a span around ``torch.ones(8) +
    1`` holds that ``aten::add``'s kineto interval, to 20 us."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("around"):
            x + 1
    (r,) = spans.snapshot()
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"]
    assert len(adds) == 1
    s, e = adds[0].start_ns(), adds[0].start_ns() + adds[0].duration_ns()
    assert r.start_ns - 20_000 <= s <= e <= r.end_ns + 20_000
    assert r.end_ns - r.start_ns < 50_000_000


def test_cpu_device_spans_time_no_device_and_export_chrome(tmp_path):
    with spans.enable():
        with spans.span("train.forward", device=torch.device("cpu")):
            pass
        t0 = time.perf_counter()
        with spans.span("engine.decode", t0, rid=9, rows=3) as sp:
            sp.close(t0 + 1.0)
    recs = spans.snapshot()
    assert [r.device_ms for r in recs] == [None, None]
    path = tmp_path / "spans.json"
    spans.export_chrome(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["train.forward", "engine.decode"]
    assert all(e["ph"] == "X" for e in events)
    assert events[1]["dur"] == pytest.approx(1e6)
    assert events[1]["args"]["rows"] == 3 and events[1]["args"]["rid"] == 9
    assert events[0]["ts"] == pytest.approx(recs[0].start_ns / 1e3)


# ----------------------------------------------------------- the engine ---
@pytest.fixture(scope="module")
def engine_parts():
    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    return cfg, params


def test_engine_spans_are_its_timers(engine_parts):
    cfg, params = engine_parts
    eng = ServingEngine(cfg, params, MMU(MMUConfig(page_size=8,
                                                   n_pages=128)),
                        max_batch=2, max_len=96, prefill_chunk=16,
                        device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (40, 9, 33)]
    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    emitted = []
    with spans.enable():
        while eng.pending():
            emitted.append(eng.step())
    recs = spans.snapshot()
    by_id = {r.id: r for r in recs}
    steps = _by_name(recs, "engine.step")
    assert len(steps) == len(emitted)
    assert all(r.parent is None for r in steps)
    assert {by_id[r.parent].name for r in recs if r.parent} <= {
        "engine.step", "engine.admit", "engine.prefill_chunks",
        "engine.prefill_batch", "engine.decode", "engine.bookkeeping"}
    assert len(_by_name(recs, "engine.admit")) == len(steps)

    decode = _by_name(recs, "engine.decode")
    assert len(decode) == len(eng.decode_step_times)
    for r, dt in zip(decode, eng.decode_step_times):
        assert abs((r.end_ns - r.start_ns) / 1e9 - dt) < 1e-6
    # rows: the live rows of the step, each of which emitted one token
    for st, n in zip(steps, emitted):
        mine = [r for r in decode if r.parent == st.id]
        assert [r.attrs["rows"] for r in mine] == ([n] if n else [])
    prefill = (_by_name(recs, "engine.prefill_chunks")
               + _by_name(recs, "engine.prefill_batch"))
    assert _by_name(recs, "engine.prefill_chunks")
    assert abs(sum(r.end_ns - r.start_ns for r in prefill) / 1e9
               - eng.prefill_s) \
        < 1e-6 * len(prefill)

    # every read-back is a wait inside its forward, ending where it ends
    for r in _by_name(recs, "engine.wait"):
        parent = by_id[r.parent]
        assert parent.name in ("engine.decode", "engine.prefill_chunks",
                               "engine.prefill_batch")
        assert parent.start_ns <= r.start_ns and r.end_ns == parent.end_ns
    assert len(_by_name(recs, "engine.wait")) == len(decode) + len(prefill)
    assert len(_by_name(recs, "engine.bookkeeping")) == len(decode)
    assert len(eng.completed) == len(prompts)
    assert all(r.rid is None for r in recs)


def test_engine_records_nothing_with_spans_off(engine_parts):
    cfg, params = engine_parts
    eng = ServingEngine(cfg, params, MMU(MMUConfig(page_size=8,
                                                   n_pages=64)),
                        max_batch=2, max_len=64, device="cpu")
    eng.submit(list(range(3, 12)), max_new_tokens=3)
    eng.run()
    assert len(eng.completed) == 1 and len(eng.decode_step_times) == 2
    assert spans.snapshot() == []


def _three_phases_under_each_step(recs, per_step):
    steps = _by_name(recs, "train.step")
    for st in steps:
        kids = [r for r in recs if r.parent == st.id]
        assert [r.name for r in kids] == per_step
        for r in kids:
            assert st.start_ns <= r.start_ns <= r.end_ns <= st.end_ns
    return steps


def test_trainer_step_records_its_three_phases(tmp_path):
    cfg = get_config("smollm-135m").reduced()
    tr = Trainer(cfg, ShapeConfig("t", "train", 16, 2),
                 TrainConfig(steps=2, log_every=1, ckpt_every=2,
                             ckpt_dir=str(tmp_path)), device="cpu")
    with spans.enable():
        tr.run()
    recs = spans.snapshot()
    steps = _three_phases_under_each_step(
        recs, ["train.forward", "train.backward", "train.optimizer"])
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    assert all(r.device_ms is None for r in recs)
    assert {r.name for r in recs} == {"train.step", "train.forward",
                                      "train.backward", "train.optimizer"}


def test_mesh_step_records_a_forward_and_backward_per_micro_step():
    """``make_train_bundle`` on a (1, 1) mesh with 2 microbatches: each
    ``train.step`` holds two forward/backward pairs and one optimizer
    span."""
    (got,) = run_ranks(R.mesh_step_spans, 1, "smollm-135m", 2, 2,
                       device="cpu", backend="gloo", timeout_s=60.0,
                       deadline_s=120.0)
    recs = [spans.SpanRecord(n, s, e, i, p) for n, i, p, s, e in got]
    steps = _three_phases_under_each_step(
        recs, ["train.forward", "train.backward"] * 2 + ["train.optimizer"])
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    assert len(recs) == 2 * 6
