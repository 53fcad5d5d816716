"""Per-slot executor lanes + cooperative preemption on the port's shell
(twin of ``tests/test_executor_pool.py``).

Covers the four contract points:

  * two-slot non-interference — a long-running invocation on slot A does
    not stall slot B's completions;
  * preemption honors priority at checkpoint boundaries without losing
    or duplicating completions;
  * ``Shell.reconfigure`` keeps the hot-swap's zero-lost/zero-dup invariant
    with lanes active;
  * billing totals are identical lanes-on vs lanes-off.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.apps import make_passthrough_artifact
from repro_torch.core import (AppArtifact, Invocation, Oper, SgEntry, Shell,
                        ShellConfig)
from repro_torch.core.services import MMUConfig


def _shell(lanes=True, n_vfpgas=2, services=None, **kw):
    s = Shell(ShellConfig.make(services=services or {},
                               executor_lanes=lanes,
                               n_vfpgas=n_vfpgas, **kw), device="cpu")
    s.build()
    return s


def _sg(nbytes=64, fill=1, stream=0):
    return SgEntry(src=np.full(nbytes, fill, np.uint8), length=nbytes,
                   src_stream=stream, opcode=Oper.LOCAL_TRANSFER)


# ================================================== non-interference =======
def test_two_slot_non_interference():
    """A blocked long invocation on slot 0 must not delay slot 1: the
    latency tenant's submissions all complete WHILE slot 0 is held."""
    shell = _shell(lanes=True)
    started, release = threading.Event(), threading.Event()

    def long_fn(iface, vf, x):
        started.set()
        assert release.wait(timeout=30.0)
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    shell.load_app(1, make_passthrough_artifact())
    p0, p1 = shell.attach(0, tenant="batch"), shell.attach(1,
                                                           tenant="latency")
    long_fut = p0.submit(Invocation.from_sg(_sg(4096)))
    assert started.wait(timeout=10.0)          # slot 0's lane is now busy
    comps = [p1.submit(Invocation.from_sg(_sg())).result(timeout=10.0)
             for _ in range(10)]
    assert all(c.ok for c in comps)            # slot 1 completed under hold
    assert not long_fut.done()                 # slot 0 still in flight
    release.set()
    assert long_fut.result(timeout=30.0).ok
    shell.drain()
    shell.close()


def test_io_completes_while_lane_is_busy():
    """Pure-I/O submissions (decode-step billing) finish inline on the
    scheduler thread — a busy lane must not delay their futures."""
    shell = _shell(lanes=True)
    started, release = threading.Event(), threading.Event()

    def long_fn(iface, vf, x):
        started.set()
        assert release.wait(timeout=30.0)
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    port = shell.attach(0, tenant="batch")
    port.submit(Invocation.from_sg(_sg(4096)))
    assert started.wait(timeout=10.0)
    comp = port.submit(Invocation.io(2048, tag="decode_io")
                       ).completion(timeout=10.0)
    assert comp is not None and comp.nbytes == 2048
    release.set()
    shell.drain()
    shell.close()


def test_serialized_baseline_blocks_across_slots():
    """Control: with lanes OFF the single worker serializes slots, so a
    held invocation on slot 0 stalls slot 1 (the gap lanes close)."""
    shell = _shell(lanes=False)
    started, release = threading.Event(), threading.Event()

    def long_fn(iface, vf, x):
        started.set()
        assert release.wait(timeout=30.0)
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    shell.load_app(1, make_passthrough_artifact())
    p0, p1 = shell.attach(0), shell.attach(1)
    p0.submit(Invocation.from_sg(_sg(4096)))
    assert started.wait(timeout=10.0)
    fast = p1.submit(Invocation.from_sg(_sg()))
    assert fast.completion(timeout=0.3) is None     # stuck behind slot 0
    release.set()
    assert fast.result(timeout=30.0).ok
    shell.drain()
    shell.close()


# ====================================================== preemption =========
def test_preemption_honors_priority_no_lost_no_dup():
    """High-priority invocations on the SAME slot run inside the long
    batch's checkpoint holds: they complete while the long invocation is
    still in flight, and every submission completes exactly once."""
    shell = _shell(lanes=True, n_vfpgas=1)
    order = []
    lock = threading.Lock()
    started, release = threading.Event(), threading.Event()

    def long_fn(iface, vf, x):
        started.set()
        while not release.is_set():            # checkpointed long loop
            time.sleep(0.005)
            vf.checkpoint()
        with lock:
            order.append("long")
        return x

    def hi_fn(iface, vf, x):
        with lock:
            order.append("hi")
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    port = shell.attach(0)
    long_fut = port.submit(Invocation.from_sg(_sg(4096)))
    assert started.wait(timeout=10.0)
    # point the slot's logic at the tagging fn for the preemptors (the
    # in-flight long invocation already entered long_fn); preemptors
    # ride their own stream — same-stream work may never overtake
    shell.vfpgas[0].app = AppArtifact(name="hi", fn=hi_fn)
    hi_futs = [port.submit(Invocation.from_sg(_sg(64, stream=1),
                                              priority=5))
               for _ in range(5)]
    comps = [f.result(timeout=30.0) for f in hi_futs]
    assert all(c.ok for c in comps)            # ran inside checkpoint holds
    assert not long_fut.done()                 # preempted, not displaced
    release.set()
    assert long_fut.result(timeout=30.0).ok
    with lock:
        assert order.count("hi") == 5          # zero lost, zero dup
        assert order.count("long") == 1
        assert order.index("long") == len(order) - 1   # highs ran first
    assert shell.vfpgas[0].preemptions >= 1
    lanes = shell.scheduler.stats()["lanes"]
    assert lanes["0"]["preempt_runs"] >= 1     # >=1 batch (they coalesce)
    shell.drain()
    shell.close()


def test_same_stream_priority_never_overtakes():
    """Per-stream FIFO is inviolable: a higher-priority submission on
    the SAME (slot, stream) as the held batch must NOT run inside its
    checkpoint holds — it executes only after the earlier batch
    completes (priority reorders only across streams)."""
    shell = _shell(lanes=True, n_vfpgas=1)
    order = []
    started, release = threading.Event(), threading.Event()

    def long_fn(iface, vf, x):
        started.set()
        while not release.is_set():
            time.sleep(0.005)
            vf.checkpoint()
        order.append("long")
        return x

    def hi_fn(iface, vf, x):
        order.append("hi")
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    port = shell.attach(0)
    long_fut = port.submit(Invocation.from_sg(_sg(4096, stream=0)))
    assert started.wait(timeout=10.0)
    shell.vfpgas[0].app = AppArtifact(name="hi", fn=hi_fn)
    hi_fut = port.submit(Invocation.from_sg(_sg(64, stream=0),
                                            priority=5))
    assert hi_fut.completion(timeout=0.3) is None   # held back: same stream
    release.set()
    assert long_fut.result(timeout=30.0).ok
    assert hi_fut.result(timeout=30.0).ok
    assert order == ["long", "hi"]                  # FIFO preserved
    shell.drain()
    shell.close()


def test_equal_priority_orders_by_deadline():
    """Among equal priorities the earliest absolute deadline runs first
    (streams differ, so per-stream FIFO does not constrain the order)."""
    shell = _shell(lanes=True, n_vfpgas=1, n_streams=4)
    order = []
    started, release = threading.Event(), threading.Event()

    def fn(iface, vf, x):
        tag = bytes(np.asarray(x)[:1]).decode()
        if tag == "L":
            started.set()
            assert release.wait(timeout=30.0)
        order.append(tag)
        return x

    shell.load_app(0, AppArtifact(name="tagged", fn=fn))
    port = shell.attach(0)
    futs = [port.submit(Invocation.from_sg(SgEntry(
        src=np.frombuffer(b"L" * 64, np.uint8), length=64,
        src_stream=0, opcode=Oper.LOCAL_TRANSFER)))]
    assert started.wait(timeout=10.0)          # lane busy; next two queue
    futs.append(port.submit(Invocation.from_sg(SgEntry(
        src=np.frombuffer(b"A" * 64, np.uint8), length=64,
        src_stream=1, opcode=Oper.LOCAL_TRANSFER), deadline_s=30.0)))
    futs.append(port.submit(Invocation.from_sg(SgEntry(
        src=np.frombuffer(b"B" * 64, np.uint8), length=64,
        src_stream=2, opcode=Oper.LOCAL_TRANSFER), deadline_s=0.5)))
    # both queued submissions must be ON the lane before releasing, or
    # the lane could pop A alone before B's grant arrives
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline:
        lanes = shell.scheduler.stats()["lanes"]
        if lanes.get("0", {}).get("queued", 0) >= 2:
            break
        time.sleep(0.005)
    assert shell.scheduler.stats()["lanes"]["0"]["queued"] == 2
    release.set()
    for f in futs:
        assert f.result(timeout=30.0).ok
    assert order == ["L", "B", "A"]            # earlier deadline first
    shell.drain()
    shell.close()


def test_checkpoint_off_lane_is_noop():
    shell = _shell(lanes=True)
    assert shell.scheduler.checkpoint(0) == 0
    assert not shell.scheduler.preempt_requested(0)
    shell_off = _shell(lanes=False)
    assert shell_off.scheduler.checkpoint(0) == 0
    shell.close()
    shell_off.close()


# ====================================== reconfigure under lanes ============
def test_reconfigure_under_lanes_zero_lost_zero_dup():
    """The hot-swap invariant with lanes active: hot-swap slot 0 mid-traffic
    while both tenants drive; every submission completes exactly once
    and the other slot never stalls."""
    shell = _shell(lanes=True)
    executed = {"old": 0, "new": 0, "b": 0}
    lock = threading.Lock()

    def mk(tag):
        def fn(iface, vf, x):
            with lock:
                executed[tag] += 1
            return x
        return fn

    shell.load_app(0, AppArtifact(name="old", fn=mk("old")))
    shell.load_app(1, AppArtifact(name="bapp", fn=mk("b")))
    shell.register_tenant("gold", 2.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1,))
    pa, pb = shell.attach(0), shell.attach(1)
    futs_a, futs_b = [], []
    n = 100

    def drive(port, futs):
        for i in range(n):
            futs.append(port.submit(Invocation.from_sg(_sg(64, i % 251))))
    ta = threading.Thread(target=drive, args=(pa, futs_a))
    tb = threading.Thread(target=drive, args=(pb, futs_b))
    ta.start()
    tb.start()
    time.sleep(0.005)
    shell.reconfigure(0, AppArtifact(name="new", fn=mk("new")))
    ta.join()
    tb.join()
    comps_a = [f.result(timeout=30.0) for f in futs_a]
    comps_b = [f.result(timeout=30.0) for f in futs_b]
    assert len(comps_a) == n and all(c.ok for c in comps_a)
    assert len(comps_b) == n and all(c.ok for c in comps_b)
    assert executed["old"] + executed["new"] == n     # exactly once each
    assert executed["b"] == n
    assert pa.stats()["submitted"] == pa.stats()["completed"] == n
    shell.drain()
    shell.close()


def test_reconfigure_waits_out_long_invocation_on_lane():
    """Quiesce must include a long-running lane execution: the swap
    happens only after it completes, and nothing is lost."""
    shell = _shell(lanes=True, n_vfpgas=1)
    done_marker = []

    def long_fn(iface, vf, x):
        time.sleep(0.15)
        done_marker.append("long")
        return x

    shell.load_app(0, AppArtifact(name="long", fn=long_fn))
    port = shell.attach(0)
    fut = port.submit(Invocation.from_sg(_sg(4096)))
    time.sleep(0.02)                           # in flight on the lane
    shell.reconfigure(0, make_passthrough_artifact())
    assert done_marker == ["long"]             # drained, not killed
    assert fut.result(timeout=30.0).ok
    comp = port.submit(Invocation.from_sg(_sg())).result(timeout=30.0)
    assert comp.ok                             # new logic live
    shell.drain()
    shell.close()


# ================================================= billing parity ==========
@pytest.mark.parametrize("with_io", [False, True])
def test_billing_identical_lanes_on_vs_off(with_io):
    """The lanes move WHERE execution happens, never WHAT is billed:
    per-tenant byte totals, completions, and batch counts must match the
    serialized baseline exactly."""
    def run(lanes):
        shell = _shell(lanes=lanes)
        shell.register_tenant("gold", 2.0, slots=(0,))
        shell.register_tenant("bronze", 1.0, slots=(1,))
        shell.load_app(0, make_passthrough_artifact())
        shell.load_app(1, make_passthrough_artifact())
        p0, p1 = shell.attach(0), shell.attach(1)
        for i in range(40):
            p0.submit(Invocation.from_sg(_sg(512, i % 251)))
            p1.submit(Invocation.from_sg(_sg(1024, i % 251)))
            if with_io:
                p0.submit(Invocation.io(256, tag="io"))
        shell.drain()
        stats = shell.scheduler.stats()["tenants"]
        out = {t: (s["bytes"], s["completions"], s["submissions"])
               for t, s in stats.items()}
        shell.close()
        return out

    assert run(lanes=True) == run(lanes=False)
