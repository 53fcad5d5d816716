"""Multi-tenant shell scheduler of the port (twin of
``tests/test_scheduler.py``): weighted-credit QoS, SG coalescing,
per-tenant accounting; then one scripted submission sequence through both
packages' shells, which must give the same grant order and per-tenant
byte totals.  (The reference file's ``repro.compat`` test has no twin:
that module is JAX-only.)"""
import numpy as np
import pytest

from repro_torch.core import Alloc, AppArtifact, Oper, SgEntry, Shell, ShellConfig
from repro_torch.core.credits import (Link, WeightedRRArbiter, jains_index,
                                weighted_jains_index)


def _contended_shares(events, finish_of):
    """Byte share per party over the window where EVERY party still has
    backlog — i.e. up to the first party's last transfer.  After that the
    survivors inherit the idle bandwidth, which is not a QoS signal."""
    t_star = min(finish_of.values())
    got = {k: 0 for k in finish_of}
    for t, key, nbytes in events:
        if t <= t_star:
            got[key] += nbytes
    return got


def _tenant_of_src(src: str) -> str:
    return src.split("/", 1)[0]


# ====================================================== weighted arbiter ====
def test_weighted_arbiter_dwrr_shares():
    link = Link("l", 1e9)
    arb = WeightedRRArbiter(link, packet_bytes=4096)
    events = []
    link.on_event(lambda ev: events.append((ev.t, ev.src, ev.nbytes)))
    arb.submit("gold", 4096 * 240, weight=3.0)
    arb.submit("bronze", 4096 * 240, weight=1.0)
    arb.drain()
    finish = {}
    for t, src, _ in events:
        finish[src] = t
    got = _contended_shares(events, finish)
    ratio = got["gold"] / got["bronze"]
    assert abs(ratio - 3.0) / 3.0 < 0.15, ratio
    # every byte moved exactly once regardless of weighting
    assert link.bytes_moved == 2 * 4096 * 240


def test_weighted_arbiter_equal_weights_is_plain_rr():
    link = Link("l", 1e9)
    arb = WeightedRRArbiter(link, packet_bytes=4096)
    for name in ("a", "b", "c"):
        arb.submit(name, 4096 * 50)
    arb.drain()
    shares = arb.fairness()
    assert abs(jains_index(shares) - 1.0) < 1e-9


def test_weighted_arbiter_rejects_nonpositive_weight():
    arb = WeightedRRArbiter(Link("l", 1e9))
    with pytest.raises(ValueError):
        arb.set_weight("x", 0.0)


def test_weighted_jains_index():
    # exact 3:1 split under 3:1 weights is perfectly weighted-fair
    assert abs(weighted_jains_index({"a": 0.75, "b": 0.25},
                                    {"a": 3.0, "b": 1.0}) - 1.0) < 1e-9
    # equal split under 3:1 weights is NOT
    assert weighted_jains_index({"a": 0.5, "b": 0.5},
                                {"a": 3.0, "b": 1.0}) < 0.9


# ==================================================== scheduler QoS (e2e) ===
def _shell(n_vfpgas=2, **kw):
    s = Shell(ShellConfig.make(services={}, n_vfpgas=n_vfpgas, **kw),
              device="cpu")
    s.build()
    return s


def test_weighted_shares_converge_to_configured_ratio():
    """Acceptance: two tenants at 3:1 under saturation -> contended byte
    ratio within 15% of 3:1, and Jain's indices reported per tenant."""
    shell = _shell(n_vfpgas=2)
    shell.register_tenant("gold", 3.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1,))
    events = []
    shell.static.pcie.on_event(
        lambda ev: events.append((ev.t, _tenant_of_src(ev.src), ev.nbytes)))
    threads = [shell.attach_thread(0, pid=1), shell.attach_thread(1, pid=2)]
    shell.scheduler.pause()                  # build up saturation demand
    for ct in threads:
        for _ in range(30):
            buf = ct.getMem((Alloc.REG, 32 << 10))
            ct.invoke(Oper.LOCAL_TRANSFER,
                      SgEntry(src=ct.vaddr_of(buf), length=buf.size),
                      wait=False)
    shell.scheduler.resume()
    shell.drain()

    finish = {}
    for t, ten, _ in events:
        finish[ten] = t
    got = _contended_shares(events, finish)
    ratio = got["gold"] / got["bronze"]
    assert abs(ratio - 3.0) / 3.0 < 0.15, ratio

    sched = shell.status()["scheduler"]
    assert set(sched["tenants"]) == {"gold", "bronze"}
    assert 0.0 < sched["jain_tenant"] <= 1.0
    assert 0.0 < sched["jain_weighted"] <= 1.0
    for t in sched["tenants"].values():
        assert t["completions"] == 30
        assert t["mean_latency_s"] >= 0.0


def test_batching_never_reorders_same_stream_entries():
    shell = _shell(n_vfpgas=1)
    order = []

    def recorder(iface, vfpga, x):
        order.append(int(x[0]))
        return x

    shell.load_app(0, AppArtifact(name="recorder", fn=recorder))
    ct = shell.attach_thread(0, pid=1)
    shell.scheduler.pause()                  # force a deep backlog
    n = 32
    for i in range(n):
        buf = ct.getMem((Alloc.REG, 256))    # small: 16 coalesce per packet
        buf[0] = i
        ct.invoke(Oper.LOCAL_TRANSFER,
                  SgEntry(src=ct.vaddr_of(buf), length=buf.size),
                  wait=False)
    shell.scheduler.resume()
    shell.drain()
    assert order == list(range(n))           # strict FIFO per stream
    # and the backlog really was coalesced, not sent 1 entry : 1 batch
    assert shell.scheduler.entries_coalesced > 0
    assert shell.scheduler.batches_issued < n


def test_per_tenant_stats_sum_to_arbiter_totals():
    shell = _shell(n_vfpgas=2)
    shell.register_tenant("gold", 2.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1,))
    threads = [shell.attach_thread(0, pid=1), shell.attach_thread(1, pid=2)]
    for ct, kb in zip(threads, (96, 160)):
        buf = ct.getMem((Alloc.REG, kb << 10))
        ct.invoke(Oper.LOCAL_TRANSFER,
                  SgEntry(src=ct.vaddr_of(buf), length=buf.size),
                  wait=False)
    shell.drain()
    sched = shell.scheduler.stats()
    tenant_bytes = sum(t["bytes"] for t in sched["tenants"].values())
    arbiter_bytes = sum(shell.arbiter.delivered.values())
    assert tenant_bytes == arbiter_bytes == (96 << 10) + (160 << 10)
    assert tenant_bytes == shell.static.pcie.bytes_moved
    assert sched["total_bytes"] == tenant_bytes


def test_completion_queues_still_synchronize_invoke():
    """wait=True invokes must behave exactly as before the async refactor."""
    shell = _shell(n_vfpgas=1)
    ct = shell.attach_thread(0, pid=1)
    src = ct.getMem((Alloc.REG, 8192))
    src[:] = np.arange(8192) % 251
    dst = ct.getMem((Alloc.REG, 8192))
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=ct.vaddr_of(src), dst=ct.vaddr_of(dst),
                             length=8192), timeout=30.0)
    assert comp is not None and comp.ok
    assert (src == dst).all()


def test_submit_io_bills_tenant():
    shell = _shell(n_vfpgas=1)
    shell.register_tenant("svc", 1.5, slots=(0,))
    ev = shell.scheduler.submit_io(1 << 20, slot=0, tenant="svc",
                                   wait=True, timeout=30.0)
    assert ev.is_set()
    stats = shell.scheduler.stats()["tenants"]["svc"]
    assert stats["bytes"] == 1 << 20
    assert stats["completions"] == 1
    # regression: submit_io naming an existing tenant must NOT reset its
    # configured weight back to the default
    assert stats["weight"] == 1.5
    # async submitters reconcile on this: nothing left in flight
    assert shell.scheduler.tenant_pending("svc") == 0
    assert shell.scheduler.tenant_pending("no-such-tenant") == 0


def test_default_tenant_autocreated_per_slot():
    shell = _shell(n_vfpgas=2)
    ct = shell.attach_thread(1, pid=9)
    buf = ct.getMem((Alloc.REG, 4096))
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=ct.vaddr_of(buf), length=4096),
                     timeout=30.0)
    assert comp is not None and comp.ok
    assert "tenant1" in shell.scheduler.stats()["tenants"]


def test_drained_stream_stops_diluting_tenant_weight():
    """A tenant fanned out over two slots must regain its full weight on
    the surviving stream once the other's backlog drains."""
    shell = _shell(n_vfpgas=2)
    shell.register_tenant("gold", 3.0, slots=(0, 1))
    ct0 = shell.attach_thread(0, pid=1)
    ct1 = shell.attach_thread(1, pid=2)
    b1 = ct1.getMem((Alloc.REG, 4096))          # touch + drain slot 1
    ct1.invoke(Oper.LOCAL_TRANSFER,
               SgEntry(src=ct1.vaddr_of(b1), length=4096), timeout=30.0)
    shell.drain()
    b0 = ct0.getMem((Alloc.REG, 64 << 10))      # then slot 0 alone
    ct0.invoke(Oper.LOCAL_TRANSFER,
               SgEntry(src=ct0.vaddr_of(b0), length=b0.size), timeout=30.0)
    shell.drain()
    assert shell.arbiter.weight("gold/vfpga0.s0") == pytest.approx(3.0)


def test_submit_with_unknown_tenant_autoregisters():
    shell = _shell(n_vfpgas=1)
    ev = shell.scheduler.submit_io(4096, slot=0, tenant="newbie",
                                   wait=True, timeout=30.0)
    assert ev.is_set()
    assert shell.scheduler.stats()["tenants"]["newbie"]["weight"] == 1.0




# ============================================ grant order vs reference =====
def _scripted_grants(port_pkg):
    """One scripted submission sequence through a lanes-off shell of
    either package: returns the link's packet order (the arbiter's grant
    order) and the per-tenant byte totals."""
    if port_pkg:
        from repro_torch import core as K
        shell = K.Shell(K.ShellConfig.make(services={}, n_vfpgas=3,
                                           executor_lanes=False),
                        device="cpu")
    else:
        from repro import core as K
        shell = K.Shell(K.ShellConfig.make(services={}, n_vfpgas=3,
                                           executor_lanes=False))
    shell.build()
    shell.register_tenant("gold", 3.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1, 2))
    grants = []
    shell.static.pcie.on_event(
        lambda ev: grants.append((ev.src, ev.nbytes)))
    rs = np.random.RandomState(11)
    ports = [shell.attach(s) for s in range(3)]
    shell.scheduler.pause()
    futs = []
    for i in range(60):
        slot = int(rs.randint(0, 3))
        n = int(rs.randint(1, 40_000))
        futs.append(ports[slot].submit(K.Invocation.from_sg(K.SgEntry(
            src=np.zeros(n, np.uint8), length=n,
            src_stream=int(rs.randint(0, 2)),
            opcode=K.Oper.LOCAL_TRANSFER))))
        if i % 7 == 0:
            futs.append(ports[slot].submit(K.Invocation.io(
                int(rs.randint(1, 9000)), tag="io")))
    shell.scheduler.resume()
    for f in futs:
        assert f.result(timeout=30.0).ok
    shell.drain()
    tenants = {t: (s["bytes"], s["completions"])
               for t, s in shell.scheduler.stats()["tenants"].items()}
    shell.close()
    return grants, tenants


def test_grant_order_and_tenant_bytes_equal_reference():
    got, got_tenants = _scripted_grants(True)
    want, want_tenants = _scripted_grants(False)
    assert got_tenants == want_tenants
    assert len(got) == len(want) > 100
    assert got == want
