"""Port API v2 on the port's shell (twin of ``tests/test_port.py``): one
typed async interface for apps, services, and the serving engine;
drain-aware hot-swap; safe bitstream format (with bf16 weights kept as
their bits)."""
import threading
import time

import numpy as np
import pytest

import torch

from repro_torch.apps import (make_aes_artifact, make_hll_artifact,
                        make_passthrough_artifact,
                        make_vector_add_artifact)
from repro_torch.core import (Alloc, AppArtifact, Invocation, Oper, PortState,
                        SgEntry, Shell, ShellConfig)
from repro_torch.core.bitstream import BitstreamError
from repro_torch.core.services import (AESConfig, CollectiveConfig,
                                 CompressionConfig, MMUConfig,
                                 SnifferConfig)

ALL_SERVICES = {"mmu": MMUConfig(page_size=64, n_pages=64),
                "encryption": AESConfig(),
                "compression": CompressionConfig(),
                "collectives": CollectiveConfig(),
                "sniffer": SnifferConfig()}


def _shell(**kw):
    services = kw.pop("services", {"mmu": MMUConfig(page_size=64,
                                                    n_pages=64),
                                   "encryption": AESConfig()})
    s = Shell(ShellConfig.make(services=services, **kw), device="cpu")
    s.build()
    return s


# ========================================================= app ports =======
def test_port_submit_transfer_roundtrip():
    shell = _shell()
    shell.load_app(0, make_passthrough_artifact())
    port = shell.attach(0)
    src = np.arange(4096, dtype=np.uint8) % 251
    dst = np.zeros(4096, np.uint8)
    fut = port.submit(Invocation.from_sg(SgEntry(
        src=src, dst=dst, length=4096, opcode=Oper.LOCAL_TRANSFER)))
    comp = fut.result(timeout=30.0)
    assert comp.ok
    assert (src == dst).all()
    # completions still land on the legacy CQ (writeback counter)
    assert shell.vfpgas[0].iface.cq_read.writeback_counter >= 1
    assert port.stats()["completed"] == 1


def test_port_capabilities_registered_at_attach():
    shell = _shell()
    shell.load_app(0, make_aes_artifact("ecb"))
    shell.attach(0)
    ports = shell.status()["ports"]
    caps = ports["vfpga0"]["capabilities"]
    assert caps["csr_map"] == {"key_lo": 0, "key_hi": 1}
    assert caps["kind"] == "app"
    assert caps["mem_model"] == "host"


def test_all_five_apps_expose_capability_descriptors():
    from repro_torch.apps.lm_serving import make_lm_serving_artifact
    from repro_torch.apps.nn_inference import CoyoteOverlay, make_nn_artifact
    arts = [make_aes_artifact("ecb"), make_hll_artifact(),
            make_vector_add_artifact()]
    shell = _shell(n_vfpgas=1)
    arts.append(make_nn_artifact(CoyoteOverlay(shell)))
    # lm_serving needs a model config; the descriptor alone is cheap
    from repro_torch.configs import get_config
    cfg = get_config("smollm-135m").reduced()
    arts.append(make_lm_serving_artifact(cfg, params=None))
    for art in arts:
        caps = art.capabilities
        assert caps is not None, art.name
        assert caps.kind == "app"
        assert caps.streams >= 1
        assert caps.mem_model in ("host", "paged", "device")
    lm = arts[-1].capabilities
    assert {"temperature_milli", "max_new_tokens",
            "top_k", "top_p_milli"} <= set(lm.csr_map)


def test_apps_route_through_port_submit():
    """aes / hll / vector_add invoked through the one port surface."""
    shell = _shell()
    # aes_ecb
    shell.load_app(0, make_aes_artifact("ecb"))
    port = shell.attach(0)
    data = np.arange(64, dtype=np.uint8)
    comp = port.submit(Invocation.from_sg(SgEntry(
        src=data, length=64, opcode=Oper.KERNEL))).result(30.0)
    assert comp.ok and np.asarray(comp.result).size >= 64
    # hll
    shell.reconfigure(0, make_hll_artifact())
    items = np.arange(1000, dtype=np.uint32).view(np.uint8)
    comp = port.submit(Invocation.from_sg(SgEntry(
        src=items, length=items.size, opcode=Oper.KERNEL))).result(30.0)
    assert comp.ok
    assert abs(comp.result - 1000) / 1000 < 0.15    # HLL estimate
    # vector_add (direct two-array form rides the streams)
    shell.reconfigure(1, make_vector_add_artifact())
    p1 = shell.attach(1)
    from repro_torch.core.interfaces import Packet
    a = np.ones(8, np.float32)
    b = np.full(8, 2.0, np.float32)
    iface = shell.vfpgas[1].iface
    iface.host_in[0].push(Packet(tid=0, seq_no=0, payload=a,
                                 nbytes=a.nbytes, last=True))
    iface.host_in[1].push(Packet(tid=0, seq_no=0, payload=b,
                                 nbytes=b.nbytes, last=True))
    comp = p1.submit(Invocation.from_sg(SgEntry(
        src=None, length=a.nbytes, opcode=Oper.KERNEL))).result(30.0)
    assert comp.ok
    np.testing.assert_allclose(np.asarray(comp.result), a + b)
    shell.close()


def test_port_future_carries_failure_not_exception():
    shell = _shell()

    def bad_app(iface, vfpga, x):
        raise ValueError("malformed data")
    shell.load_app(0, AppArtifact(name="bad", fn=bad_app))
    comp = shell.attach(0).submit(Invocation.from_sg(SgEntry(
        src=np.zeros(16, np.uint8), length=16,
        opcode=Oper.LOCAL_TRANSFER))).result(30.0)
    assert not comp.ok
    assert isinstance(comp.result, ValueError)
    shell.close()


# ===================================================== service ports =======
def test_all_five_services_route_through_port_submit():
    shell = _shell(services=dict(ALL_SERVICES))
    # mmu: allocate, inspect, free — through the port
    mmu_port = shell.attach("mmu")
    assert mmu_port.submit(Invocation.call("alloc_seq", 7, 128)
                           ).result(30.0).ok
    comp = mmu_port.submit(Invocation.call("utilization")).result(30.0)
    assert comp.ok and comp.result["pages_used"] == 2
    assert mmu_port.submit(Invocation.call("free_seq", 7)).result(30.0).ok
    # encryption
    blocks = torch.zeros((4, 16), dtype=torch.uint8)
    comp = shell.attach("encryption").submit(
        Invocation.call("encrypt", blocks)).result(30.0)
    assert comp.ok and np.asarray(comp.result).shape == (4, 16)
    # compression
    g = torch.arange(512, dtype=torch.float32)
    comp = shell.attach("compression").submit(
        Invocation.call("compress_leaf", g)).result(30.0)
    assert comp.ok
    # collectives
    comp = shell.attach("collectives").submit(
        Invocation.call("wire_bytes", "flat", 1 << 20, 8, 2)).result(30.0)
    assert comp.ok and comp.result["intra"] > 0
    # sniffer: start through the port, see bytes move, read records
    sn = shell.attach("sniffer")
    assert sn.submit(Invocation.call("start")).result(30.0).ok
    shell.load_app(0, make_passthrough_artifact())
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 8192))
    ct.invoke(Oper.LOCAL_TRANSFER,
              SgEntry(src=ct.vaddr_of(buf), length=8192), timeout=30.0)
    comp = sn.submit(Invocation.call("to_records")).result(30.0)
    assert comp.ok and len(comp.result) >= 1
    # the service ports registered their capability descriptors
    ports = shell.status()["ports"]
    for name in ALL_SERVICES:
        assert name in ports, name
        assert ports[name]["capabilities"]["kind"] == "service"
    shell.close()


def test_service_port_rejects_undeclared_method():
    shell = _shell(services=dict(ALL_SERVICES))
    comp = shell.attach("mmu").submit(
        Invocation.call("_init_pools")).result(30.0)
    assert not comp.ok
    assert "does not expose" in str(comp.result)
    shell.close()


def test_service_port_billing_lands_on_scheduler():
    shell = _shell(services=dict(ALL_SERVICES))
    port = shell.attach("mmu", tenant="mgmt")
    assert port.submit(Invocation.call("utilization",
                                       nbytes=4096)).result(30.0).ok
    shell.drain()
    stats = shell.scheduler.stats()["tenants"]["mgmt"]
    assert stats["completions"] >= 1
    assert stats["bytes"] >= 4096
    shell.close()


# ============================================ drain-aware hot-swap =========
def test_reconfigure_holds_and_replays_on_new_logic():
    shell = _shell()
    seen_old, seen_new = [], []
    shell.load_app(0, AppArtifact(
        name="old", fn=lambda i, v, x: seen_old.append(1)))
    port = shell.attach(0)
    assert port.quiesce(timeout=10.0)
    assert port.state is PortState.QUIESCED
    futs = [port.submit(Invocation.from_sg(SgEntry(
        src=np.zeros(8, np.uint8), length=8, opcode=Oper.LOCAL_TRANSFER)))
        for _ in range(3)]
    assert not futs[0].done()                    # held, not lost
    assert port.held() == 3
    shell.reconfigure(0, AppArtifact(
        name="new", fn=lambda i, v, x: seen_new.append(1)))
    for f in futs:
        assert f.result(timeout=30.0).ok
    assert seen_old == [] and len(seen_new) == 3  # replayed on NEW logic
    shell.close()


@pytest.mark.parametrize("swap_mid_traffic", [True])
def test_hot_swap_mid_traffic_two_tenants_no_lost_completions(
        swap_mid_traffic):
    """Satellite acceptance: hot-swap slot 0 while both tenants drive
    traffic; zero lost/duplicated completions anywhere, and the OTHER
    tenant's traffic is unaffected (all complete, no intake stalls)."""
    shell = _shell(services={}, n_vfpgas=2)
    shell.register_tenant("gold", 2.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1,))
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
    pa, pb = shell.attach(0), shell.attach(1)
    futs_a, futs_b = [], []
    n = 120

    def drive(port, futs):
        for i in range(n):
            futs.append(port.submit(Invocation.from_sg(SgEntry(
                src=np.full(64, i % 251, np.uint8), length=64,
                opcode=Oper.LOCAL_TRANSFER))))
    ta = threading.Thread(target=drive, args=(pa, futs_a))
    tb = threading.Thread(target=drive, args=(pb, futs_b))
    ta.start()
    tb.start()
    time.sleep(0.005)                       # let traffic get in flight
    stats = shell.reconfigure(0, AppArtifact(name="new", fn=mk("new")))
    ta.join()
    tb.join()
    comps_a = [f.result(timeout=30.0) for f in futs_a]
    comps_b = [f.result(timeout=30.0) for f in futs_b]
    # zero lost: every submission got exactly one completion
    assert len(comps_a) == n and all(c.ok for c in comps_a)
    assert len(comps_b) == n and all(c.ok for c in comps_b)
    # zero duplicated: execution count matches submissions exactly
    assert executed["old"] + executed["new"] == n
    assert executed["b"] == n
    assert stats["replayed"] == pa.stats()["replayed"]
    # the other tenant never drained, never stalled, finished everything
    sched = shell.scheduler.stats()["tenants"]["bronze"]
    assert sched["completions"] == n
    assert sched["intake_stalls"] == 0
    # per-port accounting is exact
    assert pa.stats()["submitted"] == pa.stats()["completed"] == n
    assert pb.stats()["submitted"] == pb.stats()["completed"] == n
    shell.drain()
    shell.close()


def test_reconfigure_preserves_csr_and_membuffers():
    shell = _shell()
    shell.load_app(0, make_passthrough_artifact())
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 512))
    buf[:] = 7
    ct.setCSR(0xBEEF, 3)
    shell.reconfigure(0, make_passthrough_artifact())
    assert ct.getCSR(3) == 0xBEEF               # CSR file restored
    vaddr = ct.vaddr_of(buf)                    # address map survived
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=vaddr, length=512), timeout=30.0)
    assert comp is not None and comp.ok
    shell.close()


def test_cthread_invoke_is_a_port_shim():
    """The legacy entry point and the port surface are the same path."""
    shell = _shell()
    shell.load_app(0, make_passthrough_artifact())
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 1024))
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=ct.vaddr_of(buf), length=1024),
                     timeout=30.0)
    assert comp is not None and comp.ok
    port = shell.attach(0)
    assert port.stats()["submitted"] >= 1       # billed through the port
    assert ct.port is port                      # one port per slot
    shell.close()


# ==================================================== bitstream format =====
def test_app_bitstream_roundtrip_npz(tmp_path):
    from repro_torch.core.reconfig import load_app_bitstream, save_app_bitstream
    art = make_aes_artifact("cbc")
    p = tmp_path / "aes.cybs"
    n = save_app_bitstream(str(p), art)
    assert n > 0
    assert p.read_bytes()[:4] == b"CYBS"        # magic, not a pickle
    art2 = load_app_bitstream(str(p))
    assert art2.name == art.name and art2.fn is art.fn
    assert art2.requires[0].service == "encryption"
    assert art2.capabilities.csr_map == dict(art.capabilities.csr_map)


def test_shell_bitstream_roundtrip_with_weights(tmp_path):
    from repro_torch.core.reconfig import (load_shell_bitstream,
                                     save_shell_bitstream)
    cfg = ShellConfig.make(services={"mmu": MMUConfig(page_size=32,
                                                      n_pages=16)},
                           n_vfpgas=2)
    w = {"layers": [{"w": np.arange(6.0).reshape(2, 3)}]}
    p = tmp_path / "shell.cybs"
    save_shell_bitstream(str(p), cfg, weights=w)
    cfg2, arrays = load_shell_bitstream(str(p))
    assert cfg2 == cfg
    np.testing.assert_allclose(arrays["layers"][0]["w"],
                               w["layers"][0]["w"])


def test_bitstream_rejects_unknown_kind_version_and_pickle(tmp_path):
    from repro_torch.core import bitstream as B
    # unknown kind at encode AND at decode
    with pytest.raises(BitstreamError, match="unknown bitstream kind"):
        B.encode("exploit", {})
    good = B.encode("app", {"name": "x", "fn_ref": "os:getcwd"})
    tampered = good.replace(b'"kind": "app"', b'"kind": "zzz"', 1)
    with pytest.raises(BitstreamError, match="unknown bitstream kind"):
        B.decode(tampered)
    # future container version
    import struct
    future = (B.MAGIC + struct.pack("<HI", B.FORMAT_VERSION + 1, 2)
              + b"{}")
    with pytest.raises(BitstreamError, match="newer than this reader"):
        B.decode(future)
    # a legacy pickle blob is refused outright
    import pickle
    with pytest.raises(BitstreamError, match="bad magic"):
        B.decode(pickle.dumps({"kind": "app"}))
    # reconfig controller path surfaces the same errors
    from repro_torch.core import Shell as _S  # noqa: F401  (import check only)
    p = tmp_path / "evil.bin"
    p.write_bytes(pickle.dumps({"kind": "shell"}))
    shell = _shell(services={})
    with pytest.raises(BitstreamError):
        shell.static.reconfig.load_bitstream(str(p))
    shell.close()


def test_failed_reconfigure_does_not_wedge_the_slot():
    """A swap that fails the link check must leave the port ACTIVE: held
    invocations replay on the old logic and later submits still work."""
    from repro_torch.core.vfpga import LinkError
    shell = _shell(services={})                  # no encryption service
    shell.load_app(0, make_passthrough_artifact())
    port = shell.attach(0)
    with pytest.raises(LinkError):
        shell.reconfigure(0, make_aes_artifact("ecb"))   # requires enc
    assert port.state is PortState.ACTIVE
    comp = port.submit(Invocation.from_sg(SgEntry(
        src=np.zeros(8, np.uint8), length=8,
        opcode=Oper.LOCAL_TRANSFER))).result(timeout=30.0)
    assert comp.ok
    assert shell.vfpgas[0].app.name == "passthrough"     # old logic intact
    shell.close()


def test_port_future_completion_returns_none_on_timeout():
    shell = _shell(services={})
    shell.load_app(0, make_passthrough_artifact())
    port = shell.attach(0)
    port.quiesce(timeout=5.0)                    # intake held -> no resolve
    fut = port.submit(Invocation.from_sg(SgEntry(
        src=np.zeros(8, np.uint8), length=8,
        opcode=Oper.LOCAL_TRANSFER)))
    assert fut.completion(timeout=0.05) is None  # legacy contract
    port.resume()
    assert fut.completion(timeout=30.0).ok
    shell.close()


def test_port_completions_do_not_accumulate_in_cq():
    """Port-mediated completions bump the writeback counter but are NOT
    retained in the CompletionQueue (the future is the synchronization
    object) — no per-invocation leak, no ticket shadowing for legacy
    SendQueue waiters."""
    shell = _shell(services={})
    shell.load_app(0, make_passthrough_artifact())
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 256))
    for _ in range(20):
        ct.invoke(Oper.LOCAL_TRANSFER,
                  SgEntry(src=ct.vaddr_of(buf), length=256), timeout=30.0)
    cq = shell.vfpgas[0].iface.cq_read
    assert cq.writeback_counter == 20
    assert len(cq._by_ticket) == 0
    assert cq._q.qsize() == 0
    shell.close()


def test_cold_restart_invalidates_ports():
    """Ports wrap torn-down slots/services after cold_restart: held
    references fail fast; re-attach hands out live ports."""
    from repro_torch.core.port import PortError
    shell = _shell(services=dict(ALL_SERVICES))
    shell.load_app(0, make_passthrough_artifact())
    old_slot, old_svc = shell.attach(0), shell.attach("mmu")
    shell.cold_restart()
    assert shell.status()["ports"] == {}         # registry emptied
    for port in (old_slot, old_svc):
        with pytest.raises(PortError, match="closed"):
            port.submit(Invocation.call("utilization"))
    fresh = shell.attach("mmu")                  # live again
    assert fresh is not old_svc
    assert fresh.submit(Invocation.call("utilization")).result(30.0).ok
    comp = shell.attach(0).submit(Invocation.from_sg(SgEntry(
        src=np.zeros(8, np.uint8), length=8,
        opcode=Oper.LOCAL_TRANSFER))).result(30.0)
    assert comp.ok
    shell.close()


def test_app_bitstream_keeps_bf16_weights_bit_exact(tmp_path):
    """numpy has no bfloat16: a bf16 weight travels as its int16 bits
    under a tag and comes back as the same bf16 tensor, never upcast;
    the reference reads the same file's float32 and int leaves."""
    from repro_torch.core.reconfig import (BF16_TAG, load_app_bitstream,
                                           save_app_bitstream)
    from repro.core import bitstream as JB
    g = torch.Generator().manual_seed(0)
    w = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
         "layers": [{"b": torch.arange(4, dtype=torch.float32)}],
         "n": np.arange(3, dtype=np.int32)}
    art = AppArtifact(name="bf16", fn=make_passthrough_artifact().fn,
                      weights=w)
    p = tmp_path / "bf16.cybs"
    save_app_bitstream(str(p), art)
    back = load_app_bitstream(str(p)).weights
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w["w"].view(torch.int16))
    np.testing.assert_array_equal(back["layers"][0]["b"], np.arange(4.0))
    np.testing.assert_array_equal(back["n"], np.arange(3))
    _, _, arrays = JB.decode(p.read_bytes(), expect_kind="app")
    assert arrays["w"][BF16_TAG].dtype == np.int16
    # loading onto a slot migrates the bf16 tensor to the slot's device
    shell = _shell()
    shell.reconfigure(0, str(p))
    dev = shell.vfpgas[0].device_weights
    assert dev["w"].dtype == torch.bfloat16
    assert shell.vfpgas[0].hbm_used == 5 * 7 * 2 + 4 * 4 + 3 * 4
    shell.close()
