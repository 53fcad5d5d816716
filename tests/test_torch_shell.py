"""The port's shell against the reference's scenarios (twin of
``tests/test_shell.py``): three-layer lifecycle, reconfiguration
contracts, credits/fairness invariants, MMU paging, sniffer, interrupts —
on ``device="cpu"``.  Then the cross-package checks of the services and
apps on the same seeded numpy inputs (AES byte for byte and FIPS-197,
compression, HLL registers, the MLP), the copied modules' equality with
their reference source, and the shell's refusal to run without a card
when no device is named."""
import pathlib
import re

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.apps import (make_aes_artifact, make_hll_artifact,
                        make_passthrough_artifact)
from repro_torch.core import (Alloc, AppArtifact, Oper, SgEntry, Shell,
                        ShellConfig)
from repro_torch.core.credits import (CreditAccount, Link, RRArbiter,
                                jains_index, packetize)
from repro_torch.core.services import (AESConfig, MMU, MMUConfig, PageFaultError,
                                 SnifferConfig, TLB, ServiceRequirement)
from repro_torch.core.services.sniffer import CSR_SNIFFER_ENABLE


def _shell(**kw):
    services = kw.pop("services", {"mmu": MMUConfig(page_size=64,
                                                    n_pages=64),
                                   "encryption": AESConfig()})
    s = Shell(ShellConfig.make(services=services, **kw), device="cpu")
    s.build()
    return s


# ============================================================== lifecycle ===
def test_build_and_load():
    shell = _shell(n_vfpgas=2)
    assert shell.services.names() == ["encryption", "mmu"]
    stats = shell.load_app(0, make_passthrough_artifact())
    assert shell.vfpgas[0].app.name == "passthrough"
    assert shell.vfpgas[1].app is None            # other slot untouched


def test_app_requirements_fail_safe():
    shell = _shell(services={"encryption": AESConfig()})
    art = make_hll_artifact()                      # requires mmu
    from repro_torch.core.vfpga import LinkError
    with pytest.raises(LinkError):
        shell.load_app(0, art)


def test_shell_reconfig_refuses_to_strand_app():
    shell = _shell()
    shell.load_app(0, make_aes_artifact("ecb"))    # requires encryption
    bad = ShellConfig.make(services={"mmu": MMUConfig()})
    with pytest.raises(RuntimeError, match="strand"):
        shell.reconfigure_shell(bad)
    # original services intact after the refused swap
    assert "encryption" in shell.services.names()


def test_app_hot_swap_preserves_neighbors():
    shell = _shell(n_vfpgas=2)
    shell.load_app(0, make_aes_artifact("ecb"))
    shell.load_app(1, make_passthrough_artifact())
    gen0 = shell.services.get("mmu").generation
    shell.reconfigure_app(1, make_hll_artifact())
    assert shell.vfpgas[0].app.name == "aes_ecb"
    assert shell.vfpgas[1].app.name == "hll"
    assert shell.services.get("mmu").generation == gen0  # services untouched


def test_cold_restart_reloads_apps():
    shell = _shell()
    shell.load_app(0, make_passthrough_artifact())
    r = shell.cold_restart()
    assert r["total_s"] > 0
    assert shell.vfpgas[0].app.name == "passthrough"


def test_hbm_budget_enforced():
    shell = _shell()
    shell.vfpgas[0].hbm_budget = 64
    art = AppArtifact(name="fat", fn=lambda i, v, x: x,
                      weights={"w": torch.zeros((1024,), dtype=torch.float32)})
    from repro_torch.core.vfpga import LinkError
    with pytest.raises(LinkError, match="budget"):
        shell.load_app(0, art)


# ============================================================= datapath ====
def test_cthread_transfer_roundtrip():
    shell = _shell()
    shell.load_app(0, make_passthrough_artifact())
    ct = shell.attach_thread(0, pid=1)
    src = ct.getMem((Alloc.HPF, 8192))
    src[:] = np.arange(8192) % 251
    dst = ct.getMem((Alloc.REG, 8192))
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=ct.vaddr_of(src), dst=ct.vaddr_of(dst),
                             length=8192))
    assert comp.ok
    assert (src == dst).all()
    assert shell.vfpgas[0].iface.cq_read.writeback_counter >= 1


def test_app_fault_raises_interrupt_not_crash():
    shell = _shell()

    def bad_app(iface, vfpga, x):
        raise ValueError("malformed data")
    shell.load_app(0, AppArtifact(name="bad", fn=bad_app))
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 64))
    comp = ct.invoke(Oper.LOCAL_TRANSFER,
                     SgEntry(src=ct.vaddr_of(buf), length=64))
    assert not comp.ok
    irq = ct.poll_interrupt(timeout=1.0)
    assert irq is not None                       # IRQ_USER was raised


def test_sniffer_capture_and_csr_control():
    shell = _shell(services={"encryption": AESConfig(),
                             "mmu": MMUConfig(),
                             "sniffer": SnifferConfig()})
    shell.load_app(0, make_passthrough_artifact())
    sniffer = shell.services.get("sniffer")
    sniffer.csr.set_csr(1, CSR_SNIFFER_ENABLE)
    ct = shell.attach_thread(0, pid=1)
    buf = ct.getMem((Alloc.REG, 16384))
    ct.invoke(Oper.LOCAL_TRANSFER,
              SgEntry(src=ct.vaddr_of(buf), length=16384))
    recs = sniffer.to_records()
    assert len(recs) == 4                        # 16KB / 4KB packets
    assert all(r["len"] == 4096 for r in recs)
    sniffer.csr.set_csr(0, CSR_SNIFFER_ENABLE)   # stop
    n = len(sniffer.to_records())
    ct.invoke(Oper.LOCAL_TRANSFER,
              SgEntry(src=ct.vaddr_of(buf), length=4096))
    assert len(sniffer.to_records()) == n        # capture stopped


# ======================================================== credits/fairness ==
def test_packetize_exact():
    assert packetize(0) == []
    assert packetize(4096) == [4096]
    assert packetize(10000) == [4096, 4096, 1808]
    assert sum(packetize(123456, 1000)) == 123456


@settings(max_examples=20, deadline=None)
@given(sizes=st.lists(st.integers(1, 200_000), min_size=2, max_size=6))
def test_rr_arbiter_fairness_property(sizes):
    """Property: equal-demand tenants get equal shares (Jain -> 1); the
    link moves every byte exactly once; per-tenant ordering holds."""
    link = Link("l", 1e9)
    arb = RRArbiter(link, packet_bytes=4096)
    total = max(sizes)
    for i in range(len(sizes)):
        arb.submit(f"t{i}", total)               # equal demand
    arb.drain()
    shares = arb.fairness()
    assert abs(jains_index(shares) - 1.0) < 1e-9
    assert link.bytes_moved == total * len(sizes)


def test_credit_backpressure_contained():
    """A stalled consumer exhausts ITS credits; the account stalls the
    requester, not the link."""
    acct = CreditAccount(4)
    assert all(acct.try_acquire() for _ in range(4))
    assert not acct.try_acquire()                # 5th stalls
    assert acct.stalls == 1
    acct.release(2)
    assert acct.try_acquire() and acct.try_acquire()
    assert not acct.try_acquire()


# ================================================================== MMU =====
def test_mmu_paging_and_translation():
    mmu = MMU(MMUConfig(page_size=16, n_pages=8, host_pool_pages=8))
    mmu.alloc_seq(1, 40)                         # 3 pages
    p, off = mmu.translate(1, 39)
    assert off == 39 % 16
    table = mmu.block_table([1], 4)
    assert (table[0, :3] >= 0).all() and table[0, 3] == -1
    mmu.free_seq(1)
    assert mmu.utilization()["pages_used"] == 0


def test_mmu_eviction_and_fault_in():
    mmu = MMU(MMUConfig(page_size=16, n_pages=4, host_pool_pages=8))
    mmu.alloc_seq(1, 48)                         # 3 pages
    mmu.alloc_seq(2, 32)                         # needs 2 -> evicts from 1
    assert mmu.migrations_out >= 1
    # touching the evicted page faults it back in
    p, _ = mmu.translate(1, 47)
    assert p >= 0
    assert mmu.migrations_in >= 1


def test_mmu_pool_exhaustion_raises():
    mmu = MMU(MMUConfig(page_size=16, n_pages=2, host_pool_pages=0))
    mmu.alloc_seq(1, 32)
    with pytest.raises(PageFaultError):
        mmu.alloc_seq(2, 32)


@settings(max_examples=20, deadline=None)
@given(accesses=st.lists(st.integers(0, 1023), min_size=5, max_size=60),
       entries=st.sampled_from([4, 8, 16]),
       assoc=st.sampled_from([1, 2, 4]))
def test_tlb_never_wrong_property(accesses, entries, assoc):
    """Property: the TLB may miss but never returns a stale/wrong page."""
    mmu = MMU(MMUConfig(page_size=16, n_pages=128, tlb_entries=entries,
                        tlb_assoc=assoc))
    mmu.alloc_seq(7, 1024)
    truth = {}
    for pos in accesses:
        p, off = mmu.translate(7, pos)
        vp = pos // 16
        if vp in truth:
            assert truth[vp] == p, "translation changed without remap"
        truth[vp] = p
        assert off == pos % 16


def test_mmu_reconfigure_requires_drain():
    mmu = MMU(MMUConfig(page_size=16, n_pages=8))
    mmu.alloc_seq(1, 16)
    with pytest.raises(RuntimeError, match="drain"):
        mmu.configure(MMUConfig(page_size=1024, n_pages=8))
    mmu.free_seq(1)
    mmu.configure(MMUConfig(page_size=1024, n_pages=8))
    assert mmu.config.page_size == 1024
    assert mmu.generation == 1


# ===================================================== cross-package ======
from repro.apps import hll as JH                                # noqa: E402
from repro.apps import nn_inference as JN                       # noqa: E402
from repro.core.services import compression as JC               # noqa: E402
from repro.core.services import encryption as JE                # noqa: E402
from repro_torch.apps import hll as H                           # noqa: E402
from repro_torch.apps import nn_inference as N                  # noqa: E402
from repro_torch.core.services import compression as C          # noqa: E402
from repro_torch.core.services import encryption as E           # noqa: E402

import jax                                                       # noqa: E402
import jax.numpy as jnp                                          # noqa: E402


def _u8(rs, *shape):
    return rs.randint(0, 256, size=shape).astype(np.uint8)


def test_aes_fips197_appendix_b():
    key = np.frombuffer(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"),
                        np.uint8).copy()
    pt = np.frombuffer(bytes.fromhex("3243f6a8885a308d313198a2e0370734"),
                       np.uint8).copy()
    rk = torch.from_numpy(E.expand_key(key))
    ct = E.aes_ecb(torch.from_numpy(pt)[None], rk)[0].numpy()
    assert ct.tobytes().hex() == "3925841d02dc09fbdc118597196a0b32"


@pytest.mark.parametrize("mode", ["ecb", "cbc", "multistream"])
def test_aes_ciphertext_equals_reference(mode):
    rs = np.random.RandomState(3)
    key = _u8(rs, 16)
    rk_np = E.expand_key(key)
    assert (rk_np == JE.expand_key(key)).all()
    rk, jrk = torch.from_numpy(rk_np), jnp.asarray(rk_np)
    if mode == "ecb":
        blocks = _u8(rs, 257, 16)
        got = E.aes_ecb(torch.from_numpy(blocks), rk)
        want = JE.aes_ecb(jnp.asarray(blocks), jrk)
    elif mode == "cbc":
        blocks, iv = _u8(rs, 33, 16), _u8(rs, 16)
        got = E.aes_cbc(torch.from_numpy(blocks), torch.from_numpy(iv), rk)
        want = JE.aes_cbc(jnp.asarray(blocks), jnp.asarray(iv), jrk)
    else:
        blocks, ivs = _u8(rs, 5, 17, 16), _u8(rs, 5, 16)
        got = E.aes_cbc_multistream(torch.from_numpy(blocks),
                                    torch.from_numpy(ivs), rk)
        want = JE.aes_cbc_multistream(jnp.asarray(blocks), jnp.asarray(ivs),
                                      jrk)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_aes_service_and_apps_equal_reference():
    """The service (ECB/CBC configs) and both slot apps through a port,
    against the reference's functions on the same bytes and key."""
    rs = np.random.RandomState(4)
    data = _u8(rs, 1000)                     # padded to 63 blocks
    shell = _shell()
    for mode in ("ecb", "cbc"):
        shell.reconfigure(0, make_aes_artifact(mode))
        comp = shell.attach(0).submit(_kernel_call(data)).result(30.0)
        assert comp.ok, comp.result
        key = np.arange(16, dtype=np.uint8)  # the CSR default key
        jrk = jnp.asarray(JE.expand_key(key))
        blocks = jnp.asarray(JE.bytes_to_blocks(data))
        want = (JE.aes_ecb(blocks, jrk) if mode == "ecb"
                else JE.aes_cbc_multistream(
                    blocks[None], jnp.zeros((1, 16), jnp.uint8), jrk))
        assert np.array_equal(comp.result, np.asarray(want).reshape(-1))
    svc = shell.services.get("encryption")
    blocks = _u8(rs, 9, 16)
    got = svc.encrypt(torch.from_numpy(blocks))
    want = JE.AESService(JE.AESConfig()).encrypt(jnp.asarray(blocks))
    assert np.array_equal(got.numpy(), np.asarray(want))
    shell.close()


def _kernel_call(data):
    from repro_torch.core import Invocation
    return Invocation.from_sg(SgEntry(src=data, length=data.size,
                                      opcode=Oper.KERNEL))


@pytest.mark.parametrize("topk_frac", [0.0, 0.05])
def test_compression_equals_reference(topk_frac):
    rs = np.random.RandomState(5)
    g = (rs.randn(1000) * rs.exponential(1.0, 1000)).astype(np.float32)
    g[::97] = 0.0
    cfg = C.CompressionConfig(block=64, topk_frac=topk_frac)
    got = C.GradCompression(cfg).compress_leaf(torch.from_numpy(g))
    want = JC.GradCompression(JC.CompressionConfig(
        block=64, topk_frac=topk_frac)).compress_leaf(jnp.asarray(g))
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=1e-6)
    if topk_frac:
        mask = C._topk_mask(torch.from_numpy(g), topk_frac).numpy() != 0
        jmask = np.asarray(JC._topk_mask(jnp.asarray(g), topk_frac)) != 0
        assert np.array_equal(mask, jmask)
    # error feedback: one apply() round trip agrees too
    svc = C.GradCompression(cfg)
    ghat, st, met = svc.apply({"w": torch.from_numpy(g)},
                              svc.init_state({"w": torch.from_numpy(g)}))
    jsvc = JC.GradCompression(JC.CompressionConfig(block=64,
                                                   topk_frac=topk_frac))
    jg = {"w": jnp.asarray(g)}
    jhat, jst, jmet = jsvc.apply(jg, jsvc.init_state(jg))
    np.testing.assert_allclose(ghat["w"].numpy(), np.asarray(jhat["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st["w"].numpy(), np.asarray(jst["w"]),
                               rtol=1e-6, atol=1e-7)
    assert met == jmet


def test_hll_registers_equal_reference():
    rs = np.random.RandomState(6)
    items = rs.randint(-2 ** 31, 2 ** 31 - 1, size=50_000).astype(np.int32)
    h2 = np.asarray(JH._mix32(jnp.asarray(items), 0x85EBCA77))
    assert (h2 >= 2 ** 31).mean() > 0.4      # the rho = 1 branch is hit
    regs = H.hll_sketch(torch.from_numpy(items))
    jregs = JH.hll_sketch(jnp.asarray(items))
    assert regs.dtype == torch.uint8
    assert np.array_equal(regs.numpy(), np.asarray(jregs))
    np.testing.assert_allclose(float(H.hll_estimate(regs)),
                               float(JH.hll_estimate(jregs)), rtol=1e-6)
    # the slot app reads a byte buffer as 32-bit items
    est = H.hll_count(torch.from_numpy(items))
    assert abs(est - 50_000) / 50_000 < 0.05


def test_mlp_equals_reference_on_carried_weights():
    jparams = JN.init_mlp(jax.random.PRNGKey(0))
    params = N.mlp_from_reference(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    x = np.random.RandomState(7).randn(300, 593).astype(np.float32)
    got = N.mlp_apply(params, torch.from_numpy(x)).numpy()
    want = np.asarray(JN.mlp_apply(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the staged baseline on the carried weights
    staged = N.StagedCopyBaseline(params, device="cpu")
    np.testing.assert_allclose(staged.predict(x, batch_size=64), want,
                               atol=1e-5, rtol=0)
    # the overlay on the port's shell: its streamed predict against
    # mlp_apply (held to the reference above) on the overlay's own weights
    shell = _shell(services={"mmu": MMUConfig(page_size=64, n_pages=64)})
    ov = N.CoyoteOverlay(shell, slot=1, seed=0)
    ov.program_fpga(warm_batch=64)
    own = N.mlp_apply(ov.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ov.predict(x, batch_size=64), own,
                               atol=1e-5, rtol=0)
    shell.close()


# ============================================ copies and the device rule ==
_COPIED = ["core/interfaces.py", "core/credits.py", "core/health.py",
           "core/scheduler.py", "core/port.py", "core/bitstream.py",
           "core/cthread.py", "core/services/sniffer.py",
           "serve/gateway.py", "fleet/__init__.py", "fleet/controller.py",
           "telemetry/hlo_cost.py"]
_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
_IMPORT = re.compile(r"^\s*(from|import)\s")


@pytest.mark.parametrize("rel", _COPIED)
def test_copied_module_equals_reference_but_imports(rel):
    ref = (_SRC / "repro" / rel).read_text().splitlines()
    port = (_SRC / "repro_torch" / rel).read_text().splitlines()
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        if _IMPORT.match(a):
            assert b == a.replace("repro.", "repro_torch."), (a, b)
        else:
            assert b == a, (a, b)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_shell_without_device_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Shell(ShellConfig.make(services={}))
