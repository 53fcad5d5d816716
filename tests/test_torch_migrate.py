"""Quiesce-and-migrate on the port (twin of ``tests/test_migrate.py``'s
engine parts): live tenant migration across two port shells with real KV
copy, on reduced smollm-135m fp32 with ``from_reference`` weights.

Parity: greedy streams across a move equal the JAX package's unmoved
engine token for token; every stream, sampled ones included, equals the
port's unmoved engine (counter-based sampling keys plus the seed in the
container).  KV bytes are compared exactly, in float32 and in bf16 (which
crosses the container as tagged int16 bits).  One test crosses
frameworks: a container the JAX engine writes restores into a port
engine, whose greedy decoding continues the JAX engine's own.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import Shell as JShell, ShellConfig as JShellConfig
from repro.core.migrate import (encode_snapshot as jencode_snapshot,
                                snapshot_tenant as jsnapshot_tenant)
from repro.core.services import MMUConfig as JMMUConfig
from repro.core.services.mmu import MMU as JMMU
from repro.models import transformer as JT
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core import (AppArtifact, Invocation, MigrationError, Oper,
                              PortState, SgEntry, Shell, ShellConfig,
                              migrate)
from repro_torch.core.bitstream import BitstreamError
from repro_torch.core.migrate import (decode_snapshot, encode_snapshot,
                                      snapshot_tenant)
from repro_torch.core.port import PortError
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.models.params import from_reference
from repro_torch.models.ssm import cast
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paged_model import flat_page_indices, gather_kv_pages

torch.set_num_threads(1)
PAGE = 16
POOL = 128
REQS = [(list(range(3, 8)), 0.0), (list(range(3, 20)), 0.0),
        (list(range(3, 12)), 1.3)]


@pytest.fixture(scope="module")
def served():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


@pytest.fixture(scope="module")
def jax_greedy(served):
    """The JAX package's unmoved engine on ``REQS``: its greedy streams."""
    jcfg, jparams = served[:2]
    eng = JEngine(jcfg, jparams, JMMU(JMMUConfig(page_size=PAGE,
                                                 n_pages=POOL)),
                  max_batch=3, max_len=128)
    for prompt, temp in REQS:
        eng.submit(prompt, max_new_tokens=12, temperature=temp)
    eng.run()
    return {r.rid: r.out_tokens for r in eng.completed
            if r.temperature == 0.0}


def _shell(n_vfpgas=2, **mmu_kw):
    kw = dict(page_size=PAGE, n_pages=POOL)
    kw.update(mmu_kw)
    s = Shell(ShellConfig.make(services={"mmu": MMUConfig(**kw)},
                               n_vfpgas=n_vfpgas), device="cpu")
    s.build()
    return s


def _engine(params, shell, cfg, *, tenant="gold", rid_base=0, slot=0,
            max_batch=3, max_len=128):
    return ServingEngine(cfg, params, shell.services.get("mmu"),
                         max_batch=max_batch, max_len=max_len, shell=shell,
                         slot=slot, tenant=tenant, rid_base=rid_base,
                         device="cpu")


def _oracle(cfg, params):
    return ServingEngine(cfg, params, MMU(MMUConfig(page_size=PAGE,
                                                    n_pages=POOL)),
                         max_batch=3, max_len=128, device="cpu")


def _drain(*engines):
    for eng in engines:
        while eng.pending():
            eng.step()


def _streams(eng):
    return {r.rid: r.out_tokens for r in eng.completed}


def _live_pages(engine):
    """{(rid, vpage): {"k", "v"}} for device-resident pages."""
    out = {}
    mmu = engine.mmu
    for sid, se in mmu._seqs.items():
        for pte in se.pages:
            if pte.on_host:
                continue
            flat = flat_page_indices([pte.ppage], engine.cfg.n_layers,
                                     mmu.config.n_pages)
            out[(sid, pte.vpage)] = gather_kv_pages(engine.pools, flat)
    return out


# ================================================== the migration story ====
def test_mid_decode_migrate_token_for_token_parity(served, jax_greedy):
    """A live tenant migrated mid-decode produces exactly the tokens an
    unmigrated engine produces — greedy AND sampled rows; the greedy
    rows are the JAX package's."""
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    eng_src = _engine(params, src, cfg)
    eng_dst = _engine(params, dst, cfg)
    oracle = _oracle(cfg, params)
    for prompt, temp in REQS:
        eng_src.submit(prompt, max_new_tokens=12, temperature=temp)
        oracle.submit(prompt, max_new_tokens=12, temperature=temp)
    for _ in range(4):                       # mid-decode
        eng_src.step()
        oracle.step()
    report = migrate(src, dst, "gold")
    assert report.n_requests == 3
    assert report.downtime_s > 0
    _drain(eng_dst, oracle)
    got = _streams(eng_dst)
    assert got == _streams(oracle)
    assert {r: got[r] for r in jax_greedy} == jax_greedy
    assert src.services.get("mmu").utilization()["pages_used"] == 0
    assert eng_src.active == 0
    src.close()
    dst.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_migrate_kv_bytes_identical_post_restore(served, dtype):
    """Every live KV page lands on the destination byte-identical at its
    sequence's rebuilt mapping; bf16 pools cross the container as tagged
    int16 bits and come back bf16."""
    cfg, params = served[2:]
    params = cast(params, "cpu", dtype)
    src, dst = _shell(), _shell()
    eng_src = _engine(params, src, cfg)
    eng_dst = _engine(params, dst, cfg)
    for n in (5, 30, 17):
        eng_src.submit(list(range(3, 3 + n)), max_new_tokens=20)
    for _ in range(6):
        eng_src.step()
    before = _live_pages(eng_src)
    assert before
    # shared prefix pages ship ONCE in the v2 wire format
    n_phys = len({pte.ppage
                  for se in eng_src.mmu._seqs.values()
                  for pte in se.pages if not pte.on_host})
    report = migrate(src, dst, 0)
    after = _live_pages(eng_dst)
    assert set(after) == set(before)
    for key in before:
        for side in ("k", "v"):
            assert after[key][side].dtype == dtype
            assert torch.equal(before[key][side], after[key][side])
    assert report.n_pages == n_phys <= len(before)
    assert report.payload_bytes > 0
    src.close()
    dst.close()


def test_migrate_replays_held_invocations_zero_lost_dup(served):
    """Invocations held while the source quiesces replay on the
    DESTINATION port: every future resolves exactly once."""
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    _engine(params, src, cfg)
    _engine(params, dst, cfg)
    src_port, dst_port = src.attach(0), dst.attach(0)
    assert src_port.quiesce(timeout=10.0)
    futs = [src_port.submit(Invocation.io(256, tenant="gold"))
            for _ in range(5)]
    assert src_port.held() == 5 and not futs[0].done()
    report = migrate(src, dst, "gold")
    assert report.replayed == 5
    assert all(f.result(timeout=30.0).ok for f in futs)
    assert src_port.held() == 0
    assert src_port.state is PortState.ACTIVE
    assert dst_port.stats()["replayed"] == 5
    dst.drain()
    assert dst.scheduler.stats()["tenants"]["gold"]["completions"] >= 5
    src.close()
    dst.close()


def test_bystander_tenants_on_both_shells_unaffected(served):
    """Bronze tenants drive slot-1 traffic on BOTH shells throughout the
    migration: everything completes, zero intake stalls."""
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    eng_src = _engine(params, src, cfg)
    _engine(params, dst, cfg)
    for shell, name in ((src, "bronze_src"), (dst, "bronze_dst")):
        shell.register_tenant(name, 1.0, slots=(1,))
        shell.load_app(1, AppArtifact(name="echo", fn=lambda i, v, x: x))
    p_src, p_dst = src.attach(1), dst.attach(1)
    eng_src.submit(list(range(3, 20)), max_new_tokens=24)
    for _ in range(3):
        eng_src.step()
    n = 40
    futs = {"src": [], "dst": []}

    def drive(port, key):
        for i in range(n):
            futs[key].append(port.submit(Invocation.from_sg(SgEntry(
                src=np.full(64, i % 251, np.uint8), length=64,
                opcode=Oper.LOCAL_TRANSFER))))

    threads = [threading.Thread(target=drive, args=(p_src, "src")),
               threading.Thread(target=drive, args=(p_dst, "dst"))]
    for t in threads:
        t.start()
    time.sleep(0.002)
    migrate(src, dst, "gold")
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for key in futs:
        comps = [f.result(timeout=30.0) for f in futs[key]]
        assert len(comps) == n and all(c.ok for c in comps)
    src.drain()
    dst.drain()
    for shell, tname in ((src, "bronze_src"), (dst, "bronze_dst")):
        stats = shell.scheduler.stats()["tenants"][tname]
        assert stats["completions"] == n
        assert stats["intake_stalls"] == 0
    src.close()
    dst.close()


def test_migrate_moves_queue_and_avoids_rid_collisions(served):
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    eng_src = _engine(params, src, cfg)
    eng_dst = _engine(params, dst, cfg)
    for n in (5, 7, 9, 11, 6):               # 5 > max_batch=3: 2 queue
        eng_src.submit(list(range(3, 3 + n)), max_new_tokens=4)
    eng_src.step()
    assert len(eng_src.queue) == 2
    report = migrate(src, dst, 0)
    assert report.n_queued == 2
    new_rid = eng_dst.submit(list(range(3, 9)), max_new_tokens=4)
    adopted = ([r.rid for r in eng_dst.slots if r is not None]
               + [r.rid for r in eng_dst.queue])
    assert new_rid not in adopted[:-1]
    _drain(eng_dst)
    assert len(eng_dst.completed) == 6
    assert len({r.rid for r in eng_dst.completed}) == 6
    src.close()
    dst.close()


@pytest.mark.parametrize("refusal", ["capacity", "geometry"])
def test_migrate_refusal_leaves_source_serving(served, refusal):
    """An incoming tenant must FIT and match the destination's geometry:
    a refused move leaves the source serving, untouched."""
    cfg, params = served[2:]
    src = _shell()
    if refusal == "capacity":
        dst, prompt, match = _shell(n_pages=2), list(range(3, 60)), \
            "free pages"
    else:
        dst, prompt, match = _shell(page_size=PAGE * 2), \
            list(range(3, 12)), "geometry mismatch"
    eng_src = _engine(params, src, cfg)
    _engine(params, dst, cfg)
    eng_src.submit(prompt, max_new_tokens=8)
    eng_src.step()
    with pytest.raises(MigrationError, match=match):
        migrate(src, dst, "gold")
    assert src.attach(0).state is PortState.ACTIVE
    _drain(eng_src)
    assert len(eng_src.completed) == 1
    src.close()
    dst.close()


# ===================================================== snapshot format =====
def test_snapshot_version_and_corruption_rejected(served):
    cfg, params = served[2:]
    src = _shell()
    eng = _engine(params, src, cfg)
    eng.submit(list(range(3, 12)), max_new_tokens=6)
    eng.step()
    src.attach(0).quiesce(timeout=10.0)
    header, arrays = snapshot_tenant(src, 0)
    blob = encode_snapshot(header, arrays)
    h2, _ = decode_snapshot(blob)
    assert h2["geometry"] == eng.geometry() and h2["seed"] == eng.seed
    tampered = blob.replace(b'"state_version": 2', b'"state_version": 9', 1)
    with pytest.raises(BitstreamError, match="state version"):
        decode_snapshot(tampered)
    with pytest.raises(BitstreamError):
        decode_snapshot(blob.replace(b'"kind": "migration"',
                                     b'"kind": "app"', 1))
    import zipfile
    with pytest.raises((BitstreamError, zipfile.BadZipFile)):
        decode_snapshot(blob[: len(blob) // 2])
    import pickle
    with pytest.raises(BitstreamError, match="bad magic"):
        decode_snapshot(pickle.dumps({"kind": "migration"}))
    src.close()


# ==================================================== evict-with-copy ======
def test_evicted_pages_ride_migration(served):
    """A tenant with host-evicted pages migrates whole: preserved
    payloads land device-resident on the destination, byte-exact."""
    cfg, params = served[2:]
    src = _shell(n_vfpgas=1, page_size=8, n_pages=8, host_pool_pages=64)
    dst = _shell(n_vfpgas=1, page_size=8, n_pages=32, host_pool_pages=64)
    eng_src = _engine(params, src, cfg, max_batch=2, max_len=80)
    eng_dst = _engine(params, dst, cfg, max_batch=2, max_len=80)
    eng_src.submit(list(range(3, 30)), max_new_tokens=30)
    for _ in range(3):
        eng_src.step()
    mmu = src.services.get("mmu")
    se = mmu._seqs[1]
    pre = {p.vpage: eng_src._pager_gather(p.ppage)
           for p in se.pages if not p.on_host}
    mmu.alloc_seq(99, 8 * (len(mmu._free) + 1))   # evict one page of seq 1
    assert [p.vpage for p in se.pages if p.on_host]
    migrate(src, dst, "gold")
    dmmu = dst.services.get("mmu")
    dse = dmmu._seqs[1]
    assert all(not p.on_host for p in dse.pages)
    for p in dse.pages:
        if p.vpage in pre:
            got = gather_kv_pages(eng_dst.pools, flat_page_indices(
                [p.ppage], cfg.n_layers, dmmu.config.n_pages))
            for side in ("k", "v"):
                assert torch.equal(got[side], pre[p.vpage][side])
    src.close()
    dst.close()


# ================================================= across the frameworks ===
def test_reference_container_restores_into_port_engine(served):
    """The JAX engine serves, snapshots its tenant into the versioned
    container, and keeps decoding; the container's bytes restore into a
    port engine (its JAX PRNG key ignored, the port's seed kept), whose
    greedy decoding continues token for token with the JAX engine's."""
    jcfg, jparams, cfg, params = served
    jshell = JShell(JShellConfig.make(
        services={"mmu": JMMUConfig(page_size=PAGE, n_pages=POOL)},
        n_vfpgas=1))
    jshell.build()
    jeng = JEngine(jcfg, jparams, jshell.services.get("mmu"), max_batch=3,
                   max_len=128, shell=jshell, slot=0, tenant="gold")
    for n in (5, 30, 17, 9):                 # 4 > max_batch: one queued
        jeng.submit(list(range(3, 3 + n)), max_new_tokens=10)
    for _ in range(4):
        jeng.step()
    jport = jshell.attach(0)
    assert jport.quiesce(timeout=10.0) and jeng.flush_io()
    blob = jencode_snapshot(*jsnapshot_tenant(jshell, 0))
    jport.resume()
    _drain(jeng)
    want = _streams(jeng)
    jshell.close()

    header, arrays = decode_snapshot(blob)
    assert "rng" in arrays and "seed" not in header
    shell = _shell(n_vfpgas=1)
    eng = _engine(params, shell, cfg, rid_base=500)
    seed = eng.seed
    stats = eng.restore_state(header, arrays)
    assert stats["requests"] == 3 and stats["queued"] == 1
    assert eng.seed == seed
    _drain(eng)
    assert _streams(eng) == want
    assert shell.services.get("mmu").utilization()["pages_used"] == 0
    shell.close()


def test_take_held_requires_quiesce(served):
    cfg, params = served[2:]
    shell = _shell()
    _engine(params, shell, cfg)
    with pytest.raises(PortError, match="quiesce"):
        shell.attach(0).take_held()
    shell.close()
