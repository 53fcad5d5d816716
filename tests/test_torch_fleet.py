"""The fleet controller and the migration surface under fuzz, on the port
(twin of ``tests/test_fleet_fuzz.py``), reduced smollm-135m fp32 with
``from_reference`` weights.  ``fleet/controller.py`` is the reference's
text (``tests/test_torch_shell.py`` checks it).

A state machine drives random interleavings of admit / shared-prefix
admit / decode / CoW write / eviction pressure / pre-copy migration /
injected migration faults across a two-member fleet, checking the MMU
bookkeeping invariants on both members after every op, and at the end
exactly-once completion and zero page leaks.  It runs under real
Hypothesis with ``deadline=None``: the reference's twin sets no deadline
and fails on Hypothesis's 200 ms default (ROADMAP queue 3).  A wedged
slot healed by ``sweep`` decodes on token for token, the greedy stream
equal to the JAX package's unmoved engine's.
"""
from __future__ import annotations

import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # offline: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.core.services import MMUConfig as JMMUConfig
from repro.core.services.mmu import MMU as JMMU
from repro.models import transformer as JT
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core import Shell, ShellConfig
from repro_torch.core.faults import (FaultKind, FaultPlan, FaultSpec,
                                     InjectedFault)
from repro_torch.core.migrate import MigrationError, migrate_precopy
from repro_torch.core.services.mmu import MMU, MMUConfig, PageFaultError
from repro_torch.fleet import FleetController
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.gateway import ServingGateway

torch.set_num_threads(1)
PAGE = 8
POOL = 48          # small device pool: eviction pressure is reachable
HOST = 96
FAULT_SITES = ["migrate.precopy", "migrate.snapshot",
               "migrate.restore", "migrate.replay"]


@pytest.fixture(scope="module")
def served():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


def _shell(name, pool=POOL):
    s = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=pool,
                                   host_pool_pages=HOST)},
        n_vfpgas=2), name=name, device="cpu")
    s.build()
    s.health.quarantine_after = 10**6    # fault storms must not close intake
    return s


def _engine(served, shell, *, rid_base=0):
    cfg, params = served[2:]
    return ServingEngine(cfg, params, shell.services.get("mmu"),
                         max_batch=4, max_len=256, shell=shell, slot=0,
                         tenant="gold", rid_base=rid_base, device="cpu")


def _check_mmu(mmu: MMU) -> None:
    """MMU bookkeeping invariants; cheap enough to run after every op."""
    free = list(mmu._free)
    assert len(free) == len(set(free)), "duplicate pages in free list"
    assert not (set(free) & set(mmu._ref)), "page both free and mapped"
    assert len(free) + len(mmu._ref) == mmu.config.n_pages
    hfree = list(mmu._host_free)
    assert len(hfree) == len(set(hfree))
    assert not (set(hfree) & set(mmu._host_ref))
    dcount, hcount = {}, {}
    for se in mmu._seqs.values():
        for p in se.pages:
            if p.on_host:
                if p.host_slot >= 0:
                    hcount[p.host_slot] = hcount.get(p.host_slot, 0) + 1
            else:
                dcount[p.ppage] = dcount.get(p.ppage, 0) + 1
    for pp, n in dcount.items():
        assert mmu._ref.get(pp, 0) >= n, f"device page {pp} under-refed"
    for hs, n in hcount.items():
        assert mmu._host_ref.get(hs, 0) >= n, f"host slot {hs} under-refed"
    for kind, ident in mmu._dirty:
        live = mmu._ref if kind == "d" else mmu._host_ref
        assert ident in live, f"dirty flag ({kind},{ident}) on dead page"


class _Machine:
    """Two-member fleet as a fuzzable state machine."""

    OPS = {0: "op_admit", 1: "op_admit", 2: "op_admit_shared",
           3: "op_decode", 4: "op_decode", 5: "op_cow_write",
           6: "op_evict_pressure", 7: "op_migrate", 8: "op_migrate",
           9: "op_fault_migrate"}

    def __init__(self, served, rng: random.Random):
        self.rng = rng
        self.shells = [_shell("fz-a"), _shell("fz-b")]
        self.engines = [_engine(served, self.shells[0], rid_base=0),
                        _engine(served, self.shells[1], rid_base=1000)]
        self.cur = 0                     # member currently owning "gold"
        self.submitted = []
        self.last_prompt = None
        self.naux = 0

    def _inflight(self) -> int:
        done = sum(len(e.completed) for e in self.engines)
        return len(self.submitted) - done

    def op_admit(self):
        if self._inflight() >= 5:
            return
        n = self.rng.randrange(6, 30)
        start = self.rng.randrange(0, 40)
        prompt = list(range(3 + start, 3 + start + n))
        self.last_prompt = prompt
        self.submitted.append(self.engines[self.cur].submit(
            prompt, max_new_tokens=self.rng.randrange(4, 12)))

    def op_admit_shared(self):
        if self.last_prompt is None or self._inflight() >= 5:
            return self.op_admit()
        head = self.last_prompt[:max(len(self.last_prompt) // 2, 1)]
        tail = [self.rng.randrange(3, 60)
                for _ in range(self.rng.randrange(2, 10))]
        self.submitted.append(self.engines[self.cur].submit(
            head + tail, max_new_tokens=self.rng.randrange(4, 12)))

    def op_decode(self):
        for _ in range(self.rng.randrange(1, 3)):
            self.engines[self.cur].step()

    def op_cow_write(self):
        mmu = self.shells[self.cur].services.get("mmu")
        sids = [sid for sid, se in mmu._seqs.items() if se.pages]
        if sids:
            mmu.translate(self.rng.choice(sids), 0, for_write=True)

    def op_evict_pressure(self):
        mmu = self.shells[self.cur].services.get("mmu")
        sid = 10**6 + self.naux
        self.naux += 1
        try:
            mmu.alloc_seq(sid, PAGE * self.rng.randrange(2, 6), slot=1)
        except PageFaultError:
            pass                         # both pools full: legal outcome
        if sid in mmu._seqs:
            mmu.free_seq(sid)

    def op_migrate(self):
        src, dst = self.shells[self.cur], self.shells[1 - self.cur]
        migrate_precopy(src, dst, "gold", max_rounds=2, drain_timeout=10.0)
        self.cur = 1 - self.cur

    def op_fault_migrate(self):
        site = self.rng.choice(FAULT_SITES)
        src, dst = self.shells[self.cur], self.shells[1 - self.cur]
        src.set_fault_plan(FaultPlan([FaultSpec(
            FaultKind.MIGRATION_FAIL, site=site,
            after=self.rng.randrange(0, 2))]))
        try:
            migrate_precopy(src, dst, "gold", max_rounds=2,
                            drain_timeout=10.0)
        except (MigrationError, InjectedFault):
            if site == "migrate.replay":
                self.cur = 1 - self.cur  # replay fires after evacuation
        else:
            self.cur = 1 - self.cur      # the fault never fired
        finally:
            src.set_fault_plan(None)
        self.engines[self.cur].step()    # the owner must still serve

    def apply(self, code: int) -> None:
        getattr(self, self.OPS[code])()
        for s in self.shells:
            _check_mmu(s.services.get("mmu"))

    def finish(self) -> None:
        for _ in range(600):
            if not any(e.pending() for e in self.engines):
                break
            for e in self.engines:
                if e.pending():
                    e.step()
        else:
            raise AssertionError("drain did not converge")
        done = sorted(r.rid for e in self.engines for r in e.completed)
        assert done == sorted(self.submitted), \
            f"lost/duplicated requests: {done} vs {self.submitted}"
        for s in self.shells:
            mmu = s.services.get("mmu")
            _check_mmu(mmu)
            u = mmu.utilization()
            assert u["pages_used"] == 0 and u["sequences"] == 0, u
            assert not mmu._ref and not mmu._host_ref, "page leak"
            s.close()


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16),
       ops=st.lists(st.integers(min_value=0, max_value=9),
                    min_size=1, max_size=12))
def test_migration_surface_fuzz(served, seed, ops):
    m = _Machine(served, random.Random(seed * 2654435761 + 17))
    try:
        for code in ops:
            m.apply(code)
    finally:
        m.finish()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_migration_fault_storm(served, seed):
    """Hostile mix: every other op is a migration or an injected fault."""
    rng = random.Random(seed)
    m = _Machine(served, rng)
    codes = [0, 3, 2, 3] + [rng.choice([3, 5, 6, 7, 9, 9])
                            for _ in range(12)]
    try:
        for code in codes:
            m.apply(code)
    finally:
        m.finish()


# --------------------------------------------------------------------------
# FleetController: deterministic unit tests
# --------------------------------------------------------------------------
def test_placement_scoring_exclusion_and_fault_penalty():
    a, b = _shell("pl-a", pool=32), _shell("pl-b", pool=64)
    fc = FleetController()
    fc.add_shell(a)
    fc.add_shell(b)
    with pytest.raises(ValueError, match="duplicate"):
        fc.add_shell(_shell("pl-a"))
    a.services.get("mmu").alloc_seq(1, PAGE * 3)
    assert fc.place(pages_needed=2) is b
    assert fc.place(pages_needed=2, exclude=("pl-b",)) is a
    assert fc.placement_score(a, pages_needed=10**6) is None
    assert fc.place(pages_needed=10**6) is None
    a.services.get("mmu").free_seq(1)
    for _ in range(4):
        b.health.record_fault(FaultKind.MIGRATION_FAIL, tenant=None,
                              strike=False)
    assert fc.place(pages_needed=2) is a
    assert fc.decisions[-1].action == "place"
    a.close()
    b.close()


def test_sweep_heals_wedged_slot_token_exact(served):
    jcfg, jparams, cfg, params = served
    shell = _shell("heal-a", pool=64)
    shell.health.heartbeat_timeout_s = 0.05
    eng = _engine(served, shell)
    oracle = ServingEngine(cfg, params, MMU(MMUConfig(
        page_size=PAGE, n_pages=64, host_pool_pages=HOST)), max_batch=4,
        max_len=256, device="cpu")
    joracle = JEngine(jcfg, jparams, JMMU(JMMUConfig(
        page_size=PAGE, n_pages=64, host_pool_pages=HOST)), max_batch=4,
        max_len=256)
    prompt = list(range(3, 23))
    for e in (eng, oracle, joracle):
        e.submit(prompt, max_new_tokens=8)
        e.submit(prompt[:9], max_new_tokens=8, temperature=0.9)
    eng.step()                           # beats, then goes silent...
    time.sleep(0.12)                     # ...past the heartbeat timeout
    fc = FleetController()
    fc.add_shell(shell)
    healed = [d for d in fc.sweep() if d.action == "recover" and d.ok]
    assert healed and healed[0].src == "heal-a"
    assert healed[0].report.n_requests == 2
    assert fc.status()["recoveries"] == 1
    for e in (eng, oracle, joracle):
        while e.pending():
            e.step()
    got = {r.rid: r.out_tokens for r in eng.completed}
    assert got == {r.rid: r.out_tokens for r in oracle.completed}
    assert got[1] == joracle.completed[0].out_tokens   # greedy row
    shell.close()


def test_sweep_hotspot_migrates_and_reroutes_gateway(served):
    hot, cold = _shell("hs-hot", pool=16), _shell("hs-cold", pool=64)
    eng_hot = _engine(served, hot, rid_base=0)
    eng_cold = _engine(served, cold, rid_base=1000)
    gw_hot = ServingGateway(eng_hot, admission="fifo")
    gw_cold = ServingGateway(eng_cold, admission="fifo")
    fc = FleetController(precopy=True, hot_util=0.25, cold_util=0.60)
    fc.add_shell(hot)
    fc.add_shell(cold)
    fc.attach_gateway(hot, gw_hot)
    fc.attach_gateway(cold, gw_cold)
    stream = gw_hot.submit(list(range(3, 43)), max_new_tokens=8)
    for _ in range(2):
        gw_hot.step()                    # 5/16 pages used: above hot_util
    moved = [d for d in fc.sweep() if d.action == "migrate" and d.ok]
    assert moved and moved[0].src == "hs-hot" and moved[0].dst == "hs-cold"
    assert moved[0].report.precopy_rounds >= 1
    assert fc.status()["moves"] == 1
    gw_cold.drain()
    assert stream.done and stream.error is None and len(stream.tokens) == 8
    assert not gw_hot.streams and not gw_hot.queue
    assert [id(s) for s in gw_cold.completed] == [id(stream)]
    hot.close()
    cold.close()


def test_migrate_tenant_operator_verb_and_unknown(served):
    a, b = _shell("op-a"), _shell("op-b")
    eng_a = _engine(served, a, rid_base=0)
    _engine(served, b, rid_base=1000)
    fc = FleetController(precopy=False)
    fc.add_shell(a)
    fc.add_shell(b)
    rid = eng_a.submit(list(range(3, 20)), max_new_tokens=6)
    eng_a.step()
    d = fc.migrate_tenant("gold")
    assert d.ok and d.src == "op-a" and d.dst == "op-b"
    assert d.report.precopy_rounds == 0          # stop-and-copy
    dst_eng = b.engines[d.report.dst_slot]
    while dst_eng.pending():
        dst_eng.step()
    assert [r.rid for r in dst_eng.completed] == [rid]
    with pytest.raises(KeyError, match="ghost"):
        fc.migrate_tenant("ghost")
    a.close()
    b.close()
