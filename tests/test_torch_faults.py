"""Recovery and migration under faults on the port (twin of the
migration and recovery parts of ``tests/test_faults.py``), reduced
smollm-135m fp32 with ``from_reference`` weights: KV-intact in-place
recovery (``Shell.recover_slot``) with a bystander tenant in flight, the
watchdog's wedged-slot sweep, and an injected fault at each migration
stage leaving the source serving.  Greedy streams equal the JAX
package's unmoved engine's; every stream equals the port's unmoved
engine's.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.services import MMUConfig as JMMUConfig
from repro.core.services.mmu import MMU as JMMU
from repro.models import transformer as JT
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core import (AppArtifact, FaultKind, FaultPlan, FaultSpec,
                              Invocation, MigrationError, Oper, PortState,
                              SgEntry, Shell, ShellConfig, migrate)
from repro_torch.core.faults import InjectedFault
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import ServingEngine

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


def _shell():
    s = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=POOL)},
        n_vfpgas=2), device="cpu")
    s.build()
    return s


def _engine(served, shell, **kw):
    cfg, params = served[2:]
    return ServingEngine(cfg, params, shell.services.get("mmu"),
                         max_batch=3, max_len=128, shell=shell, slot=0,
                         tenant="gold", device="cpu", **kw)


def _oracle(served, **kw):
    cfg, params = served[2:]
    return ServingEngine(cfg, params, MMU(MMUConfig(page_size=PAGE,
                                                    n_pages=POOL)),
                         max_batch=3, max_len=128, device="cpu", **kw)


def _drain(*engines):
    for eng in engines:
        while eng.pending():
            eng.step()


def _streams(eng):
    return {r.rid: r.out_tokens for r in eng.completed}


def _sg(i=0, n=64):
    return Invocation.from_sg(SgEntry(src=np.full(n, i % 251, np.uint8),
                                      length=n,
                                      opcode=Oper.LOCAL_TRANSFER))


def test_recover_slot_kv_intact_token_parity(served, jax_greedy):
    """A slot recovered in place (quiesce, snapshot through the
    migration container, cold reset, restore) resumes decoding token for
    token — greedy AND sampled rows — with zero lost or duplicated
    completions, while a bystander tenant's traffic is untouched."""
    shell = _shell()
    eng = _engine(served, shell)
    oracle = _oracle(served)
    for prompt, temp in REQS:
        eng.submit(prompt, max_new_tokens=12, temperature=temp)
        oracle.submit(prompt, max_new_tokens=12, temperature=temp)
    for _ in range(4):
        eng.step()
        oracle.step()
    shell.register_tenant("bronze", 1.0, slots=(1,))
    shell.load_app(1, AppArtifact(name="echo", fn=lambda i, v, x: x))
    bport = shell.attach(1)
    n = 40
    bfuts = []
    t = threading.Thread(
        target=lambda: bfuts.extend(bport.submit(_sg(i)) for i in range(n)))
    t.start()
    report = shell.recover_slot(0)
    t.join(timeout=60)
    assert not t.is_alive()
    assert report.slot == 0 and report.tenant == "gold"
    assert report.n_requests == 3 and report.n_pages > 0
    assert report.downtime_s > 0
    _drain(eng, oracle)
    got = _streams(eng)
    assert got == _streams(oracle)
    assert {r: got[r] for r in jax_greedy} == jax_greedy
    comps = [f.result(timeout=30.0) for f in bfuts]
    assert len(comps) == n and all(c.ok for c in comps)
    shell.drain()
    assert shell.scheduler.stats()["tenants"]["bronze"]["completions"] == n
    pstats = shell.attach(0).stats()
    assert pstats["submitted"] == pstats["completed"] + pstats["failed"]
    assert pstats["inflight"] == 0 and pstats["held"] == 0
    assert shell.health.recoveries == 1
    shell.close()


def test_recover_slot_requeues_chunk_prefilling_rows(served):
    """A row still mid-chunked-prefill has no sampled token: recovery
    demotes it to the queue and re-prefills it, and its stream is the
    unmoved engine's."""
    shell = _shell()
    eng = _engine(served, shell, prefill_chunk=16)
    oracle = _oracle(served, prefill_chunk=16)
    for e in (eng, oracle):
        e.submit(list(range(3, 60)), max_new_tokens=6, temperature=0.7)
        e.submit(list(range(3, 10)), max_new_tokens=6)
    eng.step()
    assert any(r is not None and r.prefill_pos >= 0 for r in eng.slots)
    report = shell.recover_slot(0)
    assert report.n_requests == 1 and report.n_queued == 1
    _drain(eng, oracle)
    assert _streams(eng) == _streams(oracle)
    shell.close()


def test_check_health_detects_and_recovers_wedged_slot(served):
    """The watchdog loop end to end: a slot with pending work and a
    stale heartbeat is flagged WEDGED, recovered, and finishes its decode
    token for token."""
    shell = _shell()
    eng = _engine(served, shell)
    oracle = _oracle(served)
    for e in (eng, oracle):
        e.submit(list(range(3, 12)), max_new_tokens=8)
        e.step()
    shell.health.heartbeat_timeout_s = 0.05
    time.sleep(0.12)
    res = shell.check_health(auto_recover=True)
    assert res["pending"][0] is True
    assert 0 in res["wedged"] and 0 in res["recovered"]
    assert shell.health.status()["fault_counts"]["wedge"] == 1
    _drain(eng, oracle)
    assert _streams(eng) == _streams(oracle)
    time.sleep(0.12)                 # idle slots are never wedged
    assert shell.check_health()["wedged"] == []
    shell.close()


@pytest.mark.parametrize("site", ["migrate.snapshot", "migrate.restore"])
def test_mid_migration_abort_leaves_source_serving_parity(served, site):
    """An injected snapshot- or restore-stage failure aborts the move; the
    source keeps serving and produces the fault-free tokens; the spent
    plan lets the same move go through."""
    src, dst = _shell(), _shell()
    eng_src = _engine(served, src)
    _engine(served, dst)
    oracle = _oracle(served)
    for prompt, temp in REQS[::2]:
        eng_src.submit(prompt, max_new_tokens=10, temperature=temp)
        oracle.submit(prompt, max_new_tokens=10, temperature=temp)
    for _ in range(3):
        eng_src.step()
        oracle.step()
    src.set_fault_plan(FaultPlan([FaultSpec(FaultKind.MIGRATION_FAIL,
                                            site=site)]))
    with pytest.raises((MigrationError, InjectedFault)):
        migrate(src, dst, "gold")
    assert src.health.status()["fault_counts"]["migration_fail"] >= 1
    assert src.attach(0).state is PortState.ACTIVE
    assert dst.services.get("mmu").utilization()["pages_used"] == 0
    _drain(eng_src, oracle)
    assert _streams(eng_src) == _streams(oracle)
    assert migrate(src, dst, "gold").n_requests == 0
    src.close()
    dst.close()
