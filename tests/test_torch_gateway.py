"""The serving gateway on the port's engine (twin of
``tests/test_gateway.py``'s gateway parts), reduced smollm-135m fp32 with
``from_reference`` weights.  ``serve/gateway.py`` is the reference's text
(``tests/test_torch_shell.py`` checks it); what is new underneath is the
engine's ``admission_hook``, ``token_sink``, step-time EWMAs and request
``priority``/``deadline_s``.  Greedy gateway streams equal the JAX
package's gateway's token for token; sampled streams equal a direct port
engine's; rejections are typed; every accepted request completes exactly
once.
"""
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
from repro.serve.gateway import ServingGateway as JGateway
from repro_torch.configs import get_config
from repro_torch.core import Shell, ShellConfig
from repro_torch.core.faults import FaultKind
from repro_torch.core.port import PortError
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.models.params import from_reference
from repro_torch.serve import ServingGateway
from repro_torch.serve.engine import ServingEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


def _prompts(cfg, lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def _engine(served, *, max_batch=4, max_len=512, seed=3, port=True, **kw):
    jcfg, jparams, cfg, params = served
    if port:
        return ServingEngine(cfg, params, MMU(MMUConfig(page_size=16,
                                                        n_pages=256)),
                             max_batch=max_batch, max_len=max_len,
                             seed=seed, device="cpu", **kw)
    return JEngine(jcfg, jparams, JMMU(JMMUConfig(page_size=16,
                                                  n_pages=256)),
                   max_batch=max_batch, max_len=max_len, seed=seed, **kw)


def test_gateway_greedy_streams_match_reference_gateway(served):
    """Continuous backfill over a 2-slot engine, priorities and FIFO
    admission: the port's streams equal the JAX gateway's, by arrival."""
    cfg = served[2]
    prompts = _prompts(cfg, (41, 7, 19, 64, 11), seed=13)
    got = {}
    for port in (False, True):
        eng = _engine(served, max_batch=2, port=port)
        gw = (ServingGateway if port else JGateway)(eng, admission="fifo")
        for i, p in enumerate(prompts):
            gw.submit(p, max_new_tokens=8, priority=i % 2)
        gw.drain()
        got[port] = [s.tokens for s in sorted(gw.completed,
                                              key=lambda s: s.gid)]
    assert got[True] == got[False]


def test_gateway_streams_match_direct_engine_exactly_once(served):
    """Sampled streams through the gateway's continuous backfill over a
    2-slot engine equal a direct 4-slot engine's; every stream completes
    exactly once."""
    cfg = served[2]
    prompts = _prompts(cfg, (41, 7, 19, 64, 11), seed=13)
    ref_eng = _engine(served, seed=5)
    for p in prompts:
        ref_eng.submit(p, max_new_tokens=8, temperature=0.8, top_k=5)
    ref_eng.run()
    ref = [r.out_tokens for r in sorted(ref_eng.completed,
                                        key=lambda r: r.rid)]
    eng = _engine(served, max_batch=2, seed=5)
    gw = ServingGateway(eng, mode="continuous", admission="fifo")
    streams = [gw.submit(p, max_new_tokens=8, temperature=0.8, top_k=5)
               for p in prompts]
    gw.drain()
    assert [s.tokens for s in sorted(gw.completed,
                                     key=lambda s: s.gid)] == ref
    assert sorted(s.gid for s in streams) == sorted(s.gid
                                                    for s in gw.completed)
    assert all(s.done and s.error is None for s in streams)
    assert not gw.streams and not gw.queue
    st = gw.stats()
    assert st["completed"] == st["dispatched"] == len(prompts)
    assert st["goodput"] > 0 and st["ttft_p99_ms"] >= st["ttft_p50_ms"]
    assert st["tpot_p50_ms"] > 0


def test_engine_hooks_and_step_time_estimates(served):
    """The engine hooks the gateway rides on: ``admission_hook`` runs
    before every admission, ``token_sink`` sees each emitted token once
    (prefill first tokens included) with ``done`` on the last, and both
    EWMAs hold positive estimates after a run."""
    cfg = served[2]
    eng = _engine(served, max_batch=2, max_len=128, prefill_chunk=16)
    calls, seen = [], {}
    eng.admission_hook = lambda e: calls.append(e.steps)
    eng.token_sink = lambda req, tok, done: seen.setdefault(
        req.rid, []).append((tok, done))
    for p in _prompts(cfg, (9, 40, 13)):
        eng.submit(p, max_new_tokens=5, priority=2, deadline_s=1e9)
    eng.run()
    assert len(calls) >= eng.steps
    for r in eng.completed:
        assert [t for t, _ in seen[r.rid]] == r.out_tokens
        assert [d for _, d in seen[r.rid]] == [False] * 4 + [True]
        assert r.priority == 2 and r.deadline_s == 1e9
    assert eng.ewma_prefill_s_per_tok > 0 and eng.ewma_decode_step_s > 0
    assert eng.prefill_obs >= 2 and eng.decode_obs == eng.steps
    assert eng._ewma(1.0, 100.0) == pytest.approx(0.75 + 0.25 * 10.0)


def test_continuous_backfills_while_wave_waits_for_drain(served):
    def dispatch_overlap(mode):
        eng = _engine(served, max_batch=2, max_len=128, seed=0)
        gw = ServingGateway(eng, mode=mode, admission="fifo")
        gw.submit(list(range(3, 9)), max_new_tokens=2)
        long = gw.submit(list(range(3, 12)), max_new_tokens=24)
        third = gw.submit(list(range(3, 7)), max_new_tokens=2)
        for _ in range(200):
            gw.step()
            if third.rid is not None:
                break
        overlap = not long.done
        gw.drain()
        assert third.done and long.done
        return overlap

    assert dispatch_overlap("continuous") is True
    assert dispatch_overlap("wave") is False


def test_slo_infeasible_deadline_rejected_at_the_door(served):
    cfg = served[2]
    eng = _engine(served, max_batch=2, max_len=128)
    gw = ServingGateway(eng, min_obs=1)
    for p in _prompts(cfg, (9, 13)):
        gw.submit(p, max_new_tokens=4)
    gw.drain()
    assert gw._service_estimate(32, 8) is not None
    with pytest.raises(PortError) as ei:
        gw.submit(list(range(3, 35)), max_new_tokens=8, deadline_s=1e-6)
    assert ei.value.kind == FaultKind.SLO_INFEASIBLE
    assert not ei.value.retryable
    assert gw.rejected_infeasible == 1
    assert gw.rejected[-1].error is ei.value


def test_queued_request_expires_past_its_deadline(served):
    eng = _engine(served, max_batch=2, max_len=128)
    gw = ServingGateway(eng)            # cold EWMAs: door check skipped
    s = gw.submit(list(range(3, 12)), max_new_tokens=4, deadline_s=0.01)
    time.sleep(0.02)
    gw.step()
    assert s.rejected and s.error.kind == FaultKind.SLO_EXPIRED
    assert s.rid is None and not s.done
    assert gw.expired == 1 and not gw.queue


def test_priority_ages_as_deadline_approaches(served):
    eng = _engine(served, max_batch=1, max_len=128)
    gw = ServingGateway(eng, aging_window_s=10.0, aging_max=4)
    lo = gw.submit(list(range(3, 9)), max_new_tokens=2)
    hot = gw.submit(list(range(3, 10)), max_new_tokens=2, deadline_s=5.0)
    gw.step()
    assert hot.priority < hot.eff_priority <= hot.priority + 4
    assert hot.rid is not None and lo.rid is None
    req = next(r for r in list(eng.slots) + eng.completed
               if r is not None and r.rid == hot.rid)
    assert req.priority == hot.eff_priority
    gw.drain()
    assert lo.done and hot.done


def test_gateway_full_backpressure_is_typed_and_retryable(served):
    eng = _engine(served, max_batch=2, max_len=128)
    gw = ServingGateway(eng, max_queue=1)
    s1 = gw.submit(list(range(3, 8)), max_new_tokens=2)
    with pytest.raises(PortError) as ei:
        gw.submit(list(range(3, 8)), max_new_tokens=2)
    assert ei.value.kind == FaultKind.GATEWAY_FULL and ei.value.retryable
    gw.drain()
    assert s1.done and len(gw.completed) == 1


def test_nothing_lost_or_duplicated_under_slo_churn(served):
    cfg = served[2]
    eng = _engine(served, max_batch=2, max_len=128)
    gw = ServingGateway(eng)
    ok = [gw.submit(p, max_new_tokens=4, priority=pr)
          for pr, p in enumerate(_prompts(cfg, (9, 21, 13), seed=23))]
    dead = gw.submit(list(range(3, 9)), max_new_tokens=4,
                     deadline_s=0.005)
    time.sleep(0.01)
    gw.drain()
    assert dead.rejected and dead.error.kind == FaultKind.SLO_EXPIRED
    assert all(s.done and len(s.tokens) == 4 for s in ok)
    gids = [s.gid for s in gw.completed] + [s.gid for s in gw.rejected]
    assert sorted(gids) == list(range(gw.submitted))
    st = gw.stats()
    assert st["submitted"] == st["completed"] + st["expired"]
    assert st["queued"] == 0 and not gw.streams


def test_gateway_admissions_are_port_billed_and_quarantine_applies(served):
    cfg, params = served[2:]
    shell = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=16, n_pages=128)},
        n_vfpgas=2), device="cpu")
    shell.build()
    try:
        eng = ServingEngine(cfg, params, shell.services.get("mmu"),
                            max_batch=2, max_len=128, shell=shell, slot=0,
                            tenant="gold", device="cpu")
        gw = ServingGateway(eng, admission="fifo")
        for p in _prompts(cfg, (9, 13, 7), seed=31):
            gw.submit(p, max_new_tokens=2)
        gw.drain()
        assert eng.flush_io()
        assert not gw._admit_futs
        assert shell.scheduler.stats()["tenants"]["gold"]["completions"] \
            >= 3
        shell.health.quarantine("gold")
        with pytest.raises(PortError) as ei:
            gw.submit(list(range(3, 8)), max_new_tokens=2)
        assert ei.value.kind == FaultKind.QUARANTINED
    finally:
        shell.close()
