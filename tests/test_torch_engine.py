"""Port serving engine on the CPU against the reference engine.

Both engines serve reduced smollm-135m at float32 on the same weights;
the reference runs its Pallas paged-attention kernel in interpret mode
(``use_pallas=True``).  Greedy token streams must be identical under slot
churn, page-pressure eviction, prefix sharing on and off, and chunked and
one-shot prefill.  Sampled streams (Philox in the port, threefry in the
reference) are held to the port's own invariants instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.core.services.mmu import MMU as JMMU, MMUConfig as JMMUConfig
from repro.models import transformer as JT
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import ServingEngine

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


def _run(served, port, prompts, *, mmu_kw, new_tokens=4, modes=None,
         **eng_kw):
    jcfg, jparams, cfg, params = served
    if port:
        mmu = MMU(MMUConfig(**mmu_kw))
        eng = ServingEngine(cfg, params, mmu, device="cpu", **eng_kw)
    else:
        mmu = JMMU(JMMUConfig(**mmu_kw))
        eng = JEngine(jcfg, jparams, mmu, use_pallas=True, **eng_kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=new_tokens,
                   **(modes[i] if modes else {}))
    stats = eng.run()
    assert stats["completed"] == len(prompts)
    assert mmu.utilization()["pages_used"] == 0
    return {r.rid: r.out_tokens for r in eng.completed}, mmu.utilization()


def _both(served, prompts, **kw):
    ref, ref_util = _run(served, False, prompts, **kw)
    got, util = _run(served, True, prompts, **kw)
    assert got == ref
    return got, util, ref_util


def test_greedy_streams_match_reference_with_slot_churn(served):
    # 5 requests through 2 slots; prompt 16 lands on a page boundary
    prompts = [list(range(3, 3 + n)) for n in (16, 5, 12, 9, 17)]
    _both(served, prompts, mmu_kw=dict(page_size=16, n_pages=128),
          max_batch=2, max_len=128)


def test_h2o_danube_head_dim_120_streams_match_reference():
    """Reduced h2o-danube-3-4b with its published head_dim of 120 kept (the
    reduced configs all have 32): the port's paged engine gives the JAX
    engine's greedy tokens (its Pallas kernel in interpret mode), with
    churn through 2 slots and chunked prefill."""
    jcfg = dataclasses.replace(jget("h2o-danube-3-4b").reduced(),
                               head_dim=120)
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                              head_dim=120)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["layers"]["attn"]["wq"].shape[-1] == cfg.n_heads * 120
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 30, 9)]
    _both((jcfg, jparams, cfg, params), prompts,
          mmu_kw=dict(page_size=8, n_pages=64), max_batch=2, max_len=64,
          prefill_chunk=16, new_tokens=6)


def test_greedy_streams_match_reference_in_a_tiny_pool(served):
    # the reference's page-pressure scenario (tests/test_serving.py:61)
    prompts = [list(range(3, 40)), list(range(3, 50))]
    _, util, ref_util = _both(
        served, prompts, mmu_kw=dict(page_size=8, n_pages=24,
                                     host_pool_pages=64),
        max_batch=2, max_len=80)
    assert util == ref_util


def _evicting_run(served, port):
    """Two live rows, then a foreign sequence allocated straight on the
    MMU steals pages: the pager evicts the rows' tail pages to the host
    (their block-table entries turn -1) and decode goes on degraded."""
    jcfg, jparams, cfg, params = served
    kw = dict(page_size=8, n_pages=24, host_pool_pages=64)
    if port:
        mmu = MMU(MMUConfig(**kw))
        eng = ServingEngine(cfg, params, mmu, max_batch=2, max_len=80,
                            device="cpu")
    else:
        mmu = JMMU(JMMUConfig(**kw))
        eng = JEngine(jcfg, jparams, mmu, max_batch=2, max_len=80,
                      use_pallas=True)
    eng.submit(list(range(3, 40)), max_new_tokens=12)
    eng.submit(list(range(3, 50)), max_new_tokens=12)
    eng.step()
    free = 24 - mmu.utilization()["pages_used"]
    mmu.alloc_seq(10_000, (free + 3) * 8)            # 3 pages short
    for _ in range(3):
        eng.step()
    mmu.free_seq(10_000)
    eng.run()
    util = mmu.utilization()
    assert util["pages_used"] == 0 and len(eng.completed) == 2
    return {r.rid: r.out_tokens for r in eng.completed}, util


def test_greedy_streams_match_reference_under_eviction(served):
    ref, ref_util = _evicting_run(served, False)
    got, util = _evicting_run(served, True)
    assert got == ref
    assert util["migrations_out"] == ref_util["migrations_out"] >= 3
    assert util["page_faults"] == ref_util["page_faults"] > 0


@pytest.mark.parametrize("sharing", [True, False], ids=["shared", "private"])
def test_greedy_streams_match_reference_with_prefix_sharing(served, sharing):
    rs = np.random.RandomState(4)
    prefix = rs.randint(0, 512, 32).tolist()
    prompts = [prefix + rs.randint(0, 512, n).tolist() for n in (3, 9, 17)]
    prompts.append(rs.randint(0, 512, 20).tolist())
    got, util, _ = _both(served, prompts,
                         mmu_kw=dict(page_size=8, n_pages=128,
                                     prefix_sharing=sharing),
                         max_batch=2, max_len=96, new_tokens=5)
    assert (util["prefix_hits"] > 0) == sharing
    # sharing changes which pages hold the prefix, never the tokens
    other, _ = _run(served, True, prompts,
                    mmu_kw=dict(page_size=8, n_pages=128,
                                prefix_sharing=not sharing),
                    max_batch=2, max_len=96, new_tokens=5)
    assert other == got


@pytest.mark.parametrize("chunk", [None, 8], ids=["oneshot", "chunk8"])
def test_greedy_streams_match_reference_chunked_and_one_shot(served, chunk):
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 512, n).tolist() for n in (30, 7, 19, 41)]
    _both(served, prompts, mmu_kw=dict(page_size=8, n_pages=128),
          max_batch=3, max_len=96, prefill_chunk=chunk)


SAMPLED = [{"temperature": 1.0}, {"temperature": 0.8, "top_k": 5},
           {}, {"temperature": 1.2, "top_p": 0.7}]


def test_sampled_chunked_equals_one_shot(served):
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 512, n).tolist() for n in (30, 7, 19, 41)]
    runs = [_run(served, True, prompts, mmu_kw=dict(page_size=8,
                                                    n_pages=128),
                 modes=SAMPLED, new_tokens=6, max_batch=3, max_len=96,
                 prefill_chunk=chunk)[0] for chunk in (None, 8, 16)]
    assert runs[0] == runs[1] == runs[2]


def test_sampled_stream_independent_of_other_admissions(served):
    rs = np.random.RandomState(7)
    mine = rs.randint(0, 512, 13).tolist()
    others = [rs.randint(0, 512, n).tolist() for n in (5, 22, 9)]
    kw = dict(mmu_kw=dict(page_size=8, n_pages=128), new_tokens=8,
              max_len=96)
    alone, _ = _run(served, True, [mine], modes=[SAMPLED[0]], max_batch=1,
                    **kw)
    crowd, _ = _run(served, True, [mine] + others,
                    modes=[SAMPLED[0]] + SAMPLED[1:], max_batch=3, **kw)
    assert alone[1] == crowd[1]              # rid 1 in both runs


@settings(max_examples=4, deadline=None)
@given(chunk=st.sampled_from([4, 8, 16]), batch=st.integers(1, 3),
       seed=st.integers(0, 1000))
def test_sampled_streams_ignore_chunk_size_and_batch(served, chunk, batch,
                                                     seed):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, 512, n).tolist()
               for n in rs.randint(3, 40, size=3)]
    kw = dict(mmu_kw=dict(page_size=8, n_pages=128), modes=SAMPLED[:3],
              new_tokens=4, max_len=96)
    base, _ = _run(served, True, prompts, max_batch=3, **kw)
    got, _ = _run(served, True, prompts, max_batch=batch,
                  prefill_chunk=chunk, **kw)
    assert got == base


def test_submit_rejects_out_of_vocab_tokens(served):
    cfg, params = served[2], served[3]
    eng = ServingEngine(cfg, params, MMU(MMUConfig(page_size=8, n_pages=16)),
                        device="cpu")
    for bad in ([1, cfg.vocab_size], [-1, 2]):
        with pytest.raises(ValueError, match="out of range"):
            eng.submit(bad)


def test_later_slices_raise(served):
    cfg, params = served[2], served[3]
    for kw in ({"mesh": object()}, {"collectives": object()}):
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, params, MMU(MMUConfig(page_size=8,
                                                     n_pages=16)),
                          device="cpu", **kw)
    # shell binding is no longer a later slice: the engine binds to the
    # slot's port and registers with the shell
    from repro_torch.core import Shell, ShellConfig
    shell = Shell(ShellConfig.make(services={}, n_vfpgas=1), device="cpu")
    eng = ServingEngine(cfg, params, MMU(MMUConfig(page_size=8, n_pages=16)),
                        device="cpu", shell=shell, slot=0, tenant="t")
    assert eng.port is shell.attach(0) and shell.engines[0] is eng
    shell.close()


def test_engine_needs_the_card_unless_asked_for_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, params = served[2], served[3]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, MMU(MMUConfig(page_size=8, n_pages=16)))


def test_one_engine_per_mmu(served):
    cfg, params = served[2], served[3]
    mmu = MMU(MMUConfig(page_size=8, n_pages=16))
    ServingEngine(cfg, params, mmu, device="cpu")
    with pytest.raises(RuntimeError, match="pager"):
        ServingEngine(cfg, params, mmu, device="cpu")
