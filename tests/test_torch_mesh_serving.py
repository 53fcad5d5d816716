"""Tensor-parallel paged serving of the port against its single-process
engine and the JAX package.

Twin of ``tests/test_mesh_serving.py``.  A ``ServingEngine`` given a
``DeviceMesh`` whose ``model`` dim is larger than one must produce exactly
the tokens the port's single-process engine produces — greedy and sampled
rows, through admission churn, eviction and fault-back-in, live migration
and in-place slot recovery — on every rank, and its greedy rows must be
the JAX engine's.  Logits differ in the last ulp across TP degrees (the
partial sums meet in another order); tokens must not.

The reference forces host devices in subprocesses; here each multi-rank
case runs its ranks through ``repro_torch.launch.mesh.run_ranks`` (gloo on
the CPU, one thread a rank, a 60 s timeout on every collective).  The rank
bodies are in ``tests/_torch_tp_ranks.py``, which imports no JAX; the
comparisons with the JAX package run here.  The in-process tests cover
the policy pieces (``MeshRules``, ``tp_plan``, ``make_host_mesh``'s
error) against the reference functions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.configs import get_config as jget
from repro.core.services.mmu import MMU as JMMU, MMUConfig as JMMUConfig
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as JT
from repro.models.sharding import MeshRules as JMeshRules
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.tp import tp_plan as jtp_plan
from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models.params import from_reference
from repro_torch.models.sharding import MeshRules
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.tp import tp_plan

torch.set_num_threads(1)

# 5 requests through 2 slots: admission churn and queueing; greedy,
# sampled, and top-k / top-p filtered rows (the reference's mix)
CHURN = [(list(range(3, 9)), dict(max_new_tokens=10)),
         (list(range(3, 17)), dict(max_new_tokens=10, temperature=0.8)),
         (list(range(5, 11)), dict(max_new_tokens=10, temperature=1.3,
                                   top_k=5)),
         (list(range(2, 14)), dict(max_new_tokens=10, temperature=0.7,
                                   top_p=0.9)),
         (list(range(9, 15)), dict(max_new_tokens=10))]
TP4 = [([1, 2, 3, 4, 5], dict(max_new_tokens=8)),
       ([7, 8, 9], dict(max_new_tokens=8, temperature=0.9)),
       (list(range(11, 18)), dict(max_new_tokens=8, temperature=1.2))]
MIGRATE = [(list(range(3, 8)), dict(max_new_tokens=12)),
           (list(range(3, 20)), dict(max_new_tokens=12)),
           (list(range(3, 12)), dict(max_new_tokens=12, temperature=1.3))]


def _weights(cfg_kw):
    """The same numpy weights for both packages (JAX's init, seed 0)."""
    jcfg = dataclasses.replace(jget("smollm-135m").reduced(), **cfg_kw)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _single(cfg_kw, np_params, reqs, eng_kw, mmu_kw):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **cfg_kw)
    eng = ServingEngine(cfg, from_reference(np_params, device="cpu"),
                        MMU(MMUConfig(**mmu_kw)), device="cpu", **eng_kw)
    for prompt, kw in reqs:
        eng.submit(prompt, **kw)
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.completed}


def _jax_greedy(jcfg, jparams, reqs, eng_kw, mmu_kw):
    eng = JEngine(jcfg, jparams, JMMU(JMMUConfig(**mmu_kw)), **eng_kw)
    for prompt, kw in reqs:
        eng.submit(prompt, **kw)
    eng.run()
    greedy = {i + 1 for i, (_, kw) in enumerate(reqs)
              if kw.get("temperature", 0.0) == 0.0}
    return {r.rid: list(r.out_tokens) for r in eng.completed
            if r.rid in greedy}


# ================================================ in-process (1 rank) ====
def test_meshrules_unknown_scheme_raises():
    for rules in (MeshRules, JMeshRules):
        with pytest.raises(ValueError, match="unknown MeshRules scheme"):
            rules.from_mesh(None, "diagonal")   # checked before mesh use


def test_meshrules_tp_divisibility_degrades_to_replication():
    kw = dict(fsdp_axes=("data",), tp_axis="model", fsdp_size=0, tp_size=3)
    port, ref = MeshRules(**kw), JMeshRules(**kw)
    for rules in ((port, ref), (port.serving(), ref.serving())):
        got = [rules[0].tp(d) for d in (6, 7, 0)] + \
              [rules[0].fsdp(d) for d in (6, 7)] + \
              [rules[0].shard_params_fsdp]
        want = [rules[1].tp(d) for d in (6, 7, 0)] + \
               [rules[1].fsdp(d) for d in (6, 7)] + \
               [rules[1].shard_params_fsdp]
        assert got == want
    assert port.tp(6) == "model" and port.tp(7) is None
    assert port.serving().fsdp(6) is None
    assert dataclasses.asdict(MeshRules.single_device()) == \
        dataclasses.asdict(JMeshRules.single_device())


@pytest.mark.parametrize("change,tp,want", [
    ({}, 2, (True, True)), ({}, 4, (False, True)), ({}, 1, (False, False)),
    ({"act": "gelu"}, 2, (True, False)), ({"d_ff": 250}, 4, (False, False)),
    ({"n_kv_heads": 4}, 4, (True, True))],
    ids=["tp2", "tp4_kv2", "tp1", "gelu", "dff250", "tp4_kv4"])
def test_tp_plan_static_degradation(change, tp, want):
    """Reduced smollm (4 q / 2 kv heads, silu): TP 2 shards both parts,
    TP 4 only the MLP, GELU and an indivisible d_ff replicate the MLP —
    each plan equal to the reference's."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **change)
    jcfg = dataclasses.replace(jget("smollm-135m").reduced(), **change)
    plan = tp_plan(cfg, tp)
    assert plan == jtp_plan(jcfg, tp)
    assert (plan["shard_heads"], plan["shard_mlp"]) == want


def test_make_host_mesh_raises_descriptive_not_assert():
    """A process that is no rank of a 4-rank group gets a RuntimeError
    that says how to start the ranks, as the reference's names the XLA
    flag that forces host devices."""
    with pytest.raises(RuntimeError, match=r"needs 4 ranks.*run_ranks"):
        make_host_mesh(1, 4, device="cpu")
    with pytest.raises(RuntimeError,
                       match="xla_force_host_platform_device_count=4"):
        jmake_host_mesh(1, 4)


def test_compile_cache_keys_a_mesh_by_shape_and_names():
    """``StaticLayer(mesh=...)`` keeps the mesh; the compile cache keys it
    by its dims' names and sizes, as the reference's does — the same key
    for the same shape, whatever else the mesh object holds."""
    from types import SimpleNamespace
    from repro.core.static_layer import CompileCache as JCompileCache
    from repro_torch.core.static_layer import CompileCache, StaticLayer
    port_mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                                shape=(1, 2), rank_state=object())
    jax_mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                               axis_names=("data", "model"))
    key = CompileCache.make_key("svc:mmu:x", {"n": 1}, port_mesh)
    assert key == JCompileCache.make_key("svc:mmu:x", {"n": 1}, jax_mesh)
    port_mesh.rank_state = object()
    assert CompileCache.make_key("svc:mmu:x", {"n": 1}, port_mesh) == key
    assert key != CompileCache.make_key("svc:mmu:x", {"n": 1}, None)
    assert StaticLayer(port_mesh, device="cpu").mesh is port_mesh


# ================================================ multi-rank (gloo) ======
def test_tp2_token_parity_under_churn():
    """TP 2: every rank's streams equal the port's single-process engine's
    (greedy, sampled, top-k and top-p rows, 5 requests through 2 slots)
    and each other's; the greedy rows equal the JAX engine's.  Both parts
    shard; each rank holds ``n_kv_heads // 2`` heads of every page."""
    jcfg, jparams, w = _weights({})
    eng_kw = dict(max_batch=2, max_len=96, seed=0)
    mmu_kw = dict(page_size=16, n_pages=128)
    want = _single({}, w, CHURN, eng_kw, mmu_kw)
    outs = run_ranks(ranks.serve, 2, w, {}, CHURN, eng_kw, mmu_kw,
                     device="cpu")
    for out in outs:
        assert out["completed"] == len(CHURN)
        assert out["tokens"] == want, (out["tokens"], want)
        assert out["agree"]
        assert out["plan"] == {"shard_heads": True, "shard_mlp": True}
        assert out["pool_shape"][2] == jcfg.n_kv_heads // 2
        assert out["local_wq"][-1] == (jcfg.n_heads // 2
                                       * jcfg.resolved_head_dim)  # 2 of 4
        assert out["local_w_up"][-1] == jcfg.d_ff // 2
        # two reduction sites a layer, one fp32 (B, 1, d_model) each
        assert out["allreduce_bytes"] == 2 * jcfg.n_layers * 2 * \
            jcfg.d_model * 4
    # the EWMAs are model-rank 0's on every rank; a plain admission hook
    # runs on every rank (a gateway's: tests/test_torch_gateway_tp.py)
    assert outs[0]["ewma"] == outs[1]["ewma"]
    assert all(out["hook_ran"] for out in outs)
    jgreedy = _jax_greedy(jcfg, jparams, CHURN, eng_kw, mmu_kw)
    assert jgreedy and {r: want[r] for r in jgreedy} == jgreedy


def test_tp2_evict_with_copy_is_byte_exact():
    """Evict-with-copy on the head-split pools: the host copy of each
    evicted page holds every head and equals the page before eviction;
    the faulted-back page equals it, each rank's own heads in its pool."""
    _, _, w = _weights({})
    for out in run_ranks(ranks.evict_with_copy, 2, w, {}, device="cpu"):
        assert out["evicted"] > 0
        assert out["stored_equal"] and out["back_equal"]
        assert out["local_equal"] and out["local_heads"] == 1


@pytest.mark.parametrize("kv_heads,shard_heads", [(4, True), (2, False)],
                         ids=["kv4_heads_shard", "kv2_heads_replicate"])
def test_tp4_token_parity_and_heads_degradation(kv_heads, shard_heads):
    """TP 4: with 4 kv heads the whole stack shards; with the stock 2,
    attention replicates while the MLP still shards — parity with the
    single-process engine in both regimes (which the TP 2 case ties to
    the JAX engine's greedy rows)."""
    change = {"n_kv_heads": kv_heads}
    _, _, w = _weights(change)
    eng_kw = dict(max_batch=3, max_len=64, seed=0)
    mmu_kw = dict(page_size=16, n_pages=128)
    want = _single(change, w, TP4, eng_kw, mmu_kw)
    for out in run_ranks(ranks.serve, 4, w, change, TP4, eng_kw, mmu_kw,
                           device="cpu"):
        assert out["tokens"] == want
        assert out["agree"]
        assert out["plan"] == {"shard_heads": shard_heads,
                               "shard_mlp": True}
        assert out["pool_shape"][2] == (kv_heads // 4 if shard_heads
                                        else kv_heads)


def test_tp_prefill_paged_matches_the_single_process_prefill():
    """``TPContext.prefill_paged`` (the shared-prefix prefill with zero
    coverage, both reduction hooks on at TP 2) samples the first tokens
    the single-process ``prefill_paged`` samples, greedy and sampled, and
    writes this rank's heads of the same KV."""
    _, _, w = _weights({})
    prompts = [list(range(3, 20)), list(range(5, 11)), [9, 4, 7]]
    for out in run_ranks(ranks.prefill_paged_twin, 2, w, prompts,
                         device="cpu"):
        assert out["got"] == out["want"]
        assert out["local_heads"] == 1
        assert out["kv_err"] <= 1e-5


def test_sharded_tenant_migrates_and_recovers():
    """A TP 2 tenant live-migrates to a single-device shell token for
    token, by stop-and-copy and by pre-copy (the wire format and the
    warm rounds carry every head), and a TP 2 slot recovers in place, KV
    intact, each equal to an unmoved single-device oracle."""
    _, _, w = _weights({})
    for out in run_ranks(ranks.migrate_and_recover, 2, w, MIGRATE,
                           device="cpu"):
        m, r = out["migrate"], out["recover"]
        assert m["n_requests"] == 3 and m["src_pages_used"] == 0
        assert m["got"] == m["want"] and len(m["got"]) == 3
        c = out["precopy"]
        assert c["n_requests"] == 3 and c["src_pages_used"] == 0
        assert c["rounds"] == 2 and c["precopy_pages"] > 0
        assert c["got"] == c["want"] and len(c["got"]) == 3
        assert r["n_requests"] == 3 and r["n_pages"] > 0
        assert r["got"] == r["want"] and len(r["got"]) == 3
        assert r["local_heads"] == 1
        assert out["agree"]
