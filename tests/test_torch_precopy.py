"""Pre-copy migration on the port (twin of ``tests/test_precopy.py``'s
engine parts), reduced smollm-135m fp32 with ``from_reference`` weights:
the dirty-delta soundness pin, the container's chunked stream with bf16
payloads as tagged bits, pre-copy token parity (greedy rows equal to the
JAX package's unmoved engine, every row equal to the port's unmoved
engine), warm-round fault containment, and the cross-seed matrix of
in-place recovery followed by pre-copy.
"""
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
from repro_torch.core import (FaultKind, FaultPlan, FaultSpec,
                              MigrationError, Shell, ShellConfig)
from repro_torch.core import bitstream as B
from repro_torch.core.migrate import migrate_precopy
from repro_torch.core.host_codec import weights_from_host, weights_to_host
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


def _shell():
    s = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=POOL)},
        n_vfpgas=2), device="cpu")
    s.build()
    return s


def _engine(cfg, params, shell, *, rid_base=0, seed=0):
    return ServingEngine(cfg, params, shell.services.get("mmu"),
                         max_batch=3, max_len=128, shell=shell, slot=0,
                         tenant="gold", rid_base=rid_base, seed=seed,
                         device="cpu")


def _oracle(cfg, params, seed=0):
    return ServingEngine(cfg, params, MMU(MMUConfig(page_size=PAGE,
                                                    n_pages=POOL)),
                         max_batch=3, max_len=128, seed=seed, device="cpu")


def _drain(*engines):
    for eng in engines:
        while eng.pending():
            eng.step()


def _streams(eng):
    return {r.rid: r.out_tokens for r in eng.completed}


def test_dirty_clean_pages_skippable_is_sound(served):
    """Pages NOT in the dirty set after ``clear_dirty`` are byte-identical
    to their state at clear time: shipping only the dirty delta loses
    nothing."""
    cfg, params = served[2:]
    shell = _shell()
    eng = _engine(cfg, params, shell)
    for n in (18, 40):
        eng.submit(list(range(3, 3 + n)), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    mmu = eng.mmu
    before = {k: eng._pager_gather(k[1]) for k in mmu.live_page_keys()
              if k[0] == "d"}
    mmu.clear_dirty()
    for _ in range(2):
        eng.step()
    dirty = mmu.dirty_snapshot()
    clean = [k for k in before if k not in dirty
             and k in mmu.live_page_keys()]
    assert clean and dirty
    for k in clean:
        after = eng._pager_gather(k[1])
        for side in ("k", "v"):
            assert torch.equal(before[k][side], after[side])
    shell.close()


def test_container_stream_carries_bf16_payloads_bit_exact():
    """Warm rounds ship page payloads through the chunked container
    stream: bf16 tensors as tagged int16 bits survive any chunking bit
    for bit and come back bf16."""
    gen = torch.Generator().manual_seed(0)
    pages = {f"d:{i}": {"k": torch.randn(2, 4, 2, 8, generator=gen)
                        .to(torch.bfloat16),
                        "v": torch.randn(2, 4, 2, 8, generator=gen)}
             for i in range(3)}
    arrays = {"pages": weights_to_host(pages)}
    blob = B.encode("migration", {"precopy_round": 0}, arrays)
    for chunk_bytes in (7, 1 << 20):
        chunks = list(B.encode_stream("migration", {"precopy_round": 0},
                                      arrays, chunk_bytes=chunk_bytes))
        assert b"".join(chunks) == blob
        _, _, got = B.decode_stream(chunks, expect_kind="migration")
        got = weights_from_host(got["pages"])
        for key, kv in pages.items():
            assert got[key]["k"].dtype == torch.bfloat16
            assert torch.equal(got[key]["k"], kv["k"])
            np.testing.assert_array_equal(got[key]["v"], kv["v"].numpy())


def test_precopy_mid_decode_token_parity(served):
    """Warm rounds ship pages while the source decodes, the freeze ships
    only the delta, and the destination continues token for token."""
    jcfg, jparams, cfg, params = served
    src, dst = _shell(), _shell()
    eng_src = _engine(cfg, params, src)
    eng_dst = _engine(cfg, params, dst, rid_base=1000)
    oracle = _oracle(cfg, params)
    joracle = JEngine(jcfg, jparams, JMMU(JMMUConfig(page_size=PAGE,
                                                     n_pages=POOL)),
                      max_batch=3, max_len=128)
    for prompt, temp in REQS:
        eng_src.submit(prompt, max_new_tokens=12, temperature=temp)
        oracle.submit(prompt, max_new_tokens=12, temperature=temp)
        joracle.submit(prompt, max_new_tokens=12, temperature=temp)
    for _ in range(4):
        eng_src.step()
        oracle.step()
    report = migrate_precopy(src, dst, "gold", max_rounds=4)
    assert report.precopy_rounds >= 1
    assert report.precopy_pages >= report.n_pages
    assert 0 < report.delta_pages <= report.n_pages
    _drain(eng_dst, oracle, joracle)
    got = _streams(eng_dst)
    assert got == _streams(oracle)
    jgreedy = {r.rid: r.out_tokens for r in joracle.completed
               if r.temperature == 0.0}
    assert {r: got[r] for r in jgreedy} == jgreedy
    assert src.services.get("mmu").utilization()["pages_used"] == 0
    assert eng_src.active == 0
    src.close()
    dst.close()


def test_precopy_warm_fault_releases_staging_source_serves(served):
    """A warm-round fault (second round, staging populated) aborts the
    move, releases every staged destination page, and leaves the source
    serving — it was never paused."""
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    eng_src = _engine(cfg, params, src)
    _engine(cfg, params, dst, rid_base=1000)
    oracle = _oracle(cfg, params)
    for prompt in (list(range(3, 20)), list(range(3, 40))):
        eng_src.submit(prompt, max_new_tokens=10)
        oracle.submit(prompt, max_new_tokens=10)
    for _ in range(2):
        eng_src.step()
        oracle.step()
    src.set_fault_plan(FaultPlan([FaultSpec(
        FaultKind.MIGRATION_FAIL, site="migrate.precopy", after=1)]))
    with pytest.raises(MigrationError, match="keeps serving"):
        migrate_precopy(src, dst, "gold", max_rounds=4)
    src.set_fault_plan(None)
    assert dst.services.get("mmu").utilization()["pages_used"] == 0
    assert not dst.services.get("mmu")._ref
    _drain(eng_src, oracle)
    assert _streams(eng_src) == _streams(oracle)
    src.close()
    dst.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cross_seed_recover_and_precopy_parity(served, seed):
    """In-place recovery followed by a pre-copy migration reproduces the
    unmoved engine's sampled streams for every seed, with zero lost or
    duplicated completions; the seed travels in the container."""
    cfg, params = served[2:]
    src, dst = _shell(), _shell()
    eng_src = _engine(cfg, params, src, seed=seed)
    # the destination's own seed differs: it adopts the source's
    eng_dst = _engine(cfg, params, dst, rid_base=1000, seed=seed + 100)
    oracle = _oracle(cfg, params, seed=seed)
    reqs = [(list(range(3, 10)), 0.0), (list(range(3, 24)), 0.9),
            (list(range(3, 15)), 1.3)]
    for prompt, temp in reqs:
        eng_src.submit(prompt, max_new_tokens=10, temperature=temp)
        oracle.submit(prompt, max_new_tokens=10, temperature=temp)
    for _ in range(2):
        eng_src.step()
        oracle.step()
    rep_r = src.recover_slot(0)
    assert rep_r.n_requests == 3
    for _ in range(2):
        eng_src.step()
        oracle.step()
    migrate_precopy(src, dst, "gold", max_rounds=3)
    assert eng_dst.seed == seed
    _drain(eng_dst, oracle)
    assert _streams(eng_dst) == _streams(oracle)
    assert len(eng_dst.completed) == 3
    assert src.services.get("mmu").utilization()["pages_used"] == 0
    src.close()
    dst.close()
