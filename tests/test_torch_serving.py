"""The port's dense attention cache against the reference's (twin of
``tests/test_serving.py``): ``init_cache``, ``prefill`` and
``decode_step`` of ``models/transformer.py`` on reduced smollm-135m and
on reduced h2o-danube-3-4b (sliding window 64, so a prompt over 64 tokens
takes the ring fill and decode wraps the ring), fp32, on the same
``from_reference`` weights.  Tolerances: logits and caches atol 1e-4 (the
serving twins' tolerance); greedy tokens identical.  The paged engine's
greedy streams equal the dense path's, in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.models import transformer as T
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import ServingEngine

import _torch_mesh_train_ranks as ranks

torch.set_num_threads(1)
ATOL = 1e-4


def _model(arch, seed=0):
    jcfg = jget(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg,
                             dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(arch).reduced(), params


@pytest.fixture(scope="module")
def smollm():
    return _model("smollm-135m")


def _dense_greedy(cfg, params, prompt, n_new, *, port):
    """Greedy tokens from prefill + decode_step, as the reference test's
    ``_dense_greedy`` (max_len 128, fp32 cache)."""
    if port:
        toks = torch.tensor([prompt])
        logits, cache = T.prefill(params, cfg, toks, 128,
                                  cache_dtype=torch.float32)
    else:
        toks = jnp.asarray(prompt, jnp.int32)[None]
        logits, cache = JT.prefill(params, cfg, toks, max_len=128,
                                   cache_dtype=jnp.float32)
    seq = [int(np.argmax(np.asarray(logits[0, :cfg.vocab_size])))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        if port:
            logits, cache = T.decode_step(params, cfg, cache,
                                          torch.tensor([[seq[-1]]]),
                                          torch.tensor([pos]))
        else:
            logits, cache = JT.decode_step(
                params, cfg, cache, jnp.asarray([[seq[-1]]], jnp.int32),
                jnp.asarray([pos], jnp.int32))
        seq.append(int(np.argmax(np.asarray(logits[0, :cfg.vocab_size]))))
        pos += 1
    return seq


def test_paged_engine_matches_dense_greedy(smollm):
    jcfg, jparams, cfg, params = smollm
    eng = ServingEngine(cfg, params, MMU(MMUConfig(page_size=16,
                                                   n_pages=128)),
                        max_batch=3, max_len=128, device="cpu")
    prompts = [list(range(3, 3 + n)) for n in (5, 17, 9, 12)]
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    stats = eng.run()
    assert stats["completed"] == 4
    for req in eng.completed:
        n = len(req.out_tokens)
        dense = _dense_greedy(cfg, params, req.prompt, n, port=True)
        assert dense == req.out_tokens, f"rid {req.rid} diverged"
        assert dense == _dense_greedy(jcfg, jparams, req.prompt, n,
                                      port=False)


def _teacher_forced(jcfg, jparams, cfg, params, toks, s, max_len, **kw):
    """Logits and caches of prefill(toks[:, :s]) then one decode step per
    later token, in both packages."""
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :s]), max_len,
                        cache_dtype=jnp.float32)
    pl, pc = T.prefill(params, cfg, torch.as_tensor(toks[:, :s]), max_len,
                       cache_dtype=torch.float32)
    out = [(np.asarray(jl), pl.numpy())]
    b = toks.shape[0]
    for t in range(s, toks.shape[1]):
        jl, jc = JT.decode_step(jparams, jcfg, jc,
                                jnp.asarray(toks[:, t:t + 1]),
                                jnp.full((b,), t, jnp.int32), **kw)
        pl, pc = T.decode_step(params, cfg, pc,
                               torch.as_tensor(toks[:, t:t + 1]),
                               torch.full((b,), t), **kw)
        out.append((np.asarray(jl), pl.numpy()))
    return out, (jc, pc)


@pytest.mark.parametrize("arch,s,total,max_len", [
    ("smollm-135m", 21, 29, 40),
    ("h2o-danube-3-4b", 40, 50, 128),      # window 64: prefill fits
    ("h2o-danube-3-4b", 90, 100, 128),     # ring fill, decode wraps
], ids=["dense", "window-fits", "ring"])
def test_dense_decode_matches_reference_under_teacher_forcing(arch, s, total,
                                                              max_len):
    jcfg, jparams, cfg, params = _model(arch, seed=1)
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(2, total)).astype(np.int32)
    steps, (jc, pc) = _teacher_forced(jcfg, jparams, cfg, params, toks, s,
                                      max_len)
    for i, (want, got) in enumerate(steps):
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(got[:, :cfg.vocab_size].argmax(-1),
                                      want[:, :cfg.vocab_size].argmax(-1))
    assert pc["k"].shape == jc["k"].shape
    for side in ("k", "v"):
        np.testing.assert_allclose(pc[side].numpy(), np.asarray(jc[side]),
                                   atol=ATOL)


def test_ring_decode_equals_longer_prefill():
    """Decode after a prefill longer than the window gives the last
    logits of the prefill one token longer: the ring fill places the
    last ``window`` keys where ``cache_update_ring`` expects them."""
    _, _, cfg, params = _model("h2o-danube-3-4b", seed=2)
    assert cfg.swa_window == 64
    toks = torch.as_tensor(np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(2, 151)))
    for s in (64, 100, 150):
        _, cache = T.prefill(params, cfg, toks[:, :s], s + 1,
                             cache_dtype=torch.float32)
        assert cache["k"].shape[2] == 64
        got, _ = T.decode_step(params, cfg, cache, toks[:, s:s + 1],
                               torch.full((2,), s))
        want, _ = T.prefill(params, cfg, toks[:, :s + 1], s + 1,
                            cache_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_uniform_pos_equals_per_row_and_reference(smollm):
    jcfg, jparams, cfg, params = smollm
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    steps, _ = _teacher_forced(jcfg, jparams, cfg, params, toks, 16, 24,
                               uniform_pos=True)
    per_row, _ = _teacher_forced(jcfg, jparams, cfg, params, toks, 16, 24)
    for (want, got), (_, row) in zip(steps, per_row):
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_array_equal(got, row)


def test_dense_cache_layout_and_refusals(smollm):
    cfg, params = smollm[2], smollm[3]
    c = T.init_cache(cfg, 2, 40, dtype=torch.bfloat16, device="cpu")
    assert c["k"].shape == (cfg.n_layers, 2, 40, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
    assert c["v"].dtype == torch.bfloat16
    ring = get_config("h2o-danube-3-4b").reduced()
    assert T.init_cache(ring, 1, 500, device="cpu")["k"].shape[2] == 64
    # cp_mesh (context-parallel decode over a sequence-sharded cache) is
    # ported: two gloo ranks, each with its half of the positions, give
    # the dense decode's logits, and each keeps its half of the cache
    for o in run_ranks(ranks.cp_decode, 2, "smollm-135m", device="cpu",
                       backend="gloo", timeout_s=60.0, deadline_s=120.0):
        assert o["err"] <= 1e-4 and o["cache_err"] <= 1e-5
