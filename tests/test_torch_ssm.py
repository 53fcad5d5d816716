"""Port Mamba-2 model path against the JAX reference, on the CPU.

Reduced mamba2-1.3b (2 layers, d_model 128, 8 SSD heads of head_dim 32,
d_state 16, chunk 32, vocab 512), float32, with the weights of the
reference's ``init_params`` bridged through ``from_reference``: the
parameter tree and its float32 leaves, ``causal_conv`` with and without
carried state, ``mamba_apply`` and ``mamba_decode`` with their caches,
``transformer.forward``, and the serving path: ``prefill`` then 8
teacher-forced ``decode_step``s against the reference's, and decode after
prefill against ``forward`` on the longer sequence (the twin of
``tests/test_archs_smoke.py::test_decode_matches_forward``).

Tolerances, float32: block outputs, hidden states and caches atol 1e-5
where one block or the whole forward runs once (the two frameworks sum
the projections and the chunked scan's einsums in other orders, ~1e-6 on
O(1) values); the serving path's logits and caches atol 1e-4 over 8
steps, as the paged engine's twins (logits are O(1) sums over the 128
model dimensions, and each step feeds the last one's state); greedy tokens
identical.  Decode after prefill against ``forward`` is atol 1e-4: the
recurrence and the chunked scan are the same function summed in other
orders.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import ssm, transformer as T
from repro_torch.models.params import from_reference

import _torch_mesh_train_ranks as ranks

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
FLOAT32_LEAVES = ("dt_bias", "A_log", "D")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jget(ARCH).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    ref = _np(jparams)
    return jcfg, get_config(ARCH).reduced(), jparams, ref, \
        from_reference(ref, device="cpu")


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dtypes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: str(tree.dtype).replace("torch.", "")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_init_matches_reference_tree_and_float32_leaves(dtype):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    ref = jax.eval_shape(lambda: jssm.mamba_init(
        jax.random.PRNGKey(0), jcfg, dtype=getattr(jnp, dtype)))
    got = ssm.mamba_init(torch.Generator().manual_seed(0), cfg,
                         dtype=getattr(torch, dtype))
    assert _shapes(got) == _shapes(ref)
    assert _dtypes(got) == {k: str(v) for k, v in _dtypes(ref).items()}
    for k in FLOAT32_LEAVES:
        assert got[k].dtype == torch.float32
    # init values follow the reference where they are not random (to the
    # last bit of float32 log, which differs between the two libraries)
    want = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-6)
    sp = torch.nn.functional.softplus(got["dt_bias"])
    assert float(sp.min()) >= 1e-3 - 1e-7 and float(sp.max()) <= 0.1 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_tree(dtype):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    ref = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), jcfg, dtype=getattr(jnp, dtype)))
    got = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        dtype=getattr(torch, dtype), device="cpu")
    assert _shapes(got) == _shapes(ref)
    assert _dtypes(got) == {k: str(v) for k, v in _dtypes(ref).items()}


def test_from_reference_keeps_ssm_leaves_float32_and_exact(model):
    """A bf16 bridge rounds the weights but not dt_bias, A_log or D."""
    ref = copy.deepcopy(model[3])
    # values that bf16 cannot hold, so a rounded leaf would differ
    rs = np.random.RandomState(1)
    for k in FLOAT32_LEAVES:
        ref["layers"]["mamba"][k] = (ref["layers"]["mamba"][k] + rs.rand(
            *ref["layers"]["mamba"][k].shape) * 1e-3).astype(np.float32)
    bf = from_reference(ref, dtype=torch.bfloat16, device="cpu")
    for k in FLOAT32_LEAVES:
        leaf = bf["layers"]["mamba"][k]
        assert leaf.dtype == torch.float32, k
        np.testing.assert_array_equal(leaf.numpy(), ref["layers"]["mamba"][k])
    assert bf["layers"]["mamba"]["wx"].dtype == torch.bfloat16
    assert bf["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 12).astype(np.float32)
    w = rs.randn(4, 12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    state = rs.randn(2, 3, 12).astype(np.float32) if with_state else None
    y, new = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), state=None if state is None
                             else torch.from_numpy(state))
    jy, jnew = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), state=None if state is None
                                else jnp.asarray(state))
    _close(y, jy, 1e-6)
    _close(new, jnew, 0)


@pytest.mark.parametrize("with_init", [False, True])
def test_mamba_apply_matches_reference(model, with_init):
    jcfg, cfg, jparams, ref, port = model
    rs = np.random.RandomState(3)
    u = rs.randn(2, 45, cfg.d_model).astype(np.float32)   # ragged: 45 % 32
    init = None
    if with_init:
        c = ssm.mamba_cache_init(cfg, 2, dtype=torch.float32, device="cpu")
        init = {k: rs.randn(*v.shape).astype(np.float32) * 0.5
                for k, v in c.items()}
    out, cache = ssm.mamba_apply(
        _layer(port["layers"]["mamba"], 0), cfg, torch.from_numpy(u),
        init=None if init is None else
        {k: torch.from_numpy(v) for k, v in init.items()})
    jout, jcache = jssm.mamba_apply(
        _layer(jparams["layers"]["mamba"], 0), jcfg, jnp.asarray(u),
        init=None if init is None else
        {k: jnp.asarray(v) for k, v in init.items()})
    _close(out, jout, 1e-5)
    for k in ("conv", "ssm"):
        _close(cache[k], jcache[k], 1e-5)
    assert cache["ssm"].dtype == torch.float32


def test_mamba_decode_matches_reference(model):
    jcfg, cfg, jparams, ref, port = model
    rs = np.random.RandomState(4)
    u = rs.randn(3, 1, cfg.d_model).astype(np.float32)
    c = ssm.mamba_cache_init(cfg, 3, dtype=torch.float32, device="cpu")
    cache = {k: rs.randn(*v.shape).astype(np.float32) * 0.5
             for k, v in c.items()}
    out, new = ssm.mamba_decode(
        _layer(port["layers"]["mamba"], 1), cfg, torch.from_numpy(u),
        {k: torch.from_numpy(v) for k, v in cache.items()})
    jout, jnew = jssm.mamba_decode(
        _layer(jparams["layers"]["mamba"], 1), jcfg, jnp.asarray(u),
        {k: jnp.asarray(v) for k, v in cache.items()})
    _close(out, jout, 1e-5)
    for k in ("conv", "ssm"):
        _close(new[k], jnew[k], 1e-5)


def test_forward_matches_reference(model):
    jcfg, cfg, jparams, ref, port = model
    toks = _tokens(cfg, 2, 70, 5)
    hidden, aux, kv, (_, _, ms) = T.forward(port, cfg, torch.from_numpy(toks),
                                            collect_kv=True)
    jh, jaux, jkv, (_, _, jms) = JT.forward(jparams, jcfg, jnp.asarray(toks),
                                            collect_kv=True)
    assert kv is None and jkv is None
    _close(hidden, jh, 1e-5)
    for k in ("conv", "ssm"):
        _close(ms[k], jms[k], 1e-5)


def test_prefill_and_teacher_forced_decode_match_reference(model):
    jcfg, cfg, jparams, ref, port = model
    b, s, steps = 3, 37, 8
    toks = _tokens(cfg, b, s + steps, 6)
    logits, cache = T.prefill(port, cfg, torch.from_numpy(toks[:, :s]),
                              s + steps, cache_dtype=torch.float32)
    jlogits, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :s]),
                                 s + steps, cache_dtype=jnp.float32)
    for t in range(steps + 1):
        assert logits.shape == (b, cfg.padded_vocab)
        _close(logits, jlogits, 1e-4)
        np.testing.assert_array_equal(
            logits[:, :cfg.vocab_size].argmax(-1).numpy(),
            np.asarray(jnp.argmax(jlogits[:, :cfg.vocab_size], -1)))
        for k in ("conv", "ssm"):
            _close(cache["mamba"][k], jcache["mamba"][k], 1e-4)
        if t == steps:
            break
        nxt = toks[:, s + t:s + t + 1]           # teacher forcing
        pos = np.full((b,), s + t, np.int32)
        logits, cache = T.decode_step(port, cfg, cache, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        jlogits, jcache = JT.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(nxt), jnp.asarray(pos))


def test_decode_after_prefill_matches_forward(model):
    cfg, port = model[1], model[4]
    toks = torch.from_numpy(_tokens(cfg, 1, 40, 7))
    hidden, _, _, _ = T.forward(port, cfg, toks)
    full = T.lm_logits(port, cfg, hidden)
    prefix = 33
    logits, cache = T.prefill(port, cfg, toks[:, :prefix], 40,
                              cache_dtype=torch.float32)
    _close(logits, full[:, prefix - 1], 1e-4)
    for t in range(prefix, 40):
        logits, cache = T.decode_step(port, cfg, cache, toks[:, t:t + 1],
                                      torch.full((1,), t))
        _close(logits, full[:, t], 1e-4)


def test_init_cache_matches_prefill_layout(model):
    cfg = model[1]
    c = T.init_cache(cfg, 2, 64, dtype=torch.bfloat16, device="cpu")
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    assert c["mamba"]["conv"].shape == (cfg.n_layers, 2, s.d_conv - 1,
                                        di + 2 * gn)
    assert c["mamba"]["conv"].dtype == torch.bfloat16
    assert c["mamba"]["ssm"].shape == (cfg.n_layers, 2,
                                       s.n_heads(cfg.d_model), s.head_dim,
                                       s.d_state)
    assert c["mamba"]["ssm"].dtype == torch.float32
    assert T.decode_cache_len(cfg, 100) == 100


def test_dense_attention_cache_waits_for_its_slice():
    """The dense attention cache has landed (ROADMAP item 9; its twins
    are in ``tests/test_torch_serving.py``): ``init_cache`` lays out
    per-layer KV beside the mamba states.  ``decode_step(cp_mesh=...)``
    has landed too (item 21): a mamba model's cache has no sequence to
    shard, so on two gloo ranks it decodes exactly as without the mesh,
    as the reference's mamba decode ignores ``cp_mesh``."""
    cfg = get_config("smollm-135m").reduced()
    c = T.init_cache(cfg, 1, 8, device="cpu")
    assert set(c) == {"k", "v"} and c["k"].shape[:3] == (cfg.n_layers, 1, 8)
    for o in run_ranks(ranks.cp_decode, 2, "mamba2-1.3b", device="cpu",
                       backend="gloo", timeout_s=60.0, deadline_s=120.0):
        assert o["err"] == 0.0 and o["cache_err"] == 0.0
