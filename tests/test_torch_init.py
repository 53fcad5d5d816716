"""The reference's public init functions in the port, and the seeded
``init_params`` draw they feed.

``layers.dense_init``, ``bias_init``, ``rmsnorm_init``,
``layernorm_init``, ``embed_init``, ``mlp.mlp_init`` and
``attention.attn_init`` take a ``torch.Generator`` where the reference
takes a JAX key.  The draws cannot be held equal (the port does not
reproduce threefry), so the twins compare key trees, shapes and dtypes
exactly, zeros and ones exactly, and each random leaf's mean and standard
deviation within six standard errors of the reference's (the difference
of two independent estimates over n elements has a standard error of
about s / sqrt(n) for both).

The pin holds a seeded ``init_params`` to the draw of the private helpers
these functions replaced, rebuilt below from their arithmetic: every leaf
bit-identical, except mamba's six projections, which the old helper
divided by sqrt(fan_in) where ``dense_init`` multiplies by its inverse
(one float32 ulp apart at most).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mlp as JM
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, mlp, transformer

torch.set_num_threads(1)

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _same_law(got, ref):
    """``got`` (torch) and ``ref`` (JAX): equal shape and dtype; a
    constant leaf equal, a random one with mean and std within six
    standard errors."""
    assert tuple(got.shape) == tuple(ref.shape)
    assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
    t = got.float().numpy().ravel()
    j = np.asarray(ref, np.float32).ravel()
    if np.all(j == j[0]):
        np.testing.assert_array_equal(t, j)
        return
    s, n = float(j.std()), j.size
    assert abs(float(t.mean()) - float(j.mean())) <= 6 * s / math.sqrt(n)
    assert abs(float(t.std()) - s) <= 6 * s / math.sqrt(n)


def _twin(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert list(g) == list(r)
    for k in g:
        _same_law(g[k], r[k])


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("scale", [None, 0.5], ids=["fan_in", "scale"])
@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_dense_init_matches_reference(dt, scale):
    got = layers.dense_init(_gen(), 192, 320, dtype=dt[0], scale=scale)
    ref = JL.dense_init(jax.random.PRNGKey(0), 192, 320, dtype=dt[1],
                        scale=scale)
    _same_law(got, ref)
    want = scale if scale is not None else 192 ** -0.5
    assert abs(float(got.float().std()) - want) < 0.02 * want


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_bias_norm_and_embed_inits_match_reference(dt):
    td, jd = dt
    _twin({"b": layers.bias_init(96, dtype=td)},
          {"b": JL.bias_init(96, dtype=jd)})
    _twin(layers.rmsnorm_init(96, dtype=td), JL.rmsnorm_init(96, dtype=jd))
    _twin(layers.layernorm_init(96, dtype=td),
          JL.layernorm_init(96, dtype=jd))
    emb = layers.embed_init(_gen(), 512, 96, dtype=td)
    _twin(emb, JL.embed_init(jax.random.PRNGKey(0), 512, 96, dtype=jd))
    assert abs(float(emb["table"].float().std()) - 0.02) < 0.001


def test_inits_draw_on_the_generators_device():
    assert layers.dense_init(_gen(), 4, 8).device.type == "cpu"
    assert layers.bias_init(4, device="meta").device.type == "meta"
    assert layers.rmsnorm_init(4, device="meta")["scale"].is_meta
    assert all(v.is_meta for v in
               layers.layernorm_init(4, device="meta").values())


@pytest.mark.parametrize("d_ff", [0, 96], ids=["cfg_d_ff", "d_ff"])
@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium"],
                         ids=["swiglu", "gelu"])
@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_mlp_init_matches_reference(arch, d_ff, dt):
    got = mlp.mlp_init(_gen(), get_config(arch).reduced(), d_ff=d_ff,
                       dtype=dt[0])
    ref = JM.mlp_init(jax.random.PRNGKey(0), jget(arch).reduced(),
                      d_ff=d_ff, dtype=dt[1])
    _twin(got, ref)
    assert ("w_gate" in got) == (arch == "smollm-135m")


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_attn_init_matches_reference(qkv_bias, dt):
    cfg = dataclasses.replace(get_config("qwen2-72b").reduced(),
                              qkv_bias=qkv_bias)
    jcfg = dataclasses.replace(jget("qwen2-72b").reduced(),
                               qkv_bias=qkv_bias)
    got = attention.attn_init(_gen(), cfg, dtype=dt[0])
    _twin(got, JA.attn_init(jax.random.PRNGKey(0), jcfg, dtype=dt[1]))
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    want = (h * hd) ** -0.5            # wo's scale
    assert abs(float(got["wo"].float().std()) - want) < 0.05 * want
    assert ({"bq", "bk", "bv"} <= set(got)) == qkv_bias


# --------------------------------------------------------------- the pin --
def _old_draw(cfg, gen):
    """``init_params(dtype=float32)`` on the CPU as the private helpers
    drew it: ``transformer._normal``/``_dense``/``_norm``/``_attn``,
    ``moe_init``'s ``normal``/``ew`` and ``mamba_init``'s ``dense``, call
    for call."""
    d = cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    def dense(i, o, scale=None):
        return normal((i, o), scale if scale is not None
                      else 1.0 / math.sqrt(i))

    def norm():
        p = {"scale": torch.ones(d)}
        if cfg.act == "gelu":
            p["bias"] = torch.zeros(d)
        return p

    def attn():
        h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        a = {"wq": dense(d, h * hd), "wk": dense(d, k * hd),
             "wv": dense(d, k * hd),
             "wo": dense(h * hd, d, scale=1.0 / (h * hd) ** 0.5)}
        if cfg.qkv_bias:
            a.update(bq=torch.zeros(h * hd), bk=torch.zeros(k * hd),
                     bv=torch.zeros(k * hd))
        return a

    def moe_ffn():
        e, f = cfg.moe, cfg.moe.d_ff_expert

        def ew(a, b):
            return normal((e.n_experts, a, b), 1.0 / math.sqrt(a))

        p = {"router": normal((d, e.n_experts), 1.0 / math.sqrt(d)),
             "w_gate": ew(d, f), "w_up": ew(d, f), "w_down": ew(f, d)}
        if e.n_shared_experts:
            fs = e.n_shared_experts * f
            p["shared"] = {"w_gate": normal((d, fs), 1.0 / math.sqrt(d)),
                           "w_up": normal((d, fs), 1.0 / math.sqrt(d)),
                           "w_down": normal((fs, d), 1.0 / math.sqrt(fs))}
        return p

    def attn_layer(cross=False):
        a, f = attn(), cfg.d_ff
        if cfg.moe is not None:
            ffn = moe_ffn()
        elif cfg.act == "silu":
            ffn = {"w_gate": dense(d, f), "w_up": dense(d, f),
                   "w_down": dense(f, d)}
        else:
            ffn = {"w_up": dense(d, f), "b_up": torch.zeros(f),
                   "w_down": dense(f, d), "b_down": torch.zeros(d)}
        p = {"norm1": norm(), "attn": a, "norm2": norm(), "ffn": ffn}
        if cross:
            p.update(norm_x=norm(), xattn=attn())
        return p

    def mamba_layer():
        s = cfg.ssm
        di, nh = s.d_inner(d), s.n_heads(d)
        gn = s.n_groups * s.d_state

        def mdense(i, o):
            return torch.randn(i, o, generator=gen) / math.sqrt(i)

        u = torch.rand(nh, generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        m = {"wz": mdense(d, di), "wx": mdense(d, di), "wB": mdense(d, gn),
             "wC": mdense(d, gn), "wdt": mdense(d, nh),
             "conv_w": torch.randn(s.d_conv, di + 2 * gn, generator=gen)
             / math.sqrt(s.d_conv),
             "conv_b": torch.zeros(di + 2 * gn),
             "dt_bias": dt + torch.log(-torch.expm1(-dt)),
             "A_log": torch.log(torch.arange(1, nh + 1,
                                             dtype=torch.float32)),
             "D": torch.ones(nh), "norm": {"scale": torch.ones(di)},
             "wo": mdense(di, d)}
        return {"norm": norm(), "mamba": m}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    p = {"embed": {"table": normal((cfg.padded_vocab, d), 0.02)},
         "final_norm": norm()}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(d, cfg.padded_vocab)
    if len(cfg.block_pattern) != 1:
        nc = cfg.n_layers // len(cfg.block_pattern)
        slots = []
        for kind in cfg.block_pattern:
            if kind == "shared_attn":
                p["shared_attn"] = attn_layer()
            else:
                slots.append(stack([mamba_layer() for _ in range(nc)]))
        p["slots"] = tuple(slots)
        return p
    if cfg.block_pattern[0] == "mamba":
        p["layers"] = stack([mamba_layer() for _ in range(cfg.n_layers)])
    else:
        cross = cfg.n_encoder_layers > 0
        p["layers"] = stack([attn_layer(cross)
                             for _ in range(cfg.n_layers)])
    if cfg.n_encoder_layers:
        p["encoder"] = {
            "layers": stack([attn_layer()
                             for _ in range(cfg.n_encoder_layers)]),
            "final_norm": {"scale": torch.ones(d), "bias": torch.zeros(d)}}
    return p


MAMBA_PROJ = ("wz", "wx", "wB", "wC", "wdt", "wo")


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-72b",
                                  "granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e", "whisper-medium",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_seeded_init_params_keeps_the_old_draw(arch):
    cfg = get_config(arch).reduced()
    got = _leaves(transformer.init_params(
        cfg, generator=_gen(11), dtype=torch.float32, device="cpu"))
    old = _leaves(_old_draw(cfg, _gen(11)))
    assert list(got) == list(old)
    moved = 0
    for path, g in got.items():
        o = old[path]
        assert g.dtype == o.dtype == torch.float32 and g.shape == o.shape
        if "/mamba/" in path and path.rsplit("/", 1)[1] in MAMBA_PROJ:
            ulps = (g.view(torch.int32) - o.view(torch.int32)).abs()
            assert int(ulps.max()) <= 1, path
            assert torch.equal(g.sign(), o.sign()), path
            moved += int((ulps > 0).sum())
        else:
            assert torch.equal(g, o), path
    assert (moved > 0) == (cfg.ssm is not None)
