"""Port layer math against the JAX reference on the same inputs.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance: float32 atol 1e-5 — the two frameworks sum matrix products in
different orders, which moves float32 results of O(1) size by ~1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, mlp, transformer
from repro_torch.models.params import from_reference

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)

ATOL = 1e-5
ARCHS = ["smollm-135m", "qwen2-72b"]          # qwen2 carries qkv_bias
# uniform attention archs with dense FFNs: what init_params covers
DENSE = ["smollm-135m", "qwen2-72b", "h2o-danube-3-4b", "phi3-medium-14b",
         "chameleon-34b"]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = jget(request.param).reduced()
    ref = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg,
                                  dtype=jnp.float32))
    if cfg.qkv_bias:           # reference init zeroes biases: exercise them
        rs = np.random.RandomState(5)
        for b in ("bq", "bk", "bv"):
            ref["layers"]["attn"][b] = rs.randn(
                *ref["layers"]["attn"][b].shape).astype(np.float32)
    port = from_reference(ref, device="cpu")
    return cfg, get_config(request.param).reduced(), ref, port


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _port_layer0(port):
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return pick(port["layers"])


def _as_reference(port_cfg):
    """The port's config as a dict of the reference's fields alone, after
    checking that every field the port has beyond them (those of its own
    architectures, granite-4.0-h-small's) holds its default."""
    out = dataclasses.asdict(port_cfg)
    for obj, d in ((port_cfg, out), (port_cfg.moe, out.get("moe"))):
        if obj is None:
            continue
        cls = type(obj)
        ref_cls = getattr(jbase, cls.__name__)
        ref = {f.name for f in dataclasses.fields(ref_cls)}
        for f in dataclasses.fields(cls):
            if f.name not in ref:
                assert getattr(obj, f.name) == f.default, f.name
                del d[f.name]
    return out


def test_configs_are_copies():
    for arch in DENSE + ["granite-moe-1b-a400m", "whisper-medium"]:
        a, b = jget(arch), get_config(arch)
        assert dataclasses.asdict(a) == _as_reference(b)
        assert dataclasses.asdict(a.reduced()) == _as_reference(b.reduced())


def test_rmsnorm_and_layernorm():
    x = _x(2, 5, 128)
    scale = _x(128, seed=1)
    bias = _x(128, seed=2)
    _close(layers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {"scale": scale, "bias": bias}
    _close(layers.norm_apply({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x), 1e-6),
           JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), 1e-6))


def test_rope_is_split_half(model):
    cfg = model[0]
    x = _x(2, 7, 4, cfg.resolved_head_dim)
    pos = np.array([[0, 1, 2, 3, 50, 51, 52], [9, 8, 7, 6, 5, 4, 1000]])
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos),
                             cfg.rope_theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta))
    # split-half: dims d and d + D/2 rotate together, not 2i and 2i+1
    one = np.zeros((1, 1, 1, cfg.resolved_head_dim), np.float32)
    one[..., 0] = 1.0
    out = layers.apply_rope(torch.tensor(one), torch.tensor([[1]]),
                            cfg.rope_theta).numpy()[0, 0, 0]
    half = cfg.resolved_head_dim // 2
    assert out[1] == 0 and abs(out[half] - np.sin(1.0)) < 1e-6


def test_qkv_and_out_proj(model):
    jcfg, cfg, ref, port = model
    lp_j = jax.tree.map(lambda a: a[0], ref["layers"])
    lp_t = _port_layer0(port)
    x = _x(2, 6, cfg.d_model)
    for t, j in zip(attention.qkv_proj(lp_t["attn"], cfg, torch.tensor(x)),
                    JA.qkv_proj(lp_j["attn"], jcfg, jnp.asarray(x))):
        _close(t, j)
    att = _x(2, 6, cfg.n_heads, cfg.resolved_head_dim, seed=3)
    _close(attention.out_proj(lp_t["attn"], cfg, torch.tensor(att)),
           JA.out_proj(lp_j["attn"], jcfg, jnp.asarray(att)))


def test_swiglu_mlp(model):
    jcfg, cfg, ref, port = model
    lp_j = jax.tree.map(lambda a: a[0], ref["layers"])
    x = _x(3, 4, cfg.d_model)
    _close(mlp.mlp_apply(_port_layer0(port)["ffn"], cfg, torch.tensor(x)),
           JM.mlp_apply(lp_j["ffn"], jcfg, jnp.asarray(x)))


def test_gelu_mlp_uses_tanh_approximation():
    jcfg = jget("whisper-medium").reduced()
    cfg = get_config("whisper-medium").reduced()
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": _x(d, f, seed=1) / 10, "b_up": _x(f, seed=2),
         "w_down": _x(f, d, seed=3) / 10, "b_down": _x(d, seed=4)}
    x = _x(2, 3, d)
    _close(mlp.mlp_apply({k: torch.tensor(v) for k, v in p.items()}, cfg,
                         torch.tensor(x)),
           JM.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        jnp.asarray(x)))


def test_lm_logits(model):
    jcfg, cfg, ref, port = model
    h = _x(2, 3, cfg.d_model)
    _close(transformer.lm_logits(port, cfg, torch.tensor(h)),
           JT.lm_logits(jax.tree.map(jnp.asarray, ref), jcfg,
                        jnp.asarray(h)))


def test_embed_lookup(model):
    _, cfg, ref, port = model
    ids = np.array([[0, 5, cfg.vocab_size - 1]])
    np.testing.assert_array_equal(
        layers.embed_lookup(port["embed"], torch.tensor(ids)).numpy(),
        ref["embed"]["table"][ids])


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_from_reference_keeps_keys_shapes_and_values(model):
    _, _, ref, port = model
    assert _shapes(port) == _shapes(ref)
    np.testing.assert_array_equal(port["layers"]["attn"]["wq"].numpy(),
                                  ref["layers"]["attn"]["wq"])
    assert port["embed"]["table"].dtype == torch.float32


def test_from_reference_casts_dtype(model):
    ref = model[2]
    bf = from_reference(ref, dtype=torch.bfloat16, device="cpu")
    assert bf["final_norm"]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_key_tree_matches_reference(arch):
    cfg = get_config(arch).reduced()
    ref = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), jget(arch).reduced(), dtype=jnp.float32))
    got = transformer.init_params(cfg, generator=torch.Generator()
                                  .manual_seed(0), dtype=torch.float32,
                                  device="cpu")
    assert _shapes(got) == _shapes(ref)
    # init scales follow the reference: 1/sqrt(fan_in) dense, 0.02 embed
    wq = got["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(got["embed"]["table"].std()) - 0.02) < 0.002
    assert (got["final_norm"]["scale"] == 1).all()


def test_init_params_is_seeded():
    cfg = get_config("smollm-135m").reduced()
    a, b = (transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu") for _ in range(2))
    assert torch.equal(a["layers"]["ffn"]["w_up"], b["layers"]["ffn"]["w_up"])


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference({"x": np.zeros(2, np.float32)})
