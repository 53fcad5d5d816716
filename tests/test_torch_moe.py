"""Port MoE layer (``repro_torch.models.moe``) against the JAX reference,
on the CPU.

The same numpy inputs and the reference's ``moe_init`` weights (bridged
by ``from_reference``) go through ``repro.models.moe.moe_apply`` and the
port's: reduced granite-moe-1b-a400m (4 experts, top-2), reduced
llama4-scout-17b-a16e (top-1 plus the shared expert), and one layer at
granite's full width (d_model 1024, 32 experts, top-8, d_ff_expert 512)
on 64 tokens.  With ``capacity_factor=0.25`` and ``group_size=16`` on 48
tokens the groups overflow: the dropped (token, choice) pairs and every
destination row must equal the reference's ``_dispatch_one_group``'s
exactly.

Tolerances: float32 out atol 1e-5 (the two frameworks sum the expert
products in other orders, ~1e-6 on O(1) values), aux 1e-6 (a mean of
probabilities); bf16 out atol 3e-2, four bf16 ulps (2^-7 each) at the
largest |out| (~2.3 here), because the combine sums the k gated expert
outputs in bf16 in both packages and the two frameworks round the expert
products at other points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import moe, transformer as T
from repro_torch.models.params import from_reference

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _layer(arch, reduced=True, seed=0, dtype=jnp.float32):
    jcfg, cfg = jget(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    return jcfg, cfg, jp


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _both(jcfg, cfg, jp, x, **kw):
    jo, ja = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), **kw)
    tp = from_reference(_np(jp), device="cpu")
    to, ta = moe.moe_apply(tp, cfg, torch.tensor(x), **kw)
    return np.asarray(jo), float(ja), to.numpy(), float(ta)


@pytest.mark.parametrize("arch,reduced,shape", [
    ("granite-moe-1b-a400m", True, (2, 16, 128)),
    ("llama4-scout-17b-a16e", True, (2, 16, 128)),
    ("granite-moe-1b-a400m", False, (2, 32, 1024)),
], ids=["granite_reduced", "llama4_shared_expert", "granite_full_width"])
def test_moe_apply_matches_reference(arch, reduced, shape):
    jcfg, cfg, jp = _layer(arch, reduced)
    jo, ja, to, ta = _both(jcfg, cfg, jp, _x(shape, 1))
    assert to.shape == shape
    np.testing.assert_allclose(to, jo, atol=1e-5)
    assert abs(ta - ja) <= 1e-6
    if arch.startswith("llama4"):
        assert "shared" in jp and cfg.moe.n_shared_experts == 1


def _reference_dispatch(jp, jcfg, x, factor, group_size):
    """The reference's routing and ``_dispatch_one_group`` over its groups,
    as its ``moe_apply`` runs them: (dest (G, Tg*k), gates (G, Tg, k))."""
    e = jcfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xf.shape[0]
    probs = jax.nn.softmax(xf @ jp["router"], axis=-1)
    gates, eidx = jax.lax.top_k(probs, e.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    gsz = min(group_size, t)
    while t % gsz:
        gsz //= 2
    cap = jmoe._capacity(gsz, e.top_k, e.n_experts, factor)
    ng = t // gsz
    _, dest, g = jax.vmap(lambda a, g_, i_: jmoe._dispatch_one_group(
        a, g_, i_, e.n_experts, cap))(
        xf.reshape(ng, gsz, -1), gates.reshape(ng, gsz, e.top_k),
        eidx.reshape(ng, gsz, e.top_k))
    return np.asarray(dest), np.asarray(g), cap


def test_capacity_drops_equal_reference_across_groups():
    jcfg, cfg, jp = _layer("granite-moe-1b-a400m")
    x = _x((3, 16, 128), 2)                          # T 48: groups of 16
    kw = dict(capacity_factor=0.25, group_size=16)
    jdest, jgates, cap = _reference_dispatch(jp, jcfg, x, **{
        "factor": 0.25, "group_size": 16})
    tp = from_reference(_np(jp), device="cpu")
    xf = torch.tensor(x).reshape(48, 128)
    gates, eidx, _ = moe.route(tp, cfg, xf)
    k, n_e = cfg.moe.top_k, cfg.moe.n_experts
    assert moe.group_size_for(48, 16) == 16
    assert cap == moe._capacity(16, k, n_e, 0.25) == 8
    _, dest, g = moe.dispatch(xf.reshape(3, 16, 128),
                              gates.reshape(3, 16, k),
                              eidx.reshape(3, 16, k), n_e, cap)
    dropped = dest.numpy() == n_e * cap
    assert dropped.any() and not dropped.all()      # drops in every run
    assert dropped.reshape(3, -1).any(axis=1).sum() >= 2   # several groups
    np.testing.assert_array_equal(dest.numpy(), jdest)
    np.testing.assert_array_equal(dropped, jdest == n_e * cap)
    np.testing.assert_allclose(g.numpy(), jgates, atol=1e-6)
    assert (g.numpy().reshape(3, -1)[dropped] == 0).all()
    jo, ja, to, ta = _both(jcfg, cfg, jp, x, **kw)
    np.testing.assert_allclose(to, jo, atol=1e-5)
    assert abs(ta - ja) <= 1e-6


def test_moe_apply_bf16_matches_reference():
    jcfg, cfg, jp = _layer("granite-moe-1b-a400m", dtype=jnp.bfloat16)
    x = _x((2, 16, 128), 3)
    jo, ja = jmoe.moe_apply(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    tp = from_reference(_np(jp), dtype=torch.bfloat16, device="cpu")
    to, ta = moe.moe_apply(tp, cfg, torch.tensor(x).to(torch.bfloat16))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_router_stays_float32():
    jcfg, cfg = jget("granite-moe-1b-a400m").reduced(), \
        get_config("granite-moe-1b-a400m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.bfloat16)
    assert jparams["layers"]["ffn"]["router"].dtype == jnp.float32
    tp = from_reference(_np(jparams), dtype=torch.bfloat16, device="cpu")
    assert tp["layers"]["ffn"]["router"].dtype == torch.float32
    assert tp["layers"]["ffn"]["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["ffn"]["router"].numpy(),
        np.asarray(jparams["layers"]["ffn"]["router"]))
    own = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16, device="cpu")
    assert own["layers"]["ffn"]["router"].dtype == torch.float32
    assert own["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda a: tuple(a.shape), own) == shapes
