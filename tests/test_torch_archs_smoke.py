"""Every architecture of the port against the JAX reference, on the CPU
(twin of ``tests/test_archs_smoke.py``, parametrized like it over every
arch in ``repro.configs.ARCHS``).

Each arch's reduced config, fp32, on the reference's ``init_params``
weights bridged by ``from_reference``; among them granite-moe-1b-a400m (4
experts, top-2), llama4-scout-17b-a16e (4 experts, top-1 plus a shared
expert), zamba2-2.7b (2 cycles of 5 mamba slots and the shared attention
block) and whisper-medium (2 encoder and 2 decoder layers over 32 frames,
which every call is given, as the reference's test gives them): the
parameter trees, ``forward`` (hidden states, the summed MoE aux loss, the
collected KV, cross KV and mamba states), ``loss_fn``, the MoE models' and
whisper's every gradient, ``prefill`` plus teacher-forced
``decode_step``s, and decode against ``forward`` on the longer sequence.

Tolerances: forward and loss atol 1e-5 (the frameworks sum in other
orders, ~1e-6 on O(1) values); gradients 2e-5, as the smollm twins in
``tests/test_torch_train.py``; the serving path's logits and caches 1e-4
over the steps, tokens identical, as the other serving twins; decode
against forward 1e-4 (the mamba recurrence and the chunked scan are the
same function summed in other orders).  The reduced MoE configs have
``capacity_factor`` 8, so no assignment drops and a token's output does
not depend on its batch-mates (at full width it does; see
``tests/test_torch_moe.py`` for the drops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train.loop import Trainer

torch.set_num_threads(1)

ARCHS = sorted(JARCHS)
GRAD_ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e",
              "whisper-medium"]
ATOL = 1e-4


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jget(request.param).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    ref = _np(jparams)
    return jcfg, get_config(request.param).reduced(), jparams, ref, \
        from_reference(ref, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _frames(cfg, b, seed):
    """The encoder's frames for an encoder-decoder model, else None."""
    if not cfg.n_encoder_layers:
        return None
    return np.random.RandomState(seed).randn(
        b, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _batch(toks, frames, conv):
    batch = {"tokens": conv(toks)}
    if frames is not None:
        batch["frames"] = conv(frames)
    return batch


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_param_trees_match_reference(model):
    jcfg, cfg, jparams, _, params = model
    assert _shapes(params) == _shapes(jparams)
    own = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    assert _shapes(own) == _shapes(jparams)
    if cfg.family == "hybrid":
        assert isinstance(params["slots"], tuple) and len(params["slots"]) \
            == sum(k != "shared_attn" for k in cfg.block_pattern) == 5
        # one shared attention tree, not stacked per cycle
        assert params["shared_attn"]["attn"]["wq"].ndim == 2


def test_forward_matches_reference(model):
    jcfg, cfg, _, ref, params = model
    toks, fr = _tokens(cfg, 2, 24, 1), _frames(cfg, 2, 1)
    jh, jaux, jkv, (je, jxkv, jms) = JT.forward(
        ref, jcfg, jnp.asarray(toks), encoder_frames=_j(fr), collect_kv=True)
    h, aux, kv, (e, xkv, ms) = T.forward(
        params, cfg, torch.tensor(toks), encoder_frames=_t(fr),
        collect_kv=True)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert (float(aux) > 0) == (cfg.moe is not None)
    assert (kv is None) == (jkv is None)
    assert (xkv is None) == (jxkv is None) == (e is None) == (je is None)
    pairs = list(zip(kv or (), jkv or ())) + list(zip(xkv or (), jxkv or ()))
    if e is not None:
        pairs.append((e, je))
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    assert (ms is None) == (jms is None)
    if ms is not None:
        for k in ("conv", "ssm"):
            assert ms[k].shape == jms[k].shape
            np.testing.assert_allclose(ms[k].detach().numpy(),
                                       np.asarray(jms[k]), atol=1e-5)


def test_loss_matches_reference(model):
    jcfg, cfg, _, ref, params = model
    toks, fr = _tokens(cfg, 2, 32, 2), _frames(cfg, 2, 2)
    jl, jm = JT.loss_fn(ref, jcfg, _batch(toks, fr, jnp.asarray))
    loss, m = T.loss_fn(params, cfg, _batch(toks, fr, torch.as_tensor))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]),
                               atol=1e-5)
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * 31


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_moe_gradients_match_jax_grad(arch):
    """Every leaf's gradient of the total loss: a MoE model's router's
    through the gates and the aux loss included; whisper's encoder, its
    cross-attention and ``norm_x`` included."""
    jcfg = jget(arch).reduced()
    ref = _np(JT.init_params(jax.random.PRNGKey(3), jcfg,
                             dtype=jnp.float32))
    toks, fr = _tokens(jcfg, 2, 32, 4), _frames(jcfg, 2, 4)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, _batch(toks, fr, jnp.asarray)),
        has_aux=True)(jax.tree.map(jnp.asarray, ref))
    params = Trainer._trainable(from_reference(ref, device="cpu"))
    cfg = get_config(arch).reduced()
    loss, m = T.loss_fn(params, cfg, _batch(toks, fr, torch.as_tensor))
    assert (float(m["aux_loss"].detach()) > 0) == (cfg.moe is not None)
    leaves = adamw.flatten(params)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    want = {k: np.asarray(v) for k, v in
            jadamw._flatten_with_path(jg).items()}
    assert set(grads) == set(want)
    if cfg.moe is not None:
        assert any("router" in k for k in grads)
    else:
        assert {"encoder/layers/attn/wq", "layers/xattn/wk",
                "layers/norm_x/bias"} <= set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=2e-5,
                                   err_msg=path)


def _cache_pairs(jc, pc):
    out = []
    for k in ("k", "v", "xk", "xv"):
        if k in jc:
            out.append((k, jc[k], pc[k]))
    if "mamba" in jc:
        for k in ("conv", "ssm"):
            out.append((f"mamba/{k}", jc["mamba"][k], pc["mamba"][k]))
    return out


def test_prefill_and_teacher_forced_decode_match_reference(model):
    jcfg, cfg, jparams, _, params = model
    toks, fr = _tokens(cfg, 2, 30, 5), _frames(cfg, 2, 5)
    s, max_len = 22, 40
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :s]), max_len,
                        encoder_frames=_j(fr), cache_dtype=jnp.float32)
    pl, pc = T.prefill(params, cfg, torch.as_tensor(toks[:, :s]), max_len,
                       encoder_frames=_t(fr), cache_dtype=torch.float32)
    assert set(pc) == set(jc)
    steps = [(np.asarray(jl), pl.numpy())]
    for t in range(s, toks.shape[1]):
        pos = np.full((2,), t, np.int32)
        jl, jc = JT.decode_step(jparams, jcfg, jc,
                                jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(pos))
        pl, pc = T.decode_step(params, cfg, pc,
                               torch.as_tensor(toks[:, t:t + 1]),
                               torch.as_tensor(pos))
        steps.append((np.asarray(jl), pl.numpy()))
    v = cfg.vocab_size
    for i, (want, got) in enumerate(steps):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(got[:, :v].argmax(-1),
                                      want[:, :v].argmax(-1))
    for name, want, got in _cache_pairs(jc, pc):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)


def test_decode_matches_forward(model):
    """Teacher-forced decode reproduces the full forward's logits."""
    _, cfg, _, _, params = model
    toks = torch.as_tensor(_tokens(cfg, 1, 12, 6))
    fr = _t(_frames(cfg, 1, 6))
    hidden, _, _, _ = T.forward(params, cfg, toks, encoder_frames=fr)
    full = T.lm_logits(params, cfg, hidden)
    prefix = 7
    logits, cache = T.prefill(params, cfg, toks[:, :prefix], 14,
                              encoder_frames=fr, cache_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), full[:, prefix - 1].numpy(),
                               atol=ATOL)
    for t in range(prefix, 12):
        logits, cache = T.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                      torch.full((1,), t))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=ATOL, err_msg=f"decode@{t}")


def test_assignment_cells_accounted():
    """Twin of the reference's: 40 cells, each applicable or a documented
    skip; exactly the 7 pure full-attention archs skip ``long_500k``, and
    every cell's verdict and reason equal the reference's."""
    from repro.configs import all_cells as jall_cells
    from repro_torch.configs import all_cells
    cells = [(c.arch_id, s.name, ok, why) for c, s, ok, why in all_cells()]
    assert len(cells) == 40
    skipped = [(a, s) for a, s, ok, _ in cells if not ok]
    assert len(skipped) == 7
    assert all(s == "long_500k" for _, s in skipped)
    assert cells == [(c.arch_id, s.name, ok, why)
                     for c, s, ok, why in jall_cells()]
