"""granite-4.0-h-small on the port's CPU path against its plain reference
(``perfbench/reference/granite4h.py``), at a small size: one whole
10-layer period (``M M M M M A M M M M``) at d 128, 8 experts of which 2
are held, vocabulary 512, seeded random weights (``perfbench/
weights_granite4h.py``), float32.

The port and the reference agree to float32 rounding: logits and loss at
atol 1e-5, every leaf's gradient at atol 2e-5 / rtol 1e-4 (the mamba2
reference's tolerances: the same scan, the same products, sums in other
orders), one AdamW step's change and first moment at rel 1e-3 / 1e-4.
The expert layer's shares add up to the whole layer; the dropless
dispatch equals a loop over tokens; attention with a softmax scale other
than 1/sqrt(D) equals a plain softmax with that scale, forward and
backward.  This file imports nothing of JAX.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from perfbench import harness, smallcells_extra, weights_granite4h
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_config
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention, moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.telemetry import spans
from repro_torch.train.loop import TrainConfig, Trainer

REF = harness.reference_module("granite4h")


def _setup(seed=5, **moe_kw):
    config = smallcells_extra.granite_config(**moe_kw)
    cfg = harness.model_config(config)
    params = weights_granite4h.make(config, seed, torch.float32, "cpu")
    tokens = torch.randint(0, config["vocab_size"], (2, 64),
                           generator=torch.Generator().manual_seed(seed))
    return config, cfg, params, tokens


def test_the_configuration_file_builds_the_ports_config():
    config = harness.load_config("granite-4.0-h-small")
    cfg = harness.model_config(config)
    assert isinstance(cfg.moe, MoEConfig)
    assert (cfg.moe.n_experts, cfg.moe.n_held, cfg.moe.top_k) == (72, 9, 10)
    assert cfg.moe.shared_width == 1536 and cfg.moe.dropless
    assert cfg.per_layer_pattern and cfg.n_layers == 10
    assert cfg.layer_kinds().index("attn") == 5
    assert cfg.vocab_size == cfg.padded_vocab == 100352 // 8
    assert cfg.attn_scale == 1 / 128 and cfg.pos_embed == "none"
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling) == (12, 0.22, 16)
    published = get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" in EXTRA_ARCHS
    assert "granite-4.0-h-small" not in ARCHS
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "ssm",
              "tie_embeddings", "attention_multiplier"):
        assert getattr(cfg, f) == getattr(published, f), f
    assert dataclasses.replace(cfg.moe, experts_held=0) == published.moe
    assert published.n_layers == 40 and published.vocab_size == 100352


def test_logits_match_the_reference():
    config, cfg, params, tokens = _setup()
    hidden, aux, _, _ = T.forward(params, cfg, tokens)
    got = T.lm_logits(params, cfg, hidden)
    want = REF.logits(adamw.flatten(params), config, tokens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(aux) > 0


def test_loss_gradients_and_adamw_match_the_reference():
    config, cfg, params, tokens = _setup(seed=9)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in adamw.flatten(params).items()}
    port_loss, m = T.loss_fn(adamw.unflatten(leaves), cfg,
                             {"tokens": tokens})
    port_grads = torch.autograd.grad(port_loss, list(leaves.values()))
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in leaves.items()}
    ref_loss = REF.loss(P, config, tokens)
    ref_grads = torch.autograd.grad(ref_loss, list(P.values()))
    torch.testing.assert_close(ref_loss, port_loss, atol=1e-5, rtol=1e-5)
    assert float(port_loss.detach()) == pytest.approx(
        float(m["loss"] + 0.001 * m["aux_loss"]), rel=1e-6)
    for k, a, b in zip(leaves, ref_grads, port_grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4, msg=k)
        assert float(b.abs().max()) > 0, k
    cell, _ = smallcells_extra.train_cell()
    opt = dict(cell["traffic"]["opt"], warmup_steps=1)
    got = REF.train(params, config, [tokens], opt)
    state = adamw.init(params)
    new = {k: v.clone() for k, v in adamw.flatten(params).items()}
    adamw.update(adamw.unflatten(dict(zip(leaves, port_grads))), state,
                 adamw.unflatten(new), adamw.AdamWConfig(**opt))
    for k, v in adamw.flatten(params).items():
        change = float((new[k] - v).norm())
        assert got["change"][k] == pytest.approx(change, rel=1e-3, abs=1e-7)
        first = float(adamw.flatten(state["m"])[k].norm()) / (1 - opt["b1"])
        assert got["first_grad"][k] == pytest.approx(first, rel=1e-4,
                                                     abs=1e-9)


@pytest.mark.parametrize("held", [1, 2, 4])
def test_the_expert_shares_add_up_to_the_whole_layer(held):
    """8 / ``held`` chips' blocks of ``held`` of the 8 experts, each with
    the shared expert, add up to the uncut reference's whole layer with
    the shared expert counted once.  A chip holds its layer's first
    ``held`` experts, so each block's router columns are rolled to put the
    block first."""
    config, cfg, params, tokens = _setup(seed=3, experts_held=8)
    whole = {k: v[0] for k, v in
             adamw.flatten(params["mamba_layers"]["ffn"]).items()}
    x = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(4))
    want, want_aux = REF.moe(
        config, False, x, *(whole[k.split("/", 1)[1]]
                            for k in REF.FFN_KEYS))
    parts, shared = [], None
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, experts_held=held))
    for lo in range(0, 8, held):
        p = adamw.unflatten(
            {k: (v[lo:lo + held] if k.startswith("w_") else
                 v.roll(-lo, dims=1) if k == "router" else v)
             for k, v in whole.items()})
        out, aux = moe.moe_apply(p, c, x)
        parts.append(out)
        shared = moe.mlp.mlp_apply(p["shared"], c, x)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    got = sum(parts) - (len(parts) - 1) * shared
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _swiglu(params, e, x):
    return (F.silu(x @ params["w_gate"][e]) * (x @ params["w_up"][e])) \
        @ params["w_down"][e]


def test_dropless_dispatch_equals_a_loop_over_tokens():
    """Uneven loads, pairs of experts held elsewhere (ids below 0 or past
    the block) and a held expert that no pair chose."""
    g = torch.Generator().manual_seed(6)
    d, f, n_held = 16, 8, 4
    params = {"w_gate": torch.randn(n_held, d, f, generator=g),
              "w_up": torch.randn(n_held, d, f, generator=g),
              "w_down": torch.randn(n_held, f, d, generator=g)}
    local = torch.tensor([[0, 1], [0, -2], [1, 0], [5, 3], [-1, 4],
                          [0, 3], [1, -3]])
    gates = torch.rand(local.shape, generator=g)
    x = torch.randn(local.shape[0], d, generator=g)
    got, sizes, extra = moe.dropless(params, x, gates, local, n_held,
                                     lambda: "shared")
    assert sizes == [4, 3, 0, 2] and extra == "shared"
    want = torch.zeros_like(x)
    for t in range(local.shape[0]):
        for c in range(local.shape[1]):
            e = int(local[t, c])
            if 0 <= e < n_held:
                want[t] += gates[t, c] * _swiglu(params, e, x[t:t + 1])[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_the_held_layer_counts_its_pairs():
    _, cfg, params, tokens = _setup(seed=8)
    before = dict(spans.COUNTS)
    T.forward(params, cfg, tokens)
    got = {k: spans.COUNTS[k] - before.get(k, 0)
           for k in ("moe.pairs", "moe.pairs_held", "moe.pairs_held_max")}
    assert got["moe.pairs"] == 10 * tokens.numel() * cfg.moe.top_k
    assert 0 < got["moe.pairs_held_max"] <= got["moe.pairs_held"] \
        < got["moe.pairs"]


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_attention_with_a_scale_equals_a_plain_softmax(heads):
    """``ops.mha_fused`` and ``attend_chunked`` at scale 1/128, forward
    and backward, against autograd of a plain masked softmax."""
    h, kh = heads
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, h, 40, 32, generator=g, requires_grad=True)
    k = torch.randn(2, kh, 40, 32, generator=g, requires_grad=True)
    v = torch.randn(2, kh, 40, 32, generator=g, requires_grad=True)
    scale = 0.0078125
    got = fa_ops.mha_fused(q, k, v, True, 0, scale)
    ke, ve = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    s = (q @ ke.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.softmax(s, -1) @ ve
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    dout = torch.randn(got.shape, generator=g)
    g1 = torch.autograd.grad((got * dout).sum(), (q, k, v))
    g2 = torch.autograd.grad((want * dout).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    chunked = attention.attend_chunked(
        *(t.detach().transpose(1, 2) for t in (q, k, v)), chunk=16,
        scale=scale)
    torch.testing.assert_close(chunked.transpose(1, 2), want.detach(),
                               atol=1e-5, rtol=1e-5)
    default = fa_ops.mha_fused(q, k, v, True, 0)
    assert not torch.allclose(default, got)


def test_the_trainer_trains_the_reduced_model(tmp_path):
    cfg = get_config("granite-4.0-h-small").reduced()
    assert cfg.n_layers == 10 and cfg.moe.n_held == 8
    tcfg = TrainConfig(steps=3, log_every=1, ckpt_every=0,
                       ckpt_dir=str(tmp_path), seed=1)
    tr = Trainer(cfg, ShapeConfig("t", "train", 64, 2), tcfg, device="cpu")
    before = {k: v.detach().clone()
              for k, v in adamw.flatten(tr.params).items()}
    out = tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert out["final_step"] == 3 and len(losses) == 3
    assert all(torch.isfinite(torch.tensor(losses)))
    after = adamw.flatten(tr.params)
    assert all(not torch.equal(after[k], v) for k, v in before.items())


def test_specs_follow_the_parameter_tree_and_the_count_is_published():
    from repro_torch.models.sharding import MeshRules, flatten_specs
    cfg = get_config("granite-4.0-h-small").reduced()
    params = adamw.flatten(T.init_params(
        cfg, generator=torch.Generator().manual_seed(0),
        dtype=torch.float32, device="cpu"))
    specs = flatten_specs(T.param_specs(cfg, MeshRules.single_device()))
    assert sorted(specs) == sorted(params)
    assert all(len(specs[k]) == v.dim() for k, v in params.items())
    # 32B of "32B-A9B": every expert of the published model
    assert 32.0e9 < get_config("granite-4.0-h-small").n_params() < 32.5e9


def test_the_decode_cache_refuses_the_per_layer_hybrid():
    cfg = get_config("granite-4.0-h-small").reduced()
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg, 1, 64, device="cpu")
