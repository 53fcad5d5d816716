"""Model assembly: parameter init, the full-sequence forward, the LM head,
the training loss and the dense-cache serving path.

Twin of ``repro.models.transformer`` for every family: dense attention
(``block_pattern == ("attn",)``), with a dense or MoE FFN
(``models/moe.py``), Mamba-2 (``("mamba",)``), the zamba2 hybrid (a
pattern of mamba slots and one ``"shared_attn"`` block, cycled) and the
whisper encoder-decoder (``n_encoder_layers``: an ``encoder`` tree of
non-causal layers over precomputed frames, sinusoidal absolute positions,
and a cross-attention ``xattn`` with its ``norm_x`` in every decoder
layer; the audio frontend is a stub in both packages).
``init_params`` builds the reference's key tree with the same shapes and
init scales: uniform layers stacked on a leading L axis; a hybrid's
``slots``, a tuple with one tree per mamba slot stacked over the cycles,
and ``shared_attn``, one attention-plus-MLP layer whose weights every
cycle reuses.  The random numbers come from a ``torch.Generator`` and
differ from JAX's.  ``forward`` runs the layers in a Python loop over
views of the stacked parameters (the reference's ``lax.scan``) and sums
the MoE layers' aux losses.  Attention goes through
``attention.attend_chunked`` (the flash-attention kernels on the card),
the mamba blocks' scan through ``kernels/ssd/ops.ssd`` (the SSD kernel on
the card).  ``init_cache``, ``prefill`` and ``decode_step`` serve every
family through a dense decode cache: per-layer KV of ``max_len``
positions, or for a sliding-window model a ring of the window; a mamba
model's O(1) conv and SSM states; a hybrid's mamba states per (cycle,
slot) and one KV ring of ``decode_cache_len`` (at most 4096) per cycle;
an encoder-decoder's cross KV (``xk``/``xv``, one entry per frame) beside
its self-attention KV.  ``remat`` wraps each decoder, mamba or hybrid-cycle
body in ``torch.utils.checkpoint`` (``_remat``); the encoder runs without,
as the reference's encoder scan does.

A per-layer hybrid (``cfg.per_layer_pattern``: granite-4.0-h-small,
which has no JAX twin) cycles ``"mamba_ffn"`` and ``"attn"`` layers, each
with its own weights and the MoE FFN after its mixer, stacked by kind in
``mamba_layers`` and ``attn_layers``; its muP scalars
(``embedding_multiplier``, ``residual_multiplier``, ``logits_scaling``,
``attention_multiplier``) scale the embeddings, both residual branches,
the logits and the softmax, and its attention has no positions
(``pos_embed == "none"``).  Each layer's mixer and MoE run under the
device-timed spans ``train.mamba`` / ``train.attn`` and ``train.moe``.
It trains on one device; neither the decode cache nor a mesh's split
serves it.

``param_specs`` and ``cache_specs`` are the reference's partition-spec
trees, congruent with ``init_params`` and ``init_cache``.  On a mesh
(``launch/steps.py``) each rank runs these functions on its own block:
``sharded`` (a :class:`~repro_torch.models.sharding.ShardedCompute`)
splits the attention heads and the SwiGLU columns on ``model``, with
Megatron's pair around each split part, and ``decode_step(cp_mesh=...)``
attends over a sequence-sharded KV cache with
``attention.attend_decode_cp``.  ``rules`` is taken where the reference
takes it; its ``constrain`` hints are the identity here.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mlp, moe, ssm
from repro_torch.models.sharding import MeshRules, P, constrain
from repro_torch.telemetry import spans


def _uniform(cfg: ModelConfig) -> bool:
    return len(cfg.block_pattern) == 1


def _n_cycles(cfg: ModelConfig) -> int:
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.arch_id}: n_layers {cfg.n_layers} not "
                         f"divisible by pattern {cfg.block_pattern}")
    return cfg.n_layers // len(cfg.block_pattern)


def _is_moe_layer(cfg: ModelConfig) -> bool:
    # every layer, whatever ``moe_layer_period`` says: the reference's rule
    return cfg.moe is not None


def _norm_init(cfg: ModelConfig, device):
    """A layer's norm: LayerNorm for the whisper family (GELU), else
    RMSNorm, as the reference picks them."""
    init = layers.layernorm_init if cfg.act == "gelu" else layers.rmsnorm_init
    return init(cfg.d_model, device=device)


def _attn_layer(gen, cfg: ModelConfig, *,
                cross: bool = False) -> Dict[str, Any]:
    """Self-attention plus FFN; ``cross`` adds a decoder layer's
    cross-attention ``xattn`` (its own wq, wk, wv, wo) and its ``norm_x``."""
    dev = gen.device
    attn = attention.attn_init(gen, cfg)
    ffn = (moe.moe_init(gen, cfg) if _is_moe_layer(cfg)
           else mlp.mlp_init(gen, cfg))
    p = {"norm1": _norm_init(cfg, dev), "attn": attn,
         "norm2": _norm_init(cfg, dev), "ffn": ffn}
    if cross:
        p.update(norm_x=_norm_init(cfg, dev),
                 xattn=attention.attn_init(gen, cfg))
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _mamba_layer(gen, cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": layers.rmsnorm_init(cfg.d_model, device=gen.device),
            "mamba": ssm.mamba_init(gen, cfg)}


def _mamba_ffn_layer(gen, cfg: ModelConfig) -> Dict[str, Any]:
    """A per-layer hybrid's Mamba-2 mixer plus its MoE."""
    dev = gen.device
    return {"norm1": _norm_init(cfg, dev), "mamba": ssm.mamba_init(gen, cfg),
            "norm2": _norm_init(cfg, dev), "ffn": moe.moe_init(gen, cfg)}


_PER_LAYER = {"mamba_ffn": ("mamba_layers", _mamba_ffn_layer),
              "attn": ("attn_layers", _attn_layer)}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Parameter tree with the reference ``init_params`` key tree and
    shapes, layers stacked on a leading axis.  Draws each layer in float32
    on the generator's device and casts it to ``dtype`` on ``device``
    before stacking, so at most one layer is alive in float32 (the SSM's
    ``dt_bias``, ``A_log`` and ``D`` and the MoE router stay float32, as
    in the reference).  An encoder-decoder model also gets ``encoder``:
    {"layers": its stacked self-attention layers, "final_norm": a
    LayerNorm}."""
    device = resolve_device(device)

    def cast(tree):
        return ssm.cast(tree, device, dtype)

    p: Dict[str, Any] = {
        "embed": cast(layers.embed_init(generator, cfg.padded_vocab,
                                        cfg.d_model)),
        "final_norm": cast(_norm_init(cfg, generator.device)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cast(layers.dense_init(generator, cfg.d_model,
                                              cfg.padded_vocab))
    if cfg.per_layer_pattern:
        kinds = cfg.layer_kinds()
        for kind, (key, make) in _PER_LAYER.items():
            p[key] = _stack([cast(make(generator, cfg))
                             for k in kinds if k == kind])
        return p
    if not _uniform(cfg):
        nc = _n_cycles(cfg)
        slots = []
        for kind in cfg.block_pattern:
            if kind == "shared_attn":
                p["shared_attn"] = cast(_attn_layer(generator, cfg))
            else:
                slots.append(_stack([cast(_mamba_layer(generator, cfg))
                                     for _ in range(nc)]))
        p["slots"] = tuple(slots)
        return p
    if cfg.block_pattern[0] == "mamba":
        per = [cast(_mamba_layer(generator, cfg))
               for _ in range(cfg.n_layers)]
    else:
        cross = cfg.n_encoder_layers > 0
        per = [cast(_attn_layer(generator, cfg, cross=cross))
               for _ in range(cfg.n_layers)]
    p["layers"] = _stack(per)
    if cfg.n_encoder_layers:
        enc = [cast(_attn_layer(generator, cfg))
               for _ in range(cfg.n_encoder_layers)]
        p["encoder"] = {
            "layers": _stack(enc),
            "final_norm": cast(layers.layernorm_init(
                cfg.d_model, device=generator.device))}
    return p


def _norm_specs(cfg: ModelConfig, *, layernorm: bool = False):
    keys = ("scale", "bias") if layernorm or cfg.act == "gelu" else ("scale",)
    return layers.norm_specs(dict.fromkeys(keys))


def _attn_layer_specs(cfg: ModelConfig, rules: MeshRules,
                      *, cross: bool = False):
    s = {
        "norm1": _norm_specs(cfg),
        "attn": attention.attn_specs(cfg, rules),
        "norm2": _norm_specs(cfg),
    }
    if _is_moe_layer(cfg):
        s["ffn"] = moe.moe_specs(cfg, rules)
    else:
        s["ffn"] = mlp.mlp_specs(cfg, rules)
    if cross:
        s["norm_x"] = s["norm1"]
        s["xattn"] = attention.attn_specs(cfg, rules)
    return s


def _mamba_layer_specs(cfg: ModelConfig, rules: MeshRules):
    return {
        "norm": _norm_specs(cfg),
        "mamba": ssm.mamba_specs(cfg, rules),
    }


def _lift(tree, n: int = 1):
    """Prepend ``n`` unsharded axes (the stacked layer / cycle axes)."""
    if isinstance(tree, dict):
        return {k: _lift(v, n) for k, v in tree.items()}
    return P(*((None,) * n + tuple(tree)))


def param_specs(cfg: ModelConfig, rules: MeshRules) -> Dict:
    """Partition-spec tree congruent with ``init_params``' output.  The
    stacked layer axis is never sharded."""
    s: Dict[str, Any] = {
        "embed": layers.embed_specs(rules, cfg.padded_vocab, cfg.d_model),
        "final_norm": _norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = P(rules.fsdp(cfg.d_model), rules.tp(cfg.padded_vocab))
    cross = cfg.n_encoder_layers > 0
    if cfg.per_layer_pattern:
        s["mamba_layers"] = _lift(dict(
            norm1=_norm_specs(cfg), mamba=ssm.mamba_specs(cfg, rules),
            norm2=_norm_specs(cfg),
            ffn=_attn_layer_specs(cfg, rules)["ffn"]))
        s["attn_layers"] = _lift(_attn_layer_specs(cfg, rules))
    elif _uniform(cfg):
        per = (_mamba_layer_specs(cfg, rules)
               if cfg.block_pattern[0] == "mamba"
               else _attn_layer_specs(cfg, rules, cross=cross))
        s["layers"] = _lift(per)
    else:
        slots = []
        for kind in cfg.block_pattern:
            if kind == "shared_attn":
                s["shared_attn"] = _attn_layer_specs(cfg, rules)
            else:
                slots.append(_lift(_mamba_layer_specs(cfg, rules)))
        s["slots"] = tuple(slots)
    if cross:
        s["encoder"] = {
            "layers": _lift(_attn_layer_specs(cfg, rules)),
            "final_norm": _norm_specs(cfg, layernorm=True),
        }
    return s


def lm_logits(params, cfg: ModelConfig, hidden):
    """hidden (..., D) -> logits (..., V) float32 (over
    ``logits_scaling`` where the model has one)."""
    if cfg.tie_embeddings:
        out = hidden.float() @ params["embed"]["table"].float().T
    else:
        out = hidden.float() @ params["lm_head"].float()
    return out if cfg.logits_scaling == 1.0 else out / cfg.logits_scaling


def _unstack(tree, n: int):
    """Stacked layer tree -> n per-layer trees of views.  One ``unbind``
    per leaf, so the backward stacks each leaf's layer gradients once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


def _ffn(p, cfg: ModelConfig, h, sharded=None):
    """The layer's FFN: (out, aux loss or None), the SwiGLU columns split
    on ``model`` when ``sharded.mlp``."""
    tp = sharded is not None and sharded.mlp
    if tp:
        h = sharded.enter(h)
    if _is_moe_layer(cfg):
        frac_mean = sharded.frac_mean if sharded is not None else None
        out, aux = moe.moe_apply(p, cfg, h, frac_mean=frac_mean)
    else:
        out, aux = mlp.mlp_apply(p, cfg, h), None
    return (sharded.exit(out) if tp else out), aux


def _attn_in(sharded, h):
    return sharded.enter(h) if sharded is not None and sharded.attn else h


def _attn_out(sharded, o):
    return sharded.exit(o) if sharded is not None and sharded.attn else o


def _attn_block_fwd(p, cfg: ModelConfig, x, *, causal: bool, q_offset: int,
                    enc_out=None, fused: bool = False, sharded=None):
    """Self-attention (+ cross-attention over ``enc_out`` when given) +
    FFN with residuals.  Returns (x, aux or None, (k, v), xkv): k after
    RoPE, for prefill cache capture; xkv the cross-attention's (k, v) from
    ``enc_out`` (no RoPE), or None.  With ``sharded``, ``cfg`` is the
    rank's local config and the weights its split columns."""
    h = _attn_in(sharded, layers.norm_apply(p["norm1"], x, cfg.norm_eps))
    q, k, v = attention.qkv_proj(p["attn"], cfg, h)
    if cfg.pos_embed == "rope":
        pos = q_offset + torch.arange(x.shape[1], device=x.device)
        q = layers.apply_rope(q, pos[None, :], cfg.rope_theta)
        k = layers.apply_rope(k, pos[None, :], cfg.rope_theta)
    att = attention.attend_chunked(q, k, v, causal=causal,
                                   window=cfg.swa_window, q_offset=0,
                                   fused=fused)
    x = x + _attn_out(sharded, attention.out_proj(p["attn"], cfg, att))
    xkv = None
    if enc_out is not None:
        hx = _attn_in(sharded, layers.norm_apply(p["norm_x"], x,
                                                 cfg.norm_eps))
        enc_out = _attn_in(sharded, enc_out)
        hd, kh = cfg.resolved_head_dim, cfg.n_kv_heads
        qx = (hx @ p["xattn"]["wq"].to(hx.dtype)).reshape(
            hx.shape[0], hx.shape[1], cfg.n_heads, hd)
        ek = (enc_out @ p["xattn"]["wk"].to(enc_out.dtype)).reshape(
            enc_out.shape[0], enc_out.shape[1], kh, hd)
        ev = (enc_out @ p["xattn"]["wv"].to(enc_out.dtype)).reshape(
            enc_out.shape[0], enc_out.shape[1], kh, hd)
        ax = attention.attend_chunked(qx, ek, ev, causal=False, fused=fused)
        x = x + _attn_out(sharded, attention.out_proj(p["xattn"], cfg, ax))
        xkv = (ek, ev)
    h = layers.norm_apply(p["norm2"], x, cfg.norm_eps)
    out, aux = _ffn(p["ffn"], cfg, h, sharded)
    return x + out, aux, (k, v), xkv


def _mamba_block_fwd(p, cfg: ModelConfig, x):
    h = layers.norm_apply(p["norm"], x, cfg.norm_eps)
    out, final_cache = ssm.mamba_apply(p["mamba"], cfg, h)
    return x + out, final_cache


def _mixer_ffn_fwd(p, cfg: ModelConfig, x, kind: str, fused: bool):
    """One layer of a per-layer hybrid: x + r * mixer(norm1(x)), then
    x + r * moe(norm2(x)), r the ``residual_multiplier``; attention has no
    positions (NoPE).  Returns (x, the MoE's aux loss)."""
    r = cfg.residual_multiplier
    dev = x.device
    h = layers.norm_apply(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        with spans.span("train.attn", device=dev):
            q, k, v = attention.qkv_proj(p["attn"], cfg, h)
            att = attention.attend_chunked(q, k, v, causal=True,
                                           window=cfg.swa_window, fused=fused,
                                           scale=cfg.attn_scale)
            mix = attention.out_proj(p["attn"], cfg, att)
    else:
        with spans.span("train.mamba", device=dev):
            mix, _ = ssm.mamba_apply(p["mamba"], cfg, h)
    x = x + mix * r
    h = layers.norm_apply(p["norm2"], x, cfg.norm_eps)
    with spans.span("train.moe", device=dev):
        out, aux = _ffn(p["ffn"], cfg, h)
    return x + out * r, aux


def _per_layer_fwd(params, cfg: ModelConfig, x, *, fused: bool,
                   remat: str):
    """Every layer in order, each kind's weights taken from its stack in
    turn.  Returns (final hidden states, summed aux loss)."""
    kinds = cfg.layer_kinds()
    stacks = {kind: iter(_unstack(params[key], kinds.count(kind)))
              for kind, (key, _) in _PER_LAYER.items()}
    bodies = {kind: _remat(lambda lp, x, kind=kind: _mixer_ffn_fwd(
        lp, cfg, x, kind, fused), remat) for kind in _PER_LAYER}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind in kinds:
        x, la = bodies[kind](next(stacks[kind]), x)
        aux = aux + la
    return layers.norm_apply(params["final_norm"], x, cfg.norm_eps), aux


def _save_dots(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """The reference's ``_remat`` on one layer body.  ``"none"``: ``fn``
    as it is.  ``"full"`` (the reference's ``nothing_saveable``): only the
    body's inputs are kept and the backward runs the whole body again,
    attention kernels included.  Any other policy (the reference's
    ``checkpoint_dots_with_no_batch_dims``): the outputs of the 2-D matrix
    products ``aten.mm`` and ``aten.addmm`` are saved (every ``x @ W``
    projection and FFN product, which reach the dispatcher as one 2-D
    product over the flattened rows); everything else (norms,
    activations, RoPE, attention, batched products such as ``bmm``) is
    recomputed in the backward."""
    if policy == "none":
        return fn
    kw = {"use_reentrant": False}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, **kw)


def encode(params, cfg: ModelConfig, frames, sharded=None):
    """Whisper encoder: frames (B, enc_seq, D) -> enc_out (B, enc_seq, D).
    Sinusoidal positions, every layer non-causal, then the encoder's
    final LayerNorm.  No remat, as in the reference."""
    pe = layers.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     device=frames.device)
    x = frames + pe[None].to(frames.dtype)
    enc = params["encoder"]
    for lp in _unstack(enc["layers"], cfg.n_encoder_layers):
        x, _, _, _ = _attn_block_fwd(lp, cfg, x, causal=False, q_offset=0,
                                     sharded=sharded)
    return layers.norm_apply(enc["final_norm"], x, cfg.norm_eps)


def _embed_tokens(params, cfg: ModelConfig, tokens, *, offset: int = 0):
    x = layers.embed_lookup(params["embed"], tokens.long())
    if cfg.pos_embed == "absolute":
        pe = layers.sinusoidal_positions(offset + tokens.shape[1],
                                         cfg.d_model,
                                         device=x.device)[offset:]
        x = x + pe[None].to(x.dtype)
    return x


def forward(params, cfg: ModelConfig, tokens, *, encoder_frames=None,
            remat: str = "none", rules: Optional[MeshRules] = None,
            collect_kv: bool = False, compute_dtype=None,
            fused_attention: bool = False, sharded=None):
    """Full-sequence forward.  tokens (B, S) integer; ``encoder_frames``
    (B, enc_seq, D), which an encoder-decoder model needs.

    Returns (hidden (B,S,D), aux_loss, kv_stack_or_None, (enc_out, xkv,
    mamba_states)) as the reference does.  ``aux_loss`` is the sum of the
    MoE layers' load-balancing losses (0 without MoE).  ``collect_kv``:
    per-layer (k, v) stacked to (L, B, S, K, hd), and for an
    encoder-decoder the cross (k, v) stacked to (L, B, enc_seq, K, hd) as
    ``xkv``; for a mamba model each layer's final {"conv" (L,B,K-1,C),
    "ssm" (L,B,H,P,N) float32} cache; for a hybrid the shared block's
    (k, v) of each cycle, (NC, B, S, K, hd), and the mamba states stacked
    to (NC, n_mamba, B, ...).  ``enc_out`` is the encoder's output (None
    without an encoder).  ``remat``: "none", "full" or "dots", each
    decoder, mamba or hybrid-cycle body checkpointed by ``_remat``.
    ``compute_dtype``: activation dtype, frames included (params stay
    float32 masters, weights cast at use sites); None keeps the param
    dtype.  ``sharded``: this rank's share of a mesh's compute (see the
    module's docstring); None runs the whole model.
    """
    x = _embed_tokens(params, cfg, tokens)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        if encoder_frames is not None:
            encoder_frames = encoder_frames.to(compute_dtype)
    if rules is not None:
        x = constrain(x, P(rules.batch(tokens.shape[0]), None, None))
    enc_out = None
    if cfg.n_encoder_layers:
        if encoder_frames is None:
            raise ValueError(f"{cfg.arch_id} needs encoder frames")
        enc_out = encode(params, cfg, encoder_frames, sharded)
    if cfg.per_layer_pattern:
        if collect_kv or sharded is not None:
            raise NotImplementedError(
                f"{cfg.arch_id}: a per-layer hybrid runs whole, without a "
                "decode cache or a mesh's split")
        x, aux = _per_layer_fwd(params, cfg, x, fused=fused_attention,
                                remat=remat)
        return x, aux, None, (None, None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not _uniform(cfg):
        x, kv, ms = _hybrid_fwd(params, cfg, x, collect_kv=collect_kv,
                                fused=fused_attention, remat=remat,
                                sharded=sharded)
        return x, aux, kv, (None, None, ms)
    if cfg.block_pattern[0] == "mamba":
        body = _remat(lambda lp, x: _mamba_block_fwd(lp, cfg, x), remat)
        states = []
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, fc = body(lp, x)
            if collect_kv:
                states.append(fc)
        x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
        ms = _stack_states(states) if collect_kv else None
        return x, aux, None, (None, None, ms)

    def layer(lp, x, enc_out):
        return _attn_block_fwd(lp, cfg, x, causal=True, q_offset=0,
                               enc_out=enc_out, fused=fused_attention,
                               sharded=sharded)

    body = _remat(layer, remat)
    ks, vs, xks, xvs = [], [], [], []
    for lp in _unstack(params["layers"], cfg.n_layers):
        x, la, (k, v), xkv = body(lp, x, enc_out)
        if la is not None:
            aux = aux + la
        if collect_kv:
            ks.append(k)
            vs.append(v)
            if xkv is not None:
                xks.append(xkv[0])
                xvs.append(xkv[1])
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    xkv = (torch.stack(xks), torch.stack(xvs)) if xks else None
    return x, aux, kv, (enc_out, xkv, None)


def _stack_states(states):
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _hybrid_fwd(params, cfg: ModelConfig, x, *, collect_kv: bool,
                fused: bool, remat: str = "none", sharded=None):
    """The pattern run once per cycle (one ``_remat`` body): each mamba
    slot with its cycle's weights, the shared block with the one shared
    tree (no window: the reference's forward attends to the whole
    prefix).  Returns the final hidden states, the cycles' (k, v) and the
    stacked mamba states (None without ``collect_kv``)."""
    nc = _n_cycles(cfg)
    slots = [_unstack(sp, nc) for sp in params["slots"]]

    def cycle(slot_params, x):
        kv, states, si = None, [], 0
        for kind in cfg.block_pattern:
            if kind == "shared_attn":
                x, _, kv, _ = _attn_block_fwd(params["shared_attn"], cfg, x,
                                              causal=True, q_offset=0,
                                              fused=fused, sharded=sharded)
            else:
                x, fc = _mamba_block_fwd(slot_params[si], cfg, x)
                states.append(fc)
                si += 1
        return x, kv, states

    body = _remat(cycle, remat)
    ks, vs, states = [], [], []
    for c in range(nc):
        x, kv, cyc = body([sp[c] for sp in slots], x)
        if collect_kv:
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
            states.append(_stack_states(cyc))
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv and ks else None
    return x, kv, (_stack_states(states) if collect_kv else None)


def xent_loss(params, cfg: ModelConfig, hidden, labels, mask, *,
              chunk: int = 256):
    """Chunked cross-entropy so (B,S,V) logits never exist whole.

    hidden (B,S,D); labels/mask (B,S).  Returns (loss, n_tokens).  Each
    chunk's logits are recomputed in the backward pass (activation
    checkpointing), so at most one chunk's (B, chunk, V) float32 logits and
    their gradient are alive at a time."""
    s_len = hidden.shape[1]
    chunk = min(chunk, s_len)
    while s_len % chunk:
        chunk //= 2

    def nll_sum(h, lab, m):
        logits = lm_logits(params, cfg, h)                  # (B,c,V) fp32
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, lab[..., None])[..., 0]
        return ((lse - tgt) * m).sum()

    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s_len, chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + checkpoint(nll_sum, hidden[:, sl], labels[:, sl],
                               mask[:, sl], use_reentrant=False)
    n = mask.sum()
    return tot / n.clamp_min(1.0), n


def loss_fn(params, cfg: ModelConfig, batch, *, remat: str = "none",
            rules: Optional[MeshRules] = None,
            aux_weight: Optional[float] = None,
            compute_dtype=None, fused_attention: bool = False,
            sharded=None):
    """batch: {"tokens" (B,S), optional "frames" (B,enc_seq,D)}.
    Next-token LM loss plus ``aux_weight`` (None: the MoE config's
    ``aux_loss_coef``, 0.01 by default) times the aux loss.  Returns
    (total, {"loss", "aux_loss", "tokens"})."""
    if aux_weight is None:
        aux_weight = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.01
    tokens = batch["tokens"].long()
    hidden, aux, _, _ = forward(params, cfg, tokens,
                                encoder_frames=batch.get("frames"),
                                remat=remat, rules=rules,
                                compute_dtype=compute_dtype,
                                fused_attention=fused_attention,
                                sharded=sharded)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    loss, n = xent_loss(params, cfg, hidden, labels, mask)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": n}


# ================================================================= caches
def _not_served(cfg: ModelConfig):
    raise NotImplementedError(f"{cfg.arch_id}: the decode cache does not "
                              "serve a per-layer hybrid")


def decode_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Physical KV length: SWA archs cap at their window (ring buffer)."""
    if cfg.swa_window:
        return min(max_len, cfg.swa_window)
    if cfg.family == "hybrid":
        return min(max_len, 4096)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None, enc_seq: int = 0) -> Dict:
    """Decode state, stacked on the layer axis.  An attention model:
    {"k", "v"} each (L,B,KL,K,hd) in ``dtype``, KL = ``decode_cache_len``
    (a ring of the window for a sliding-window model); an encoder-decoder
    also {"xk", "xv"} each (L,B,enc_seq,K,hd), the cross KV that
    ``prefill`` fills from the encoder's output.  A mamba model:
    {"mamba": {"conv" (L,B,K-1,C) in ``dtype``, "ssm" (L,B,H,P,N)
    float32}}, whose size does not depend on ``max_len``.  A hybrid:
    {"mamba": {"conv" (NC,n_mamba,B,K-1,C), "ssm" (NC,n_mamba,B,H,P,N)},
    "k"/"v" (NC,B,KL,K,hd)}, KL at most 4096, one ring per cycle."""
    if cfg.per_layer_pattern:
        _not_served(cfg)
    device = resolve_device(device)
    if not _uniform(cfg):
        lead = (_n_cycles(cfg),
                sum(k != "shared_attn" for k in cfg.block_pattern))
        one = ssm.mamba_cache_init(cfg, batch, dtype=dtype, device=device)
        return {"mamba": {k: v.expand(lead + v.shape).clone()
                          for k, v in one.items()},
                **_kv_cache(cfg, lead[0], batch, max_len, dtype, device)}
    if cfg.block_pattern[0] == "mamba":
        one = ssm.mamba_cache_init(cfg, batch, dtype=dtype, device=device)
        return {"mamba": {k: v.expand((cfg.n_layers,) + v.shape).clone()
                          for k, v in one.items()}}
    c = _kv_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
    if cfg.n_encoder_layers:
        shape = (cfg.n_layers, batch, enc_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def cache_specs(cfg: ModelConfig, rules: MeshRules, batch: int,
                max_len: int) -> Dict:
    """Sharding of the decode cache.  KV heads shard on ``model`` when
    divisible; otherwise the *sequence* dim shards on ``model`` (the
    context-parallel decode of ``decode_step(cp_mesh=...)``)."""
    kl = decode_cache_len(cfg, max_len)
    bax = rules.batch(batch)
    kv_tp = rules.tp(cfg.n_kv_heads)
    seq_tp = None if kv_tp is not None else rules.tp(kl)
    kv_spec = P(None, bax, seq_tp, kv_tp, None)
    s: Dict[str, Any] = {}
    if _uniform(cfg):
        if cfg.block_pattern[0] == "mamba":
            s["mamba"] = _lift(ssm.mamba_cache_specs(cfg, rules, batch))
        else:
            s["k"] = kv_spec
            s["v"] = kv_spec
            if cfg.n_encoder_layers:
                s["xk"] = P(None, bax, None, kv_tp, None)
                s["xv"] = P(None, bax, None, kv_tp, None)
    else:
        s["mamba"] = _lift(ssm.mamba_cache_specs(cfg, rules, batch), 2)
        s["k"] = kv_spec
        s["v"] = kv_spec
    return s


def _kv_cache(cfg: ModelConfig, n: int, batch: int, max_len: int, dtype,
              device) -> Dict:
    """Zeroed {"k", "v"}, each (n, B, decode_cache_len, K, hd)."""
    shape = (n, batch, decode_cache_len(cfg, max_len), cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_update_cp(kc, vc, k, v, pos, mesh, axis: str = "model"):
    """The one-token write into a cache sequence-sharded on ``axis``: the
    rank at coordinate ``r`` holds positions ``[r * S_local, (r + 1) *
    S_local)``, and only the rank that owns a row's position (clamped to
    the whole cache's last, as ``cache_update``) writes it."""
    s_local = kc.shape[1]
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = (pos.long().clamp(0, s_local * n - 1)
           - mesh.get_local_rank(axis) * s_local)
    own = ((idx >= 0) & (idx < s_local))[:, None, None]
    slot = idx.clamp(0, s_local - 1)
    rows = torch.arange(kc.shape[0], device=kc.device)
    for cache, new in ((kc, k), (vc, v)):
        cache[rows, slot] = torch.where(own, new[:, 0].to(cache.dtype),
                                        cache[rows, slot])


def _attn_block_decode(p, cfg: ModelConfig, x, kc, vc, pos, *,
                       xk=None, xv=None, uniform_pos: bool = False,
                       cp_mesh=None, sharded=None, collectives=None):
    """One-token attention block.  x (B,1,D); kc/vc (B,KL,K,hd), written
    in place; pos (B,).  ``xk``/``xv`` (B,enc_seq,K,hd): an
    encoder-decoder layer's cross KV, read whole, never written.
    ``cp_mesh``: kc/vc are this rank's block of a cache sequence-sharded
    on ``model`` (a dense, not a ring, cache)."""
    kl = kc.shape[1]
    ring = bool(cfg.swa_window) or cfg.family == "hybrid"
    h = _attn_in(sharded, layers.norm_apply(p["norm1"], x, cfg.norm_eps))
    q, k, v = attention.qkv_proj(p["attn"], cfg, h)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    if ring:
        attention.cache_update_ring(kc, vc, k, v, pos)
        att = attention.attend_decode_swa(q, kc, vc, pos,
                                          cfg.swa_window or kl)
    elif cp_mesh is not None:
        _cache_update_cp(kc, vc, k, v, pos[:1].expand_as(pos)
                         if uniform_pos else pos, cp_mesh)
        att = attention.attend_decode_cp(q, kc, vc, pos + 1, cp_mesh,
                                         collectives=collectives)
    else:
        if uniform_pos:
            attention.cache_update_uniform(kc, vc, k, v, pos[0])
        else:
            attention.cache_update(kc, vc, k, v, pos)
        att = attention.attend_decode(q, kc, vc, pos + 1)
    x = x + _attn_out(sharded, attention.out_proj(p["attn"], cfg, att))
    if xk is not None:
        hx = _attn_in(sharded, layers.norm_apply(p["norm_x"], x,
                                                 cfg.norm_eps))
        b = hx.shape[0]
        qx = (hx @ p["xattn"]["wq"].to(hx.dtype)).reshape(
            b, 1, cfg.n_heads, cfg.resolved_head_dim)
        ax = attention.attend_decode(
            qx, xk, xv, torch.full((b,), xk.shape[1], device=hx.device))
        x = x + _attn_out(sharded, attention.out_proj(p["xattn"], cfg, ax))
    h = layers.norm_apply(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p["ffn"], cfg, h, sharded)[0]


def _mamba_block_decode(p, cfg: ModelConfig, x, cache):
    h = layers.norm_apply(p["norm"], x, cfg.norm_eps)
    out, cache = ssm.mamba_decode(p["mamba"], cfg, h, cache)
    return x + out, cache


def _embed_tokens_decode(params, cfg: ModelConfig, tokens, pos):
    """Token embeddings, plus for an absolute-position model (whisper)
    the sinusoidal embedding of each row's own position ``pos`` (B,)."""
    x = layers.embed_lookup(params["embed"], tokens.long())
    if cfg.pos_embed == "absolute":
        pe = layers.sinusoidal_at(torch.as_tensor(pos, device=x.device),
                                  cfg.d_model)
        x = x + pe[:, None].to(x.dtype)
    return x


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict, tokens, pos, *,
                fused_attention: bool = False, uniform_pos: bool = False,
                cp_mesh=None, sharded=None, collectives=None):
    """One decode step.  tokens (B,1) integer; pos (B,) current positions
    (unused by a mamba model).  ``uniform_pos``: every row writes at
    ``pos[0]`` (static-batch decode; a hybrid's ring ignores it, as the
    reference's does).  ``fused_attention`` is kept for signature parity:
    the decode attention is the plain einsum on both devices.

    ``cp_mesh``: context-parallel decode (the reference's
    ``launch/steps.py`` passes it when the cache is sequence-sharded on
    ``model``).  ``cache``'s dense KV is then this rank's block of
    positions, the new token is written only by the rank that owns its
    position, and attention is ``attention.attend_decode_cp`` (its
    reductions through ``collectives``, a fresh service when None).  A
    ring cache (sliding window, hybrid) ignores it, as the reference's
    does.  ``sharded``: this rank's share of a mesh's compute (the module's
    docstring).

    Returns (logits (B,V) float32, cache).  The cache is updated in place
    and returned: the port's form of the reference's donated cache.  An
    encoder-decoder's ``xk``/``xv`` are read by every layer's
    cross-attention and carried unchanged."""
    if cfg.per_layer_pattern:
        _not_served(cfg)
    x = _embed_tokens_decode(params, cfg, tokens, pos)
    if not _uniform(cfg):
        x = _hybrid_decode(params, cfg, cache, x,
                           torch.as_tensor(pos, device=x.device).long(),
                           sharded)
    elif cfg.block_pattern[0] == "mamba":
        mc = cache["mamba"]
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, new = _mamba_block_decode(
                lp, cfg, x, {"conv": mc["conv"][i], "ssm": mc["ssm"][i]})
            mc["conv"][i].copy_(new["conv"])
            mc["ssm"][i].copy_(new["ssm"])
    else:
        pos = torch.as_tensor(pos, device=x.device).long()
        cross = cfg.n_encoder_layers > 0
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x = _attn_block_decode(
                lp, cfg, x, cache["k"][i], cache["v"][i], pos,
                xk=cache["xk"][i] if cross else None,
                xv=cache["xv"][i] if cross else None,
                uniform_pos=uniform_pos, cp_mesh=cp_mesh, sharded=sharded,
                collectives=collectives)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], cache


def _hybrid_decode(params, cfg: ModelConfig, cache, x, pos, sharded=None):
    """One token through every cycle: the mamba slots update their
    (cycle, slot) states in place, the shared block its cycle's ring."""
    nc = _n_cycles(cfg)
    slots = [_unstack(sp, nc) for sp in params["slots"]]
    mc = cache["mamba"]
    for c in range(nc):
        si = 0
        for kind in cfg.block_pattern:
            if kind == "shared_attn":
                x = _attn_block_decode(params["shared_attn"], cfg, x,
                                       cache["k"][c], cache["v"][c], pos,
                                       sharded=sharded)
            else:
                x, new = _mamba_block_decode(
                    slots[si][c], cfg, x,
                    {"conv": mc["conv"][c, si], "ssm": mc["ssm"][c, si]})
                mc["conv"][c, si].copy_(new["conv"])
                mc["ssm"][c, si].copy_(new["ssm"])
                si += 1
    return x


def _fill(kc, knew):
    """Write a prompt's KV ``knew`` (L,B,S,K,hd) into the cache ``kc``
    (L,B,KL,K,hd) in place: at positions 0..S-1 when it fits, else the
    last KL tokens, each at slot abs_pos % KL (the ring).  Tail row j is
    absolute position S-KL+j, so the ring is the tail rolled by
    (S-KL) % KL."""
    s_len, kl = knew.shape[2], kc.shape[2]
    if s_len <= kl:
        kc[:, :, :s_len] = knew
    else:
        kc.copy_(torch.roll(knew[:, :, s_len - kl:], (s_len - kl) % kl,
                            dims=2))
    return kc


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
            encoder_frames=None, rules: Optional[MeshRules] = None,
            cache_dtype=torch.bfloat16, fused_attention: bool = False,
            sharded=None):
    """Run the full prompt, build the decode cache, return last-token
    logits.  tokens (B, S); ``encoder_frames`` (B, enc_seq, D) for an
    encoder-decoder model.  Returns (logits (B,V) float32, cache) laid
    out as ``init_cache`` lays it out: KV in ``cache_dtype`` sized for
    ``max_len`` (or the window; a hybrid's ring of at most 4096), the
    cross KV of every frame, the mamba conv states in ``cache_dtype`` and
    SSM states float32.  ``sharded``: this rank's share of a mesh's
    compute (the module's docstring): its KV heads in the cache."""
    hidden, _, kv, (_, xkv, states) = forward(
        params, cfg, tokens, encoder_frames=encoder_frames, rules=rules,
        collect_kv=True, fused_attention=fused_attention, sharded=sharded)
    cache = {}
    if states is not None:
        cache["mamba"] = {"conv": states["conv"].to(cache_dtype),
                          "ssm": states["ssm"].float()}
    if kv is not None:
        cache.update(_kv_cache(cfg, kv[0].shape[0], tokens.shape[0],
                               max_len, cache_dtype, hidden.device))
        _fill(cache["k"], kv[0])
        _fill(cache["v"], kv[1])
    if xkv is not None:
        cache["xk"] = xkv[0].to(cache_dtype)
        cache["xv"] = xkv[1].to(cache_dtype)
    return lm_logits(params, cfg, hidden[:, -1:])[:, 0], cache
