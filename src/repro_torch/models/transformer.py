"""Model assembly: parameter init, the full-sequence forward, the LM head,
the training loss and the dense-cache serving path.

Twin of ``repro.models.transformer`` for uniform architectures: dense
attention (``block_pattern == ("attn",)``) and Mamba-2
(``("mamba",)``).  ``init_params`` builds the reference's key tree with
the same shapes and init scales (layers stacked on a leading L axis); the
random numbers come from a ``torch.Generator`` and differ from JAX's.
``forward`` runs the layers in a Python loop over views of the stacked
parameters (the reference's ``lax.scan``).  Attention goes through
``attention.attend_chunked`` (the flash-attention kernels on the card),
the mamba blocks' scan through ``kernels/ssd/ops.ssd`` (the SSD kernel on
the card).  ``init_cache``, ``prefill`` and ``decode_step`` serve both
families through a dense decode cache: per-layer KV of ``max_len``
positions, or for a sliding-window model a ring of the window; a mamba
model's O(1) conv and SSM states.  ``remat`` other than ``"none"``,
hybrid, MoE and encoder-decoder models belong to later slices and raise
here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mlp, ssm


def _uniform(cfg: ModelConfig) -> bool:
    return len(cfg.block_pattern) == 1


def _is_moe_layer(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


def _check_supported(cfg: ModelConfig) -> None:
    if not _uniform(cfg) or cfg.block_pattern[0] not in ("attn", "mamba"):
        raise NotImplementedError(
            f"{cfg.arch_id}: hybrid models wait for ROADMAP queue 1 item 18")
    if _is_moe_layer(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE layers wait for the MoE/SSM slice")
    if cfg.n_encoder_layers:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder models wait for a later slice")


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _dense(gen, in_dim: int, out_dim: int, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return _normal(gen, (in_dim, out_dim), scale)


def _norm(cfg: ModelConfig):
    p = {"scale": torch.ones(cfg.d_model)}
    if cfg.act == "gelu":                     # whisper-style LayerNorm
        p["bias"] = torch.zeros(cfg.d_model)
    return p


def _attn_layer(gen, cfg: ModelConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": _dense(gen, d, h * hd), "wk": _dense(gen, d, k * hd),
            "wv": _dense(gen, d, k * hd),
            "wo": _dense(gen, h * hd, d, scale=1.0 / (h * hd) ** 0.5)}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros(h * hd), bk=torch.zeros(k * hd),
                    bv=torch.zeros(k * hd))
    f = cfg.d_ff
    if cfg.act == "silu":
        ffn = {"w_gate": _dense(gen, d, f), "w_up": _dense(gen, d, f),
               "w_down": _dense(gen, f, d)}
    else:
        ffn = {"w_up": _dense(gen, d, f), "b_up": torch.zeros(f),
               "w_down": _dense(gen, f, d), "b_down": torch.zeros(d)}
    return {"norm1": _norm(cfg), "attn": attn, "norm2": _norm(cfg),
            "ffn": ffn}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _mamba_layer(gen, cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": _norm(cfg), "mamba": ssm.mamba_init(gen, cfg)}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Parameter tree with the reference ``init_params`` key tree and
    shapes, layers stacked on a leading axis.  Draws in float32 on the
    generator's device, then casts to ``dtype`` on ``device`` (the SSM's
    ``dt_bias``, ``A_log`` and ``D`` stay float32, as in the reference)."""
    device = resolve_device(device)
    _check_supported(cfg)
    p: Dict[str, Any] = {
        "embed": {"table": _normal(generator,
                                   (cfg.padded_vocab, cfg.d_model), 0.02)},
        "final_norm": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense(generator, cfg.d_model, cfg.padded_vocab)
    layer = _mamba_layer if cfg.block_pattern[0] == "mamba" else _attn_layer
    p["layers"] = _stack([layer(generator, cfg)
                          for _ in range(cfg.n_layers)])
    return ssm.cast(p, device, dtype)


def lm_logits(params, cfg: ModelConfig, hidden):
    """hidden (..., D) -> logits (..., V) float32."""
    if cfg.tie_embeddings:
        return hidden.float() @ params["embed"]["table"].float().T
    return hidden.float() @ params["lm_head"].float()


def _unstack(tree, n: int):
    """Stacked layer tree -> n per-layer trees of views.  One ``unbind``
    per leaf, so the backward stacks each leaf's layer gradients once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


def _attn_block_fwd(p, cfg: ModelConfig, x, *, causal: bool, q_offset: int,
                    fused: bool = False):
    """Self-attention + FFN with residuals.  Returns (x, (k, v)), k after
    RoPE, for prefill cache capture."""
    h = layers.norm_apply(p["norm1"], x, cfg.norm_eps)
    q, k, v = attention.qkv_proj(p["attn"], cfg, h)
    if cfg.pos_embed == "rope":
        pos = q_offset + torch.arange(x.shape[1], device=x.device)
        q = layers.apply_rope(q, pos[None, :], cfg.rope_theta)
        k = layers.apply_rope(k, pos[None, :], cfg.rope_theta)
    att = attention.attend_chunked(q, k, v, causal=causal,
                                   window=cfg.swa_window, q_offset=0,
                                   fused=fused)
    x = x + attention.out_proj(p["attn"], cfg, att)
    h = layers.norm_apply(p["norm2"], x, cfg.norm_eps)
    return x + mlp.mlp_apply(p["ffn"], cfg, h), (k, v)


def _mamba_block_fwd(p, cfg: ModelConfig, x):
    h = layers.norm_apply(p["norm"], x, cfg.norm_eps)
    out, final_cache = ssm.mamba_apply(p["mamba"], cfg, h)
    return x + out, final_cache


def forward(params, cfg: ModelConfig, tokens, *, remat: str = "none",
            collect_kv: bool = False, compute_dtype=None,
            fused_attention: bool = False):
    """Full-sequence forward.  tokens (B, S) integer.

    Returns (hidden (B,S,D), aux_loss, kv_stack_or_None, (None, None,
    mamba_states_or_None)) as the reference does for a decoder-only model.
    ``collect_kv``: per-layer (k, v) stacked to (L, B, S, K, hd), or for a
    mamba model each layer's final {"conv" (L,B,K-1,C), "ssm" (L,B,H,P,N)
    float32} cache.  ``compute_dtype``: activation dtype (params stay
    float32 masters, weights cast at use sites); None keeps the param
    dtype.
    """
    _check_supported(cfg)
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} waits for a later slice; the port runs "
            "remat='none'")
    x = layers.embed_lookup(params["embed"], tokens.long())
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_pattern[0] == "mamba":
        states = []
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, fc = _mamba_block_fwd(lp, cfg, x)
            if collect_kv:
                states.append(fc)
        x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
        ms = ({k: torch.stack([st[k] for st in states]) for k in states[0]}
              if collect_kv else None)
        return x, aux, None, (None, None, ms)
    ks, vs = [], []
    for lp in _unstack(params["layers"], cfg.n_layers):
        x, (k, v) = _attn_block_fwd(lp, cfg, x, causal=True, q_offset=0,
                                    fused=fused_attention)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, aux, kv, (None, None, None)


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
            aux_weight: float = 0.01, compute_dtype=None,
            fused_attention: bool = False):
    """batch: {"tokens" (B,S)}.  Next-token LM loss.  Returns (total,
    {"loss", "aux_loss", "tokens"})."""
    tokens = batch["tokens"].long()
    hidden, aux, _, _ = forward(params, cfg, tokens, remat=remat,
                                compute_dtype=compute_dtype,
                                fused_attention=fused_attention)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    loss, n = xent_loss(params, cfg, hidden, labels, mask)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": n}


# ================================================================= caches
def decode_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Physical KV length: SWA archs cap at their window (ring buffer)."""
    if cfg.swa_window:
        return min(max_len, cfg.swa_window)
    if cfg.family == "hybrid":
        return min(max_len, 4096)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict:
    """Decode state, stacked on the layer axis.  An attention model:
    {"k", "v"} each (L,B,KL,K,hd) in ``dtype``, KL = ``decode_cache_len``
    (a ring of the window for a sliding-window model).  A mamba model:
    {"mamba": {"conv" (L,B,K-1,C) in ``dtype``, "ssm" (L,B,H,P,N)
    float32}}, whose size does not depend on ``max_len``."""
    _check_supported(cfg)
    device = resolve_device(device)
    if cfg.block_pattern[0] == "mamba":
        one = ssm.mamba_cache_init(cfg, batch, dtype=dtype, device=device)
        return {"mamba": {k: v.expand((cfg.n_layers,) + v.shape).clone()
                          for k, v in one.items()}}
    shape = (cfg.n_layers, batch, decode_cache_len(cfg, max_len),
             cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_block_decode(p, cfg: ModelConfig, x, kc, vc, pos, *,
                       uniform_pos: bool = False):
    """One-token attention block.  x (B,1,D); kc/vc (B,KL,K,hd), written
    in place; pos (B,)."""
    kl = kc.shape[1]
    ring = bool(cfg.swa_window) or cfg.family == "hybrid"
    h = layers.norm_apply(p["norm1"], x, cfg.norm_eps)
    q, k, v = attention.qkv_proj(p["attn"], cfg, h)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    if ring:
        attention.cache_update_ring(kc, vc, k, v, pos)
        att = attention.attend_decode_swa(q, kc, vc, pos,
                                          cfg.swa_window or kl)
    else:
        if uniform_pos:
            attention.cache_update_uniform(kc, vc, k, v, pos[0])
        else:
            attention.cache_update(kc, vc, k, v, pos)
        att = attention.attend_decode(q, kc, vc, pos + 1)
    x = x + attention.out_proj(p["attn"], cfg, att)
    h = layers.norm_apply(p["norm2"], x, cfg.norm_eps)
    return x + mlp.mlp_apply(p["ffn"], cfg, h)


def _mamba_block_decode(p, cfg: ModelConfig, x, cache):
    h = layers.norm_apply(p["norm"], x, cfg.norm_eps)
    out, cache = ssm.mamba_decode(p["mamba"], cfg, h, cache)
    return x + out, cache


def _embed_tokens_decode(params, cfg: ModelConfig, tokens, pos):
    """Token embeddings; the reference's absolute-position branch belongs
    to the encoder-decoder slice, which ``_check_supported`` refuses."""
    return layers.embed_lookup(params["embed"], tokens.long())


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict, tokens, pos, *,
                uniform_pos: bool = False, cp_mesh=None):
    """One decode step.  tokens (B,1) integer; pos (B,) current positions
    (unused by a mamba model).  ``uniform_pos``: every row writes at
    ``pos[0]`` (static-batch decode).

    Returns (logits (B,V) float32, cache).  The cache is updated in place
    and returned: the port's form of the reference's donated cache."""
    _check_supported(cfg)
    if cp_mesh is not None:
        raise NotImplementedError(
            "context-parallel decode (cp_mesh) waits for the tensor-parallel "
            "slice, ROADMAP queue 1 item 14")
    x = _embed_tokens_decode(params, cfg, tokens, pos)
    per_layer = _unstack(params["layers"], cfg.n_layers)
    if cfg.block_pattern[0] == "mamba":
        mc = cache["mamba"]
        for i, lp in enumerate(per_layer):
            x, new = _mamba_block_decode(
                lp, cfg, x, {"conv": mc["conv"][i], "ssm": mc["ssm"][i]})
            mc["conv"][i].copy_(new["conv"])
            mc["ssm"][i].copy_(new["ssm"])
    else:
        pos = torch.as_tensor(pos, device=x.device).long()
        for i, lp in enumerate(per_layer):
            x = _attn_block_decode(lp, cfg, x, cache["k"][i],
                                   cache["v"][i], pos,
                                   uniform_pos=uniform_pos)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], cache


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
            cache_dtype=torch.bfloat16):
    """Run the full prompt, build the decode cache, return last-token
    logits.  tokens (B, S).  Returns (logits (B,V) float32, cache) laid
    out as ``init_cache`` lays it out: KV in ``cache_dtype`` sized for
    ``max_len`` (or the window), or the mamba conv states in
    ``cache_dtype`` and SSM states float32."""
    _check_supported(cfg)
    hidden, _, kv, (_, _, states) = forward(params, cfg, tokens,
                                            collect_kv=True)
    if states is not None:
        cache = {"mamba": {"conv": states["conv"].to(cache_dtype),
                           "ssm": states["ssm"].float()}}
    else:
        cache = init_cache(cfg, tokens.shape[0], max_len, dtype=cache_dtype,
                           device=hidden.device)
        _fill(cache["k"], kv[0])
        _fill(cache["v"], kv[1])
    return lm_logits(params, cfg, hidden[:, -1:])[:, 0], cache
