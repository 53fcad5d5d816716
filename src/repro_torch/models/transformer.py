"""Model assembly: parameter init, the full-sequence forward, the LM head
and the training loss.

Twin of ``repro.models.transformer`` for uniform dense attention
architectures.  ``init_params`` builds the reference's key tree with the
same shapes and init scales (layers stacked on a leading L axis); the
random numbers come from a ``torch.Generator`` and differ from JAX's.
``forward`` runs the layers in a Python loop over views of the stacked
parameters (the reference's ``lax.scan``), and its attention goes through
``attention.attend_chunked``: the flash-attention kernels on the card.
The dense-cache ``prefill``/``decode_step``, ``remat`` other than
``"none"``, MoE, SSM and encoder-decoder models belong to later slices and
raise here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mlp


def _uniform(cfg: ModelConfig) -> bool:
    return len(cfg.block_pattern) == 1


def _is_moe_layer(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


def _check_supported(cfg: ModelConfig) -> None:
    if not _uniform(cfg) or cfg.block_pattern[0] != "attn":
        raise NotImplementedError(
            f"{cfg.arch_id}: SSM and hybrid models wait for the SSM slice")
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


def _to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Parameter tree with the reference ``init_params`` key tree and
    shapes, layers stacked on a leading axis.  Draws in float32 on the
    generator's device, then casts to ``dtype`` on ``device``."""
    device = resolve_device(device)
    _check_supported(cfg)
    p: Dict[str, Any] = {
        "embed": {"table": _normal(generator,
                                   (cfg.padded_vocab, cfg.d_model), 0.02)},
        "final_norm": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense(generator, cfg.d_model, cfg.padded_vocab)
    p["layers"] = _stack([_attn_layer(generator, cfg)
                          for _ in range(cfg.n_layers)])
    return _to(p, device, dtype)


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


def forward(params, cfg: ModelConfig, tokens, *, remat: str = "none",
            collect_kv: bool = False, compute_dtype=None,
            fused_attention: bool = False):
    """Full-sequence forward.  tokens (B, S) integer.

    Returns (hidden (B,S,D), aux_loss, kv_stack_or_None, (None, None,
    None)) as the reference does for a dense decoder.  ``collect_kv``:
    per-layer (k, v) stacked to (L, B, S, K, hd).  ``compute_dtype``:
    activation dtype (params stay float32 masters, weights cast at use
    sites); None keeps the param dtype.
    """
    _check_supported(cfg)
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} waits for a later slice; the port runs "
            "remat='none'")
    x = layers.embed_lookup(params["embed"], tokens.long())
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    ks, vs = [], []
    for lp in _unstack(params["layers"], cfg.n_layers):
        x, (k, v) = _attn_block_fwd(lp, cfg, x, causal=True, q_offset=0,
                                    fused=fused_attention)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
