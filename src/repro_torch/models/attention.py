"""Attention projections (GQA), in the reference's ``x @ W`` layout.

Twin of ``repro.models.attention``'s ``qkv_proj``/``out_proj``.  The
dense-cache ``attend_*`` paths belong to a later slice; the paged serving
path attends through ``repro_torch.serve.paged_model`` and the
paged-attention kernel.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


def qkv_proj(params, cfg: ModelConfig, x):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,K,hd)."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def out_proj(params, cfg: ModelConfig, att):
    b, s = att.shape[:2]
    return att.reshape(b, s, -1) @ params["wo"].to(att.dtype)
