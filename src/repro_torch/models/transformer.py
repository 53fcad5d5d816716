"""Model assembly: parameter init and the LM head.

Twin of ``repro.models.transformer`` for uniform attention architectures.
``init_params`` builds the reference's key tree with the same shapes and
init scales (layers stacked on a leading L axis); the random numbers come
from a ``torch.Generator`` and differ from JAX's.  The dense-cache
``forward``/``prefill``/``decode_step``, MoE, SSM and encoder-decoder
models belong to later slices and raise here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _uniform(cfg: ModelConfig) -> bool:
    return len(cfg.block_pattern) == 1


def _is_moe_layer(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


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
    if not _uniform(cfg) or cfg.block_pattern[0] != "attn":
        raise NotImplementedError(
            f"{cfg.arch_id}: SSM and hybrid models wait for the SSM slice")
    if _is_moe_layer(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE layers wait for the MoE/SSM slice")
    if cfg.n_encoder_layers:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder models wait for a later slice")
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
