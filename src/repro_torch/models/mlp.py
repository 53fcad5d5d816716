"""Dense FFN: SwiGLU (llama family) or GELU MLP (whisper).

Twin of ``repro.models.mlp``: ``mlp_init`` (the reference's keys, shapes
and scales, drawn from a ``torch.Generator``), ``mlp_apply`` and
``mlp_specs``.  ``jax.nn.gelu`` defaults to the tanh approximation, so
the GELU branch uses ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.sharding import MeshRules, P


def mlp_init(gen: torch.Generator, cfg: ModelConfig, *, d_ff: int = 0,
             dtype=torch.float32):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":  # SwiGLU
        return {
            "w_gate": layers.dense_init(gen, d, f, dtype=dtype),
            "w_up": layers.dense_init(gen, d, f, dtype=dtype),
            "w_down": layers.dense_init(gen, f, d, dtype=dtype),
        }
    return {
        "w_up": layers.dense_init(gen, d, f, dtype=dtype),
        "b_up": layers.bias_init(f, dtype=dtype, device=gen.device),
        "w_down": layers.dense_init(gen, f, d, dtype=dtype),
        "b_down": layers.bias_init(d, dtype=dtype, device=gen.device),
    }


def mlp_specs(cfg: ModelConfig, rules: MeshRules, *, d_ff: int = 0) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {
            "w_gate": P(rules.fsdp(d), rules.tp(f)),
            "w_up": P(rules.fsdp(d), rules.tp(f)),
            "w_down": P(rules.tp(f), rules.fsdp(d)),
        }
    return {
        "w_up": P(rules.fsdp(d), rules.tp(f)),
        "b_up": P(rules.tp(f)),
        "w_down": P(rules.tp(f), rules.fsdp(d)),
        "b_down": P(None),
    }


def mlp_apply(params, cfg: ModelConfig, x):
    if "w_gate" in params:
        g = F.silu(x @ params["w_gate"].to(x.dtype))
        u = x @ params["w_up"].to(x.dtype)
        return (g * u) @ params["w_down"].to(x.dtype)
    h = x @ params["w_up"].to(x.dtype) + params["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ params["w_down"].to(x.dtype) + params["b_down"].to(x.dtype)
