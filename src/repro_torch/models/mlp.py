"""Dense FFN: SwiGLU (llama family) or GELU MLP (whisper).

Twin of ``repro.models.mlp.mlp_apply``.  ``jax.nn.gelu`` defaults to the
tanh approximation, so the GELU branch uses ``approximate="tanh"``.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def mlp_apply(params, cfg: ModelConfig, x):
    if "w_gate" in params:
        g = F.silu(x @ params["w_gate"].to(x.dtype))
        u = x @ params["w_up"].to(x.dtype)
        return (g * u) @ params["w_down"].to(x.dtype)
    h = x @ params["w_up"].to(x.dtype) + params["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ params["w_down"].to(x.dtype) + params["b_down"].to(x.dtype)
