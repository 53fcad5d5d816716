"""Base layers: dense, norm and embedding inits, norms, rotary and
sinusoidal embeddings, embedding lookup.

Twin of ``repro.models.layers``.  The ``*_init`` functions take a
``torch.Generator`` where the reference takes a JAX key, draw float32 on
the generator's device and cast to ``dtype``; shapes and scales are the
reference's, the random numbers are not (no threefry).  Norms upcast to
float32 and cast back; RoPE uses the split-half convention (first half /
second half of the head dimension rotate together), not the interleaved
one.  ``norm_specs`` and ``embed_specs`` give the matching partition
specs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.sharding import MeshRules, P


# ---------------------------------------------------------------- dense ----
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (torch.randn(in_dim, out_dim, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def bias_init(dim: int, *, dtype=torch.float32, device=None):
    return torch.zeros(dim, dtype=dtype, device=device)


# ---------------------------------------------------------------- norms ----
def rmsnorm_init(dim: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def layernorm_init(dim: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dtype)


def norm_apply(params, x, eps: float = 1e-5):
    if "bias" in params:
        return layernorm(params, x, eps)
    return rmsnorm(params, x, eps)


def norm_specs(params_like: dict) -> dict:
    return {k: P(None) for k in params_like}


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with even D; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)            # (D/2,)
    ang = positions[..., None].float() * inv                # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(pos, dim: int):
    """Whisper-style sinusoidal embeddings of the positions ``pos`` (N,)
    as (N, dim) float32: the sines of every frequency, then the cosines."""
    pos = torch.as_tensor(pos)
    inv = 1.0 / (10_000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                           device=pos.device) / dim))
    ang = pos.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n_pos: int, dim: int, device=None):
    """``sinusoidal_at`` of positions 0 .. n_pos - 1: (n_pos, dim) float32."""
    return sinusoidal_at(torch.arange(n_pos, dtype=torch.float32,
                                      device=device), dim)


# ------------------------------------------------------------ embedding ----
def embed_init(gen: torch.Generator, vocab: int, dim: int, *,
               dtype=torch.float32):
    return {"table": (torch.randn(vocab, dim, generator=gen,
                                  device=gen.device, dtype=torch.float32)
                      * 0.02).to(dtype)}


def embed_lookup(params, ids):
    return params["table"][ids]


def embed_specs(rules: MeshRules, vocab: int, d_model: int) -> dict:
    # vocab rows FSDP-sharded + D on model when divisible
    return {"table": P(rules.fsdp(vocab), rules.tp(d_model))}
