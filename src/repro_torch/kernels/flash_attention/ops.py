"""Dispatch for flash attention, on the tensor's device.

Twin of ``repro.kernels.flash_attention.ops``.  ``mha`` takes the model's
(B, S, H, D) layout; ``mha_fused`` is the differentiable op in the
kernels' (B, H, S, D) layout, a ``torch.autograd.Function`` whose forward
saves (q, k, v, o, lse) and whose backward runs the dq and dkv kernels.
A CUDA tensor goes to the hand-written kernels, which launch or raise; a
CPU tensor goes to the plain PyTorch versions; any other device raises.
There is no flag to pick the plain version on the card.  ``mha_fused``'s
``scale`` is the softmax scale of both, 1/sqrt(D) when None.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.flash_attention_bwd import \
    flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention: no kernel for device {t.device}")


def mha(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, D); k, v (B, Sk, K, D) -> (B, Sq, H, D)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if _on_card(q):
        ot = flash_attention(qt, kt, vt, causal=causal, window=window)
    else:
        ot, _ = attention_ref(qt, kt, vt, causal=causal, window=window)
    return ot.transpose(1, 2)


class _MhaFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale):
        if _on_card(q):
            o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                     sm_scale=scale, return_lse=True)
        else:
            o, lse = attention_ref(q, k, v, causal=causal, window=window,
                                   sm_scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if _on_card(q) else attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, do, lse, causal=ctx.causal,
                         window=ctx.window, sm_scale=ctx.scale)
        return dq, dk, dv, None, None, None


def mha_fused(q, k, v, causal: bool = True, window: int = 0,
              scale: Optional[float] = None):
    """Differentiable fused attention: forward kernel, dq and dkv kernels.
    Layout (B, H, S, D); k, v may have fewer (KV) heads than q."""
    return _MhaFused.apply(q, k, v, causal, window, scale)
