"""Plain PyTorch versions of flash attention, forward and backward.

Twin of ``repro.kernels.flash_attention.ref.attention_ref``; the backward
writes out the kernels' own formulas (``flash_attention_bwd.py``'s dq and
dkv kernels) instead of differentiating the forward.  These are the CPU
path of ``ops.mha`` and ``ops.mha_fused`` and the yardstick the CUDA
kernels are held to.  Everything is computed in float32; masked scores
are the finite ``NEG_INF``, so ``exp(s - lse)`` is 0 there, not NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool, window: int, sm_scale: float):
    """q (B,H,Sq,D), k (B,K,Sk,D) -> masked float32 scores (B,K,G,Sq,Sk)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kh, h // kh, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask, s, NEG_INF)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  sm_scale: Optional[float] = None):
    """q (B, H, Sq, D); k, v (B, K, Sk, D) -> (o (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) float32).  Exact softmax attention with GQA and
    optional causal / sliding-window masking."""
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, window, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]
    return o.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int = 0, sm_scale: Optional[float] = None):
    """q/o/do (B,H,Sq,D); k/v (B,K,Sk,D); lse (B,H,Sq) -> (dq, dk, dv) in
    the dtypes of q, k and v.  P = exp(s - lse), D = rowsum(do * o),
    dS = P * (dP - D): dq = dS k * scale, dk = dS^T q * scale (summed over
    the group's query heads), dv = P^T do (likewise)."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    g = h // kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, window, sm_scale)
    p = torch.exp(s - lse.float().reshape(b, kh, g, sq, 1))
    qf = q.float().reshape(b, kh, g, sq, d)
    dof = do.float().reshape(b, kh, g, sq, d)
    dcap = (dof * o.float().reshape(b, kh, g, sq, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, v.float())
    ds = p * (dp - dcap)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * sm_scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * sm_scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
