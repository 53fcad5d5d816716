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


def _bwd_terms(q, k, v, o, do, lse, causal, window, sm_scale):
    """P and dS (B, K, G, Sq, Sk) and q, do as (B, K, G, Sq, D), float32."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    g = h // kh
    s = _scores(q, k, causal, window, sm_scale)
    p = torch.exp(s - lse.float().reshape(b, kh, g, sq, 1))
    qf = q.float().reshape(b, kh, g, sq, d)
    dof = do.float().reshape(b, kh, g, sq, d)
    dcap = (dof * o.float().reshape(b, kh, g, sq, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, v.float())
    return p, p * (dp - dcap), qf, dof


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int = 0, sm_scale: Optional[float] = None):
    """q/o/do (B,H,Sq,D); k/v (B,K,Sk,D); lse (B,H,Sq) -> (dq, dk, dv) in
    the dtypes of q, k and v.  P = exp(s - lse), D = rowsum(do * o),
    dS = P * (dP - D): dq = dS k * scale, dk = dS^T q * scale (summed over
    the group's query heads), dv = P^T do (likewise)."""
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    p, ds, qf, dof = _bwd_terms(q, k, v, o, do, lse, causal, window,
                                sm_scale)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * sm_scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * sm_scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# The bf16 backward kernels' tolerances.  They round P^T and dS^T (dkv)
# and dS (dq) to bf16 (unit roundoff u = 2^-9) as the register operands of
# dV += P^T dO, dK += dS^T q and dq += dS k, as every tensor-core flash
# backward does; q, k and dO are the same bf16 values in both versions.
# So each term of dv moves by at most u * P |dO|, each term of dk by
# u * scale * |dS| |q| and each term of dq by u * scale * |dS| |k|, in all
#   |dv - ref| <= u P^T |dO|,   |dk - ref| <= u scale |dS|^T |q|,
#   |dq - ref| <= u scale |dS| |k|.
# Twice u (2^-8) covers that rounding with room for the float32 sums'
# order and exp2 against exp; 2^-8 |ref| covers the one bf16 rounding of
# the stored gradient (u of its value); 5e-4 is the float32 gradients'
# atol (the reference's backward tests).
GRAD_ATOL = 5e-4
BF16_TERM = 2.0 ** -8


def _scale_of(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def bf16_dkv_bound(q, k, v, o, do, lse, *, causal: bool = True,
                   window: int = 0, sm_scale: Optional[float] = None):
    """-> (dk bound, dv bound), float32 (B, K, Sk, D): the elementwise
    bounds on |dk - ref| and |dv - ref| of the bf16 dkv kernel, where ref is
    this module's float32 plain version on the same (bf16) inputs."""
    sm_scale = _scale_of(q, sm_scale)
    p, ds, qf, dof = _bwd_terms(q, k, v, o, do, lse, causal, window,
                                sm_scale)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * sm_scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dk_rounding = torch.einsum("bkgqs,bkgqd->bksd", ds.abs(), qf.abs())
    dv_rounding = torch.einsum("bkgqs,bkgqd->bksd", p, dof.abs())
    return (BF16_TERM * (sm_scale * dk_rounding + dk.abs()) + GRAD_ATOL,
            BF16_TERM * (dv_rounding + dv.abs()) + GRAD_ATOL)


def bf16_dq_bound(q, k, v, o, do, lse, *, causal: bool = True,
                  window: int = 0, sm_scale: Optional[float] = None):
    """-> float32 (B, H, Sq, D): the elementwise bound on |dq - ref| of the
    bf16 dq kernel, ref as for ``bf16_dkv_bound``."""
    b, h, sq, d = q.shape
    sm_scale = _scale_of(q, sm_scale)
    _, ds, _, _ = _bwd_terms(q, k, v, o, do, lse, causal, window, sm_scale)
    kf = k.float()
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * sm_scale
    rounding = torch.einsum("bkgqs,bksd->bkgqd", ds.abs(), kf.abs())
    bound = BF16_TERM * (sm_scale * rounding + dq.abs()) + GRAD_ATOL
    return bound.reshape(b, h, sq, d)
