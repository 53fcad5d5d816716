"""CUDA flash-attention backward kernels for Hopper: the wrappers.

Replace the Pallas TPU kernels ``_dq_kernel`` and ``_dkv_kernel``
(``src/repro/kernels/flash_attention/flash_attention_bwd.py:48`` and
``:97``).  With P = exp(q k^T * scale - lse) recomputed from the forward's
log-sum-exp and D = rowsum(dO * O), ``flash_attention_dq`` computes
dq = sum_k P * (dP - D) k * scale, and ``flash_attention_dkv`` computes
dv = sum_q P^T dO and dk = sum_q (P * (dP - D))^T q * scale, one block per
(k tile, KV head) looping over the group's query heads, so dk and dv need
no atomics.  The kernels are ``repro_torch/csrc/flash_attention_bwd.cu``.

What bounds them on an H100: their arithmetic, ``6 * D`` (dq) and
``8 * D`` (dkv) flops for every visible (query, key) pair, over the tensor
cores' 989 TFLOP/s in bf16.  The dq kernel computes D once per row and
writes it to a float32 buffer that the dkv kernel, launched after it on
the same stream, reads.  Both kernels are picked by dtype.  bf16 runs
``fa_dq_wgmma_kernel`` and ``fa_dkv_wgmma_kernel``, whose products are
``wgmma`` on the tensor cores fed by TMA; dq rounds dS to bf16 for its
last product and dkv rounds P^T and dS^T for its last two, so their
tolerances are ``ref.bf16_dq_bound`` and ``ref.bf16_dkv_bound``.  float32
runs ``fa_dq_kernel`` and ``fa_dkv_kernel`` in float32 FMA.

These wrappers launch or raise: they never fall back to the plain version
(``ref.attention_bwd_ref``), and they do not synchronise.
``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count each kernel's launches,
``DQ_WGMMA_LAUNCHES``, ``DQ_FMA_LAUNCHES``, ``DKV_WGMMA_LAUNCHES`` and
``DKV_FMA_LAUNCHES`` the launches by kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPES, check_lse, check_qkv, is_wgmma, readable, run, strides)

DQ_LAUNCHES = 0
DQ_WGMMA_LAUNCHES = 0       # bf16: fa_dq_wgmma_kernel
DQ_FMA_LAUNCHES = 0         # float32: fa_dq_kernel
DKV_LAUNCHES = 0
DKV_WGMMA_LAUNCHES = 0      # bf16: fa_dkv_wgmma_kernel
DKV_FMA_LAUNCHES = 0        # float32: fa_dkv_kernel

_FNS = {}


def _fn(which: str):
    if which not in _FNS:
        fn = getattr(_build.load("flash_attention_bwd"),
                     f"repro_flash_attention_{which}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FNS[which] = fn
    return _FNS[which]


def _ptrs(*tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def flash_attention_dq(q, k, v, o, do, lse, *, causal: bool = True,
                       window: int = 0, sm_scale: Optional[float] = None):
    """-> (dq (B, H, Sq, D) in q's dtype and layout, delta (B, H, Sq)
    float32 = rowsum(do * o), which ``flash_attention_dkv`` takes)."""
    global DQ_LAUNCHES, DQ_WGMMA_LAUNCHES, DQ_FMA_LAUNCHES
    check_qkv("flash_attention_dq", q, k, v, o, do)
    check_lse("flash_attention_dq", lse, q)
    q, k, v, o, do = (readable(t) for t in (q, k, v, o, do))
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    if q.numel():
        DQ_LAUNCHES += 1
        if is_wgmma(q):
            DQ_WGMMA_LAUNCHES += 1
        else:
            DQ_FMA_LAUNCHES += 1
        run(_fn("dq"), q.device, _ptrs(q, k, v, o, do, lse, dq, delta),
            strides(q, k, v, o, do, dq), b, h, kh, sq, sk, d, int(causal),
            int(window), _scale(q, sm_scale), DTYPES[q.dtype])
    return dq, delta


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: int = 0, sm_scale: Optional[float] = None):
    """-> (dk, dv) (B, K, Sk, D) in k's dtype and layout."""
    global DKV_LAUNCHES, DKV_WGMMA_LAUNCHES, DKV_FMA_LAUNCHES
    check_qkv("flash_attention_dkv", q, k, v, do)
    check_lse("flash_attention_dkv", lse, q)
    check_lse("flash_attention_dkv", delta, q)
    q, k, v, do = (readable(t) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        DKV_LAUNCHES += 1
        if is_wgmma(q):
            DKV_WGMMA_LAUNCHES += 1
        else:
            DKV_FMA_LAUNCHES += 1
        run(_fn("dkv"), q.device, _ptrs(q, k, v, do, lse, delta, dk, dv),
            strides(q, k, v, do, dk, dv), b, h, kh, sq, sk, d, int(causal),
            int(window), _scale(q, sm_scale), DTYPES[q.dtype])
    else:
        dk.zero_()
        dv.zero_()
    return dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, sm_scale: Optional[float] = None):
    """q/o/do (B,H,Sq,D); k/v (B,K,Sk,D); lse (B,H,Sq) -> (dq, dk, dv):
    the dq kernel, then the dkv kernel on the same stream."""
    dq, delta = flash_attention_dq(q, k, v, o, do, lse, causal=causal,
                                   window=window, sm_scale=sm_scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                 window=window, sm_scale=sm_scale)
    return dq, dk, dv
