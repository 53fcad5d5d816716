"""CUDA flash-attention forward kernels for Hopper: the wrapper.

Replace the Pallas TPU kernel ``_fa_kernel``
(``src/repro/kernels/flash_attention/flash_attention.py:36``), the
training and prefill hot spot: blockwise online-softmax attention with an
optional log-sum-exp output for the backward pass.  The kernels are in
``repro_torch/csrc/flash_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use (:mod:`repro_torch.kernels._build`) and bound
through ``ctypes``.

What bounds them on an H100: their arithmetic, ``4 * D`` flops for every
visible (query, key) pair, over the tensor cores' 989 TFLOP/s in bf16;
the bytes of q, k, v and o are far below that line.  The input's dtype
picks the kernel:

* bf16: ``fa_fwd_wgmma_kernel`` puts both products on the tensor cores
  (``wgmma``, float32 accumulators), fed by TMA copies through a two-stage
  ring of bf16 tiles in shared memory; the softmax runs in registers on
  the accumulator, P goes to the second product as a bf16 register
  operand, and only tiles that straddle a mask edge are masked.
* float32: ``fa_fwd_kernel``, float32 FMA on the CUDA cores, because a
  float32 input is held to atol 2e-5, which TF32 products cannot meet.

Any head dim that is a multiple of 8 up to 128 runs, on the next built
width (32, 64 or 128): the bf16 kernels' tensor maps give the columns past
d as zeros, the float32 kernels stage zeros there, and no column past d
is stored; the softmax scale is 1/sqrt(d) of the model's own d, or
``sm_scale`` where the caller gives one (a model's
``attention_multiplier``: every kernel multiplies its scores by the scale
it is passed).  Both keep scores out of
device memory, index the KV head as
``h // group`` without repeating KV, skip tile pairs that the causal or
window mask removes whole, and keep the softmax state in float32.  They
read every tensor through its strides (d contiguous), so the model's
(B, S, H, D) activations go in as a transposed view with no copy.  This
wrapper launches or raises: it never falls back to the plain version
(``ref.py``), and it does not synchronise.  ``LAUNCHES`` counts all its
launches, ``WGMMA_LAUNCHES`` and ``FMA_LAUNCHES`` those of each kernel,
so a run can show which kernel its main path went through.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, built_width, readable

LAUNCHES = 0
WGMMA_LAUNCHES = 0          # bf16: fa_fwd_wgmma_kernel
FMA_LAUNCHES = 0            # float32: fa_fwd_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").repro_flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def strides(*tensors) -> ctypes.Array:
    """The (b, head, s) element strides of each 4-d tensor, in order."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def check_qkv(name: str, q, k, v, *more):
    """Device, dtype and shape checks shared by the three kernels' wrappers:
    q (B, H, Sq, D), k and v (B, K, Sk, D), ``more`` shaped like q."""
    for t in (q, k, v, *more):
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"{name}: a tensor is on {t.device}; every "
                             "input must be on the same CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtypes differ ({t.dtype} vs "
                            f"{q.dtype})")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} is not float32 or "
                        "bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B, H, Sq, D) and k, v "
                         "(B, K, Sk, D)")
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or built_width(d) is None:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}, or head_dim {d} is not a "
                         "multiple of 8 up to 128")
    if kh == 0 or h % kh:
        raise ValueError(f"{name}: {h} query heads do not group over {kh} "
                         "KV heads")
    if sk == 0:
        raise ValueError(f"{name}: no keys")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} is not q's shape "
                             f"{tuple(q.shape)}")


def check_lse(name: str, lse, q):
    b, h, sq, _ = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be a contiguous float32 "
                         f"(B, H, Sq) = {(b, h, sq)} tensor on {q.device}")


def is_wgmma(t: torch.Tensor) -> bool:
    """Whether the tensor-core (bf16) kernels take ``t``, not the float32
    FMA ones."""
    return t.dtype == torch.bfloat16


def run(fn, device, *args) -> None:
    """Call one C entry with the current stream of ``device`` appended;
    raise on a non-zero CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Flash-attention forward on the card.

    q (B, H, Sq, D); k, v (B, K, Sk, D) -> o (B, H, Sq, D) in q's dtype
    and layout, and with ``return_lse`` also lse (B, H, Sq) float32.
    H must be a multiple of K (GQA)."""
    global LAUNCHES, WGMMA_LAUNCHES, FMA_LAUNCHES
    check_qkv("flash_attention", q, k, v)
    q, k, v = readable(q), readable(k), readable(v)
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel():
        scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
        LAUNCHES += 1
        if is_wgmma(q):
            WGMMA_LAUNCHES += 1
        else:
            FMA_LAUNCHES += 1
        run(_fn(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            strides(q, k, v, o), b, h, kh, sq, sk, d, int(causal),
            int(window), scale, DTYPES[q.dtype])
    return (o, lse) if return_lse else o
