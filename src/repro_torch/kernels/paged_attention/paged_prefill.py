"""CUDA paged prefill-attention kernel for Hopper: the wrapper.

Replaces no TPU kernel: the reference computes the attention of chunked
and batched paged prefill as plain ``jnp.einsum`` over each row's whole
gathered block table (``src/repro/serve/paged_model.py``, no
``pallas_call``), which the port ran as float32 einsums over all
``maxp * page`` positions (``ref.paged_prefill_ref``).  The kernels are in
``repro_torch/csrc/paged_prefill.cu``, built with ``nvcc`` for ``sm_90a``
at first use (:mod:`repro_torch.kernels._build`) and bound through
``ctypes``.

What bounds it on an H100: its arithmetic, ``4 * D`` flops for every
visible (query, key) pair and query head, over the tensor cores' 989
TFLOP/s in bf16; the bytes it reads (q, the visible pages once per query
head, o) are far below that line.  Each block walks only its own row's
pages, and only up to the last key its queries can see, so the keys past
a row's length and the padding rows cost nothing.  The input's dtype picks
the kernel:

* bf16: ``pp_fwd_wgmma_kernel``, ``fa_fwd_wgmma_kernel``'s design
  (``csrc/flash_attention.cu``) over paged K and V: both products on the
  tensor cores with float32 accumulators, each page streamed by TMA as its
  own box into a two-stage ring of 64-key tiles, the page ids read by the
  producer thread from the block table;
* float32: ``pp_fwd_kernel``, float32 FMA on the CUDA cores, because a
  float32 input is held to atol 2e-5, which TF32 products cannot meet.

Any head dim that is a multiple of 8 up to 128 runs, on the next built
width, with any number of query heads a KV head; a bf16 pool's page size
must be a multiple of 8 (TMA boxes of whole 16-byte-swizzled rows).  This
wrapper launches or raises: it never falls back to the plain version, and
it does not synchronise.  ``LAUNCHES`` counts all its launches,
``WGMMA_LAUNCHES`` and ``FMA_LAUNCHES`` those of each kernel, so a run can
show which kernel its main path went through.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, built_width

LAUNCHES = 0
WGMMA_LAUNCHES = 0          # bf16: pp_fwd_wgmma_kernel
FMA_LAUNCHES = 0            # float32: pp_fwd_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("paged_prefill").repro_paged_prefill
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k_pages, v_pages, tables, q_starts, q_lens):
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "tables": tables, "q_starts": q_starts, "q_lens": q_lens}
    for n, t in named.items():
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"paged_prefill: {n} is on {t.device}; every "
                             "input must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_prefill: {n} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_prefill: q dtype {q.dtype} is not float32 "
                        "or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_prefill: KV pools must have q's dtype "
                        f"{q.dtype}, got {k_pages.dtype}/{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (tables, q_starts, q_lens)):
        raise TypeError("paged_prefill: tables, q_starts and q_lens must "
                        "be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_prefill: q must be (N, T, H, D) and both "
                         "pools (P, page, K, D)")
    n, _, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if k_pages.shape[3] != d or built_width(d) is None:
        raise ValueError(f"paged_prefill: head_dim {d} (pool "
                         f"{k_pages.shape[3]}) is not a multiple of 8 up to "
                         "128")
    if kh == 0 or h % kh:
        raise ValueError(f"paged_prefill: {h} query heads do not group "
                         f"over {kh} KV heads")
    if (tables.dim() != 2 or tables.shape[0] != n or tables.shape[1] == 0
            or tuple(q_starts.shape) != (n,)
            or tuple(q_lens.shape) != (n,)):
        raise ValueError("paged_prefill: tables must be (N, maxp) with "
                         "maxp >= 1, q_starts and q_lens (N,)")
    if q.dtype == torch.bfloat16 and page % 8:
        raise ValueError(f"paged_prefill: page size {page} is not a "
                         "multiple of 8, which the bf16 kernel's page "
                         "boxes need")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_prefill: q and the pools must be 16-byte "
                         "aligned")


def paged_prefill(q, k_pages, v_pages, tables, q_starts, q_lens, *,
                  sm_scale: Optional[float] = None):
    """Causal prefill attention through page tables, on the card.

    q         (N, T, H, D)     queries at positions q_starts + arange(T)
    k/v_pages (P, page, K, D)  one layer's view of the pool
    tables    (N, maxp)        int32 physical page ids (-1 = unmapped)
    q_starts  (N,)             int32 absolute position of query 0
    q_lens    (N,)             int32 real queries of the row
    -> (N, T, H, D) in q's dtype

    Key ``j`` is visible to query ``t`` of row ``n`` iff
    ``j < q_starts[n] + q_lens[n]``, ``j <= q_starts[n] + t`` and
    ``tables[n, j // page]`` is a page of the pool; queries past
    ``q_lens[n]`` follow the same rule, and a query with no visible key
    gives exactly 0 (``ref.paged_prefill_ref``).
    """
    global LAUNCHES, WGMMA_LAUNCHES, FMA_LAUNCHES
    _check(q, k_pages, v_pages, tables, q_starts, q_lens)
    n, t, h, d = q.shape
    n_pages, page, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    if not out.numel():
        return out
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        WGMMA_LAUNCHES += 1
    else:
        FMA_LAUNCHES += 1
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    tables.data_ptr(), q_starts.data_ptr(),
                    q_lens.data_ptr(), out.data_ptr(), n, t, h, kh, d,
                    n_pages, page, tables.shape[1], scale, _DTYPES[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA error "
                           f"{err}")
    return out
