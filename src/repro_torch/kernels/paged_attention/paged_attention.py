"""CUDA paged-attention decode kernel for Hopper: the wrapper.

Replaces the Pallas TPU kernel ``_pa_kernel``
(``src/repro/kernels/paged_attention/paged_attention.py:47``), the MMU
service's datapath: decode attention that reads KV through the page
tables.  The kernel is ``repro_torch/csrc/paged_attention.cu``, built with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels._build`)
and bound through ``ctypes``.

What bounds it on an H100: the bytes of K and V it must read,
``sum_b lens[b] * K * D * 2 * sizeof(dtype)``, over 3.35 TB/s; its
arithmetic (``4 * H * D`` flops per cached token) is far below the
tensor-core line.  The design reads each valid page once per (row, KV
head, split) block and shares it across the ``H // K`` query heads of the
group, skips unmapped (-1) pages without touching them, and keeps the
online softmax state in float32 registers.  Any head dim that is a
multiple of 8 up to 128 runs, on the next built width (32, 64, 128) with
a masked tail; the rest raise.  A row's pages are split over
enough blocks to put about ``BLOCKS_PER_SM`` blocks on every SM
(flash-decoding); a second kernel combines the splits' partial softmax
states from a float32 workspace.  Vector loads and cp.async/TMA
pipelining are later work.

This wrapper launches or raises: it never falls back to the plain version
(``ref.py``), and it does not synchronise.  ``LAUNCHES`` counts its
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, built_width

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 4
_WARPS = 4                     # query heads per block (csrc kWarps)
_FN = None
_SMS = {}


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("paged_attention").repro_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def n_splits(device, b: int, h: int, kh: int, maxp: int) -> int:
    """Blocks each row's pages are divided over: enough for about
    ``BLOCKS_PER_SM`` blocks per SM, at most one page per split.  Decided
    from shapes alone, so it needs no device -> host read."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    g = h // kh
    blocks = b * kh * -(-g // min(g, _WARPS))
    want = -(-BLOCKS_PER_SM * _SMS[device] // blocks)
    per = -(-maxp // max(1, min(want, maxp)))        # pages per split
    return -(-maxp // per)


def _check(q, k_pages, v_pages, block_tables, seq_lens):
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "block_tables": block_tables, "seq_lens": seq_lens}
    for n, t in named.items():
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"paged_attention: {n} is on {t.device}; every "
                             "input must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {n} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: q dtype {q.dtype} is not "
                        "float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: KV pools must have q's dtype "
                        f"{q.dtype}, got {k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and seq_lens must "
                        "be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_attention: q must be (B, H, D) and both "
                         "pools (P, page, K, D)")
    b, h, d = q.shape
    kh = k_pages.shape[2]
    if k_pages.shape[3] != d or built_width(d) is None:
        raise ValueError(f"paged_attention: head_dim {d} (pool "
                         f"{k_pages.shape[3]}) is not a multiple of 8 up to "
                         "128")
    if kh == 0 or h % kh:
        raise ValueError(f"paged_attention: {h} query heads do not group "
                         f"over {kh} KV heads")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.shape[1] == 0 or tuple(seq_lens.shape) != (b,)):
        raise ValueError("paged_attention: block_tables must be (B, maxp) "
                         "with maxp >= 1 and seq_lens (B,)")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale: Optional[float] = None):
    """Decode attention through page tables, on the card.

    q            (B, H, D)         one new token per sequence
    k/v_pages    (P, page, K, D)   the pool (or one layer's view of it)
    block_tables (B, max_pages)    int32 physical page ids (-1 = unmapped)
    seq_lens     (B,)              int32 valid tokens per sequence
    -> (B, H, D) in q's dtype
    """
    global LAUNCHES
    _check(q, k_pages, v_pages, block_tables, seq_lens)
    b, h, d = q.shape
    n_pages, page, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    maxp = block_tables.shape[1]
    splits = n_splits(q.device, b, h, kh, maxp)
    ws = torch.empty(b * h * splits * (d + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr() if splits > 1 else None,
                 b, h, kh, d, n_pages, page, maxp, splits, scale,
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
