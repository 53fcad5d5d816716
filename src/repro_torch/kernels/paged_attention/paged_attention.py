"""CUDA paged-attention decode kernel for Hopper: the wrapper.

Replaces the Pallas TPU kernel ``_pa_kernel``
(``src/repro/kernels/paged_attention/paged_attention.py:47``), the MMU
service's datapath: decode attention that reads KV through the page
tables.  The kernel is ``pa_decode_kernel`` in
``repro_torch/csrc/paged_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use (:mod:`repro_torch.kernels._build`) and bound
through ``ctypes``.

What bounds it on an H100: the bytes of K and V it must read,
``sum_b lens[b] * K * D * 2 * sizeof(dtype)``, over 3.35 TB/s; its
arithmetic (``4 * H * D`` flops per cached token) is far below any compute
line, so the kernel is built to keep bytes in flight: one block per (row,
KV head, run of ``pages_per_split`` pages) holds all the group's query
heads, stages the split's table slice in shared memory, streams tiles of
``TILE`` tokens through a ring of ``stages`` slots with 16-byte
``cp.async`` copies, and scores each token with a group of lanes that
each hold 16 bytes of q and k.  Any head dim that is a multiple of 8 up to
128 runs, on the next built width (32, 64, 128); the rest raise.  Both
dtypes run the same kernel (float32 for the parity checks).

:func:`plan` picks the split from shapes alone (no device -> host read):
runs of at least ``MIN_TILES_PER_SPLIT`` tiles, and enough of them for
about ``BLOCKS_PER_SM`` blocks per SM.  The last block of each row to
finish merges the row's splits in the same launch; its int32 arrival
counters and the float32 workspace of partial states live in one
per-(device, stream) buffer pair, reused from call to call (each launch
leaves the counters at zero).

This wrapper launches or raises: it never falls back to the plain version
(``ref.py``), and it does not synchronise.  ``LAUNCHES`` counts the
launches of ``pa_decode_kernel``, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, built_width

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                      # tokens per ring slot (csrc kTile)
MIN_TILES_PER_SPLIT = 4
MAX_SPLIT_PAGES = 1024         # csrc kMaxSplitPages
MAX_STAGES = 6                 # csrc kMaxStages
BLOCKS_PER_SM = 4
STAGES = 2                     # ring slots; deeper measured no faster
_FN = None
_SMS = {}
_SCRATCH = {}                  # (device, stream) -> (workspace, counters)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("paged_attention").repro_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p] + [i] * 10 + [
            ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def heads_per_block(h: int, kh: int, bf16: bool = True) -> int:
    """Query heads one block holds (csrc GB): 4 for bf16 with a group of at
    most 4, else 8; a larger group takes several blocks."""
    return 4 if bf16 and h // kh <= 4 else 8


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, kh: int, maxp: int, page: int, sms: int) -> int:
    """Pages per split for a (B, H, K) batch over ``maxp``-page rows.

    Each split is a run of at least ``MIN_TILES_PER_SPLIT`` tiles of
    ``TILE`` tokens, so its ring has tiles to keep in flight, and the runs
    are short enough for about ``BLOCKS_PER_SM`` blocks on each of the
    ``sms`` SMs; at most ``MAX_SPLIT_PAGES``.  The grid is (B, K x head
    blocks, ceil(maxp / pages_per_split)): every page of a row falls in
    exactly one split, and the last split starts before ``maxp``."""
    blocks = b * kh * -(-(h // kh) // heads_per_block(h, kh))
    want = -(-BLOCKS_PER_SM * sms // blocks)          # splits per row
    least = -(-MIN_TILES_PER_SPLIT * TILE // page)
    return min(maxp, MAX_SPLIT_PAGES, max(least, -(-maxp // want)))


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _scratch(device, stream: int, n_ws: int, n_cnt: int):
    """The workspace and arrival counters of launches on ``stream``, grown
    when a launch needs more; the counters are zeroed once and each
    launch leaves them at zero."""
    ws, cnt = _SCRATCH.get((device, stream), (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros(n_cnt, dtype=torch.int32, device=device)
    _SCRATCH[(device, stream)] = (ws, cnt)
    return ws, cnt


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
        raise ValueError("paged_attention: block_tables and seq_lens must "
                         "be (B, maxp) with maxp >= 1 and (B,)")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned (16-byte copies)")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale: Optional[float] = None,
                    pages_per_split: Optional[int] = None,
                    stages: Optional[int] = None):
    """Decode attention through page tables, on the card.

    q            (B, H, D)         one new token per sequence
    k/v_pages    (P, page, K, D)   the pool (or one layer's view of it)
    block_tables (B, max_pages)    int32 physical page ids (-1 = unmapped)
    seq_lens     (B,)              int32 valid tokens per sequence
    -> (B, H, D) in q's dtype

    ``pages_per_split`` and ``stages`` (1..6) override :func:`plan` and
    ``STAGES``, for measuring them.
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
    pps = pages_per_split or plan(b, h, kh, maxp, page, _sms(q.device))
    if not 1 <= pps <= MAX_SPLIT_PAGES:
        raise ValueError(f"paged_attention: pages_per_split {pps} is not in "
                         f"1..{MAX_SPLIT_PAGES}")
    stages = stages or STAGES
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"paged_attention: stages {stages} is not in "
                         f"1..{MAX_STAGES}")
    splits = -(-maxp // pps)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = cnt = None
        if splits > 1:
            blocks = kh * -(-(h // kh) // heads_per_block(
                h, kh, q.dtype == torch.bfloat16))
            ws, cnt = _scratch(q.device, stream, b * h * splits * (d + 2),
                               b * blocks)
        LAUNCHES += 1
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if cnt is None else cnt.data_ptr(),
                 b, h, kh, d, n_pages, page, maxp, pps, splits, stages,
                 scale, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
