"""Plain PyTorch version of paged attention: gather pages, dense softmax.

Twin of ``repro.kernels.paged_attention.ref.paged_attention_ref``.  The CPU
path of ``ops.paged_decode`` and the yardstick the CUDA kernel is held to.
``paged_prefill_ref`` is the attention of chunked and batched paged
prefill, moved unchanged out of ``serve/paged_model.py::_prefill_layers``:
the CPU path of ``ops.paged_prefill`` and the prefill kernel's yardstick.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens, *,
                        sm_scale: Optional[float] = None):
    """Same contract as the kernel; gathers the paged KV into dense
    (B, max_len, K, D) buffers and runs exact masked attention."""
    b, h, d = q.shape
    _, page_size, kh, _ = k_pages.shape
    group = h // kh
    max_pages = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    # an unmapped entry (-1) would wrap to the last page: clamp to page 0,
    # whose scores the mask below removes, as the reference does
    safe = block_tables.long().clamp_min(0).reshape(-1)
    k = k_pages[safe].reshape(b, max_pages * page_size, kh, d)
    v = v_pages[safe].reshape(b, max_pages * page_size, kh, d)

    qf = q.reshape(b, kh, group, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * sm_scale
    pos = torch.arange(max_pages * page_size, device=q.device)[None]
    page_ok = (block_tables >= 0).repeat_interleave(page_size, dim=1)
    mask = (pos < seq_lens[:, None]) & page_ok
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    # rows with no valid position (empty batch slots) attend to nothing
    any_valid = mask.any(dim=1)
    o = torch.where(any_valid[:, None, None, None], o, 0.0)
    return o.reshape(b, h, d).to(q.dtype)


def paged_prefill_ref(q, k_pages, v_pages, tables, q_starts, q_lens, *,
                      sm_scale: Optional[float] = None):
    """Same contract as ``paged_prefill.paged_prefill``: the CPU path of
    ``ops.paged_prefill`` and the yardstick the CUDA kernel is held to.

    q (N, T, H, D) after RoPE; pages (P, page, K, D) one layer's pool
    view; tables (N, maxp) page ids (-1 = unmapped); q_starts, q_lens (N,).
    Gathers each row's whole table of ``maxp`` pages and runs exact
    causal attention in float32: key ``j`` is visible to query ``t`` of row
    ``n`` iff ``j < q_starts[n] + q_lens[n]``, ``j <= q_starts[n] + t``
    and its page is mapped; queries past ``q_lens[n]`` follow the same
    rule, and a query with no visible key gives 0.  -> (N, T, H, D) in
    q's dtype."""
    n, t, h, d = q.shape
    _, page_size, kh, _ = k_pages.shape
    g = h // kh
    maxp = tables.shape[1]
    dev = q.device
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    tables = tables.long()
    q_starts, q_lens = q_starts.long(), q_lens.long()
    ar = torch.arange(t, device=dev)
    pos = q_starts[:, None] + ar[None, :]                   # (N,T) absolute
    kv_lens = q_starts + q_lens
    kpos = torch.arange(maxp * page_size, device=dev)[None]  # (1,S)
    page_ok = (tables >= 0).repeat_interleave(page_size, dim=1)
    kv_ok = (kpos < kv_lens[:, None]) & page_ok             # (N,S)
    mask = kv_ok[:, None, :] & (kpos[:, None, :] <= pos[:, :, None])
    any_ok = mask.any(dim=-1)                               # (N,T)
    safe = tables.clamp_min(0)
    kg = k_pages[safe].reshape(n, maxp * page_size, kh, -1)
    vg = v_pages[safe].reshape(n, maxp * page_size, kh, -1)
    qf = q.reshape(n, t, kh, g, -1).float()
    s = torch.einsum("ntkgd,nskd->nkgts", qf, kg.float()) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    att = torch.einsum("nkgts,nskd->ntkgd", p, vg.float())
    att = torch.where(any_ok[:, :, None, None, None], att, 0.0)
    return att.reshape(n, t, h, -1).to(q.dtype)


# The bf16 prefill kernel's tolerance.  It rounds P to bf16 (unit roundoff
# u = 2^-9) as the register operand of O += P V, and keeps the row sum l
# of the float32 P; q, k and v are the same bf16 values in both versions.
# So each output moves by at most u * sum_j p_j |v_j| / l, the plain
# attention of |v|, and its one bf16 rounding by u |o|.  Twice u (2^-8)
# covers both with room for the float32 sums' order and exp2 against exp;
# 2e-5 is the float32 kernel's atol.
BF16_TERM = 2.0 ** -8
PREFILL_ATOL = 2e-5


def bf16_prefill_bound(q, k_pages, v_pages, tables, q_starts, q_lens, want,
                       *, sm_scale: Optional[float] = None):
    """-> float32 (N, T, H, D): the elementwise bound on |out - want| of
    the bf16 prefill kernel, ``want`` this module's float32
    ``paged_prefill_ref`` on the same (bf16) inputs."""
    rounding = paged_prefill_ref(q.float(), k_pages.float(),
                                 v_pages.float().abs(), tables, q_starts,
                                 q_lens, sm_scale=sm_scale)
    return BF16_TERM * (rounding + want.abs()) + PREFILL_ATOL
