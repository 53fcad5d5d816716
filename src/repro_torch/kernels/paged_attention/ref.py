"""Plain PyTorch version of paged attention: gather pages, dense softmax.

Twin of ``repro.kernels.paged_attention.ref.paged_attention_ref``.  The CPU
path of ``ops.paged_decode`` and the yardstick the CUDA kernel is held to.
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
