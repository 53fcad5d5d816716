"""Dispatch for paged attention, on the tensor's device.

``paged_decode`` is the twin of
``repro.kernels.paged_attention.ops.paged_decode``; ``paged_prefill`` has
no twin there (the reference's paged prefill attends in plain einsums).  A
CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version; any other device raises.
There is no flag to pick the plain version on the card.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention
from repro_torch.kernels.paged_attention.paged_prefill import \
    paged_prefill as paged_prefill_kernel
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_prefill_ref)


def paged_decode(q, k_pages, v_pages, block_tables, seq_lens, *,
                 sm_scale=None):
    """q (B, H, D); pages (P, page, K, D); tables (B, maxp); lens (B,)."""
    if q.device.type == "cuda":
        return paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                               sm_scale=sm_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale=sm_scale)
    raise ValueError(f"paged_decode: no kernel for device {q.device}")


def paged_prefill(q, k_pages, v_pages, tables, q_starts, q_lens, *,
                  sm_scale=None):
    """q (N, T, H, D); pages (P, page, K, D); tables (N, maxp); q_starts,
    q_lens (N,): causal attention of each row's queries over its own
    pages (``ref.paged_prefill_ref``'s rule)."""
    if q.device.type == "cuda":
        return paged_prefill_kernel(q, k_pages, v_pages, tables, q_starts,
                                    q_lens, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pages, v_pages, tables, q_starts,
                                 q_lens, sm_scale=sm_scale)
    raise ValueError(f"paged_prefill: no kernel for device {q.device}")
