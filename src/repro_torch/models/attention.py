"""Attention: GQA projections (the reference's ``x @ W`` layout) and the
full-sequence ``attend_chunked``.

Twin of ``repro.models.attention``'s ``qkv_proj``, ``out_proj`` and
``attend_chunked``.  The reference documents ``attend_chunked(fused=True)``
as the region that executes as the flash-attention kernel on the TPU; here
a CUDA tensor always takes the hand-written kernels through
``ops.mha_fused``, and a CPU tensor the reference's query-chunked exact
softmax.  The dense-cache ``attend_decode*`` paths belong to a later slice;
the paged serving path attends through ``repro_torch.serve.paged_model``
and the paged-attention kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops

NEG_INF = -1e30


def qkv_proj(params, cfg: ModelConfig, x):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,K,hd)."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def out_proj(params, cfg: ModelConfig, att):
    b, s = att.shape[:2]
    return att.reshape(b, s, -1) @ params["wo"].to(att.dtype)


def attend_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, chunk: int = 512,
                   fused: bool = False):
    """Exact attention.  q (B,Sq,H,hd); k,v (B,Sk,K,hd) -> (B,Sq,H,hd).

    ``q_offset``: absolute position of q[0] relative to k[0].  ``window``
    > 0 applies a sliding window.  On the card: the flash-attention
    kernels, which take ``q_offset`` 0 (what every caller on the training
    path passes).  On the CPU: query chunks of ``chunk`` rows, each an
    exact masked softmax over all keys.  ``fused`` is kept for signature
    parity with the reference: the device alone picks the path.
    """
    if q.device.type == "cuda":
        if q_offset:
            raise NotImplementedError(
                "attend_chunked on the card: the flash-attention kernels "
                "take q_offset 0")
        o = ops.mha_fused(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, window)
        return o.transpose(1, 2)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    scale = hd ** -0.5
    chunk = min(chunk, sq)
    # flat heads: KV repeated to H heads, as the reference does
    ke = k.repeat_interleave(g, dim=2) if g > 1 else k
    ve = v.repeat_interleave(g, dim=2) if g > 1 else v
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = q[:, c0:c0 + chunk]
        scores = torch.einsum("bqhd,bshd->bhqs", qc.float(),
                              ke.float()) * scale
        qpos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        mask = torch.ones(qc.shape[1], sk, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        scores = torch.where(mask, scores, NEG_INF)
        att = torch.softmax(scores, dim=-1).to(ve.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", att, ve))
    return torch.cat(outs, dim=1)
