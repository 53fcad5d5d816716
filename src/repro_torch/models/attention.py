"""Attention: GQA projection weights (``attn_init``) and projections (the
reference's ``x @ W`` layout), the full-sequence ``attend_chunked`` and
the dense-cache decode paths.

Twin of ``repro.models.attention``.  The reference documents
``attend_chunked(fused=True)`` as the region that executes as the
flash-attention kernel on the TPU; here a CUDA tensor always takes the
hand-written kernels through ``ops.mha_fused``, and a CPU tensor the
reference's query-chunked exact softmax.  ``attend_chunked``'s callers
(``transformer._attn_block_fwd``) are the decoder's causal
self-attention, the whisper encoder's non-causal self-attention over its
frames and the decoder's non-causal cross-attention from Sq tokens to Sk
frames.

  * ``attend_decode``     — one new token against a dense KV cache (also
    the encoder-decoder's cross-attention over its ``xk``/``xv`` cache,
    ``transformer._attn_block_decode``);
  * ``attend_decode_swa`` — one new token against a ring-buffer window
    cache;
  * ``cache_update``, ``cache_update_uniform``, ``cache_update_ring`` —
    the one-token cache writes.

The decode paths are the reference's plain einsums (no Pallas kernel sits
under them), so they stay plain PyTorch on both devices.  The reference's
caches are functional; here the writes land in place (``index_put_``) and
the cache tensors are returned, the port's form of a donated buffer.  The
paged serving path attends through ``repro_torch.serve.paged_model`` and
the paged-attention kernel.  ``attend_decode_cp`` is the context-parallel
decode over a KV cache sequence-sharded on a mesh dim: every rank runs it
on its own block and the softmax statistics meet in two all-reduces.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import layers
from repro_torch.models.sharding import MeshRules, P

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, *,
              dtype=torch.float32):
    """The reference's projection weights, drawn from ``gen`` in the
    order wq, wk, wv, wo; ``qkv_bias`` adds zero biases."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": layers.dense_init(gen, d, h * hd, dtype=dtype),
        "wk": layers.dense_init(gen, d, k * hd, dtype=dtype),
        "wv": layers.dense_init(gen, d, k * hd, dtype=dtype),
        "wo": layers.dense_init(gen, h * hd, d, dtype=dtype,
                                scale=1.0 / (h * hd) ** 0.5),
    }
    if cfg.qkv_bias:
        for b, n in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            p[b] = layers.bias_init(n, dtype=dtype, device=gen.device)
    return p


def attn_specs(cfg: ModelConfig, rules: MeshRules) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    # Shard the flattened head dim on `model` only when whole heads divide,
    # so per-head softmax stays device-local.
    q_tp = rules.tp_axis if (rules.tp_size and h % rules.tp_size == 0) else None
    kv_tp = rules.tp_axis if (rules.tp_size and k % rules.tp_size == 0) else None
    s = {
        "wq": P(rules.fsdp(d), q_tp),
        "wk": P(rules.fsdp(d), kv_tp),
        "wv": P(rules.fsdp(d), kv_tp),
        "wo": P(q_tp, rules.fsdp(d)),
    }
    if cfg.qkv_bias:
        s["bq"] = P(q_tp)
        s["bk"] = P(kv_tp)
        s["bv"] = P(kv_tp)
    return s


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
                   fused: bool = False, scale: Optional[float] = None):
    """Exact attention.  q (B,Sq,H,hd); k,v (B,Sk,K,hd) -> (B,Sq,H,hd).

    ``q_offset``: absolute position of q[0] relative to k[0].  ``window``
    > 0 applies a sliding window.  ``scale``: the softmax scale (None:
    1/sqrt(hd)).  On the card: the flash-attention
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
                          v.transpose(1, 2), causal, window, scale)
        return o.transpose(1, 2)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
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


# -------------------------------------------------------------- decode ----
def _decode_softmax(q, k_cache, v_cache, valid):
    """q (B,1,H,hd) against caches (B,S,K,hd); ``valid`` (B,S) marks the
    keys each row sees.  Scores in float32 (the reference's
    ``preferred_element_type``), probabilities cast to the cache dtype."""
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    qc = q.reshape(b, 1, kh, h // kh, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qc.float(),
                          k_cache.float()) * hd ** -0.5
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    att = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", att, v_cache)
    return out.reshape(b, 1, h, hd)


def attend_decode(q, k_cache, v_cache, cache_len):
    """q (B,1,H,hd); caches (B,Smax,K,hd); cache_len (B,) valid entries
    (including the token written this step)."""
    pos = torch.arange(k_cache.shape[1], device=q.device)
    return _decode_softmax(q, k_cache, v_cache,
                           pos[None, :] < cache_len.to(q.device)[:, None])


def attend_decode_cp(q, k_cache, v_cache, cache_len, mesh, *,
                     seq_axis: str = "model", collectives=None):
    """Context-parallel decode attention: the KV cache stays SEQUENCE-
    sharded on ``seq_axis`` and the softmax is computed distributed (a
    max, then a sum, of per-shard statistics) instead of gathering the
    cache.

    Every rank of ``seq_axis`` calls this with its own block, in the same
    order: q (B,1,H,hd) the same on each of them; caches (B,S_local,K,hd),
    the rank at coordinate ``r`` holding positions ``[r * S_local, (r + 1)
    * S_local)``; cache_len (B,) valid entries of the whole sequence.  A
    batch split over another dim (``data``) needs nothing here: the caller
    passes its own rows, and rows never meet, so no reduction runs over
    that dim.  Scores and the ``p . V`` partial accumulate in float32; the
    max, then the two sums in one operand, go through ``collectives`` (a
    :class:`~repro_torch.core.services.collectives.CollectiveService`, a
    fresh one when ``None``)."""
    from repro_torch.core.services.collectives import CollectiveService
    svc = collectives if collectives is not None else CollectiveService()
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    s_local = k_cache.shape[1]
    idx = mesh.get_local_rank(seq_axis)
    axes = (seq_axis,)
    qc = q.reshape(b, 1, kh, g, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qc,
                          k_cache.float()) * hd ** -0.5
    pos = idx * s_local + torch.arange(s_local, device=q.device)
    mask = pos[None, :] < cache_len.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    m = svc.all_reduce(scores.amax(dim=-1, keepdim=True), mesh, axes,
                       op="max")
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)                       # (B,K,G,1,1)
    part = torch.einsum("bkgqs,bskh->bqkgh", p, v_cache.float())
    both = svc.all_reduce(torch.cat([part.reshape(b, -1), l.reshape(b, -1)],
                                    dim=1), mesh, axes)
    out = both[:, :part[0].numel()].reshape(part.shape)
    l = both[:, part[0].numel():].reshape(l.shape)
    out = out / l.permute(0, 3, 1, 2, 4).clamp_min(1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attend_decode_swa(q, k_cache, v_cache, pos, window: int):
    """Decode against a ring-buffer cache of size W=window.

    ``pos`` (B,): absolute position of the current token (already
    written).  Valid entries: absolute positions in (pos-W, pos]; slot i
    holds the most recent token with abs_pos % W == i."""
    w = k_cache.shape[1]
    pos = pos.to(q.device).long()[:, None]
    slots = torch.arange(w, device=q.device)[None, :]
    abs_pos = pos - torch.remainder(pos - slots, w)
    valid = (abs_pos >= 0) & (abs_pos > pos - w) & (abs_pos <= pos)
    return _decode_softmax(q, k_cache, v_cache, valid)


def _write_rows(cache, new, idx):
    """cache[b, idx[b]] = new[b, 0] for every row, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.to(cache.device).long()] = new[:, 0].to(cache.dtype)


def cache_update(k_cache, v_cache, k_new, v_new, cache_len):
    """Write one token per row at position cache_len (B,).  Positions
    past the end clamp to the last slot, as the reference's
    ``dynamic_update_slice`` does."""
    idx = cache_len.clamp(0, k_cache.shape[1] - 1)
    _write_rows(k_cache, k_new, idx)
    _write_rows(v_cache, v_new, idx)
    return k_cache, v_cache


def cache_update_uniform(k_cache, v_cache, k_new, v_new, pos):
    """All rows write at the SAME position (static-batch decode): one
    slice write (the reference's single ``dynamic_update_slice``, start
    clamped likewise)."""
    p = torch.as_tensor(pos, device=k_cache.device).long().reshape(1)
    p = p.clamp(0, k_cache.shape[1] - 1)
    k_cache.index_copy_(1, p, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, p, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def cache_update_ring(k_cache, v_cache, k_new, v_new, pos):
    """SWA ring buffer of size W: write at pos % W."""
    slot = torch.remainder(pos.long(), k_cache.shape[1])
    _write_rows(k_cache, k_new, slot)
    _write_rows(v_cache, v_new, slot)
    return k_cache, v_cache
