"""Decode path through the MMU's paged KV pools.

Twin of ``repro.serve.paged_model``: KV lives in the MMU service's page
pools, and decode and prefill attention walk the block tables through the
CUDA paged-attention kernels (their plain versions on the CPU).

Contract, and where it differs from the reference:

  * **Flat pool layout plus a sink page.**  Each side is one
    ``(n_layers * n_pages + 1, page_size, kv_heads, head_dim)`` tensor;
    layer ``l``'s physical page ``p`` is flat slot ``l * n_pages + p``, as
    in the reference.  The one extra trailing slot is a *sink*: PyTorch
    has no ``mode="drop"`` scatter, so every write the reference drops
    (padding, shared-prefix positions, unmapped pages, inactive rows) is
    routed to the sink instead, and nothing ever reads it.  Shapes stay
    static and no write needs a host sync.  Compare ``pools[:-1]`` with
    the reference's pools.
  * **In place.**  KV writes are ``index_put_`` into the caller's pools;
    this takes the place of the reference's buffer donation.  The prefill
    and decode functions return tokens (and new lengths), not pools.
  * **Per-layer pool views.**  Decode hands the kernel
    ``pool[l * n_pages:(l + 1) * n_pages]`` — the base pointer offset by
    ``l * n_pages * page * K * D`` elements — with the raw block table,
    in place of the reference's biased table ``tables + l * n_pages``.
  * **Prefill attention through the tables.**  Chunked and batched
    prefill (``_prefill_layers``) hand each layer's pool view, the raw
    tables, ``q_starts`` and ``q_lens`` to ``ops.paged_prefill``, which on
    the card walks each row's own pages up to the last key its queries
    see (``csrc/paged_prefill.cu``) and on the CPU runs the reference's
    gather of the whole table and float32 einsums
    (``ref.paged_prefill_ref``); the layer loop builds no key mask and
    gathers no K or V.
  * **Clamped gathers.**  XLA clamps out-of-range indices; PyTorch raises
    on the CPU and faults on CUDA.  Every index is clamped exactly where
    the reference clamps (page ids at 0, virtual pages at ``maxp - 1``,
    last-token positions at 0).
  * **Sampling** uses counter-based Philox keys from an integer seed
    (``repro_torch.serve.sampler``); ``filters_on`` lets the engine skip
    the top-k/top-p pass without a device -> host read.
  * ``prefill_paged`` runs the dense ``forward`` over a padded batch (the
    flash-attention kernels on the card) and ``write_prefill`` scatters
    its KV with the reference's drop rule, the drops going to the sink.

Applicability: attention-family architectures, with dense or MoE FFNs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import (paged_decode,
                                                     paged_prefill)
from repro_torch.models import attention, layers, transformer
from repro_torch.models.transformer import forward, lm_logits
from repro_torch.serve.sampler import fold_row_keys, sample_per_row


def make_pools(cfg: ModelConfig, n_pages: int, page_size: int, *,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Flat KV pools: layer ``l``'s page ``p`` is flat slot
    ``l * n_pages + p`` of a (n_layers * n_pages + 1, page, K, hd) tensor
    whose last slot is the write sink."""
    device = resolve_device(device)
    shape = (cfg.n_layers * n_pages + 1, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _geometry(cfg: ModelConfig, pools):
    sink = pools["k"].shape[0] - 1
    return sink // cfg.n_layers, sink


def write_prefill(pools, layer_kv, tables, lens, page_size: int):
    """Scatter a prefilled sequence batch into the flat pools, in place.

    layer_kv: (ks, vs) each (L, B, S, K, hd); tables (B, maxp) per-layer
    page ids; lens (B,) prompt lengths.  One scatter per side: tokens
    at/after a row's len (padding) and positions whose table entry is
    unmapped go to the sink slot, where the reference drops them.
    Returns ``pools``."""
    ks, vs = layer_kv
    l, b, s, kh, hd = ks.shape
    dev = pools["k"].device
    sink = pools["k"].shape[0] - 1
    n_pages = sink // l
    tables, lens = tables.to(dev).long(), lens.to(dev).long()
    pos = torch.arange(s, device=dev)
    vpage = (pos // page_size).clamp(max=tables.shape[1] - 1)
    off = (pos % page_size).expand(l, b, s)
    ppage = tables.gather(1, vpage.expand(b, s))                # (B,S)
    valid = (pos[None, :] < lens[:, None]) & (ppage >= 0)
    base = (torch.arange(l, device=dev) * n_pages)[:, None, None]
    dst = torch.where(valid[None], base + ppage[None], sink)    # (L,B,S)
    for side, new in (("k", ks), ("v", vs)):
        pools[side][dst, off] = new.to(dev, pools[side].dtype)
    return pools


def flat_page_indices(ppages, n_layers: int, n_pages: int) -> torch.Tensor:
    """Flat pool slots of physical pages ``ppages`` across every layer,
    layer-major: ``[l0p0, l0p1, ..., l1p0, ...]``, shape
    ``(n_layers * len(ppages),)`` int64 on the CPU.  Gather and scatter
    MUST agree on this ordering."""
    pp = torch.as_tensor(ppages, dtype=torch.long).reshape(-1)
    base = torch.arange(n_layers, dtype=torch.long)[:, None] * n_pages
    return (base + pp[None, :]).reshape(-1)


def bucket_pages(n: int, *, floor: int = 4) -> int:
    """Round a page-transfer count up to the next power of two (at least
    ``floor``), as the reference does for its transfer shapes."""
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return b


def gather_kv_pages(pools, flat_idx):
    """Compact copy of the pool slots ``flat_idx`` (see
    :func:`flat_page_indices`): ``{"k": (n, page, K, hd), "v": ...}`` on
    the pools' device.  The pools are not modified."""
    idx = torch.as_tensor(flat_idx, dtype=torch.long).to(pools["k"].device)
    return {s: pools[s].index_select(0, idx) for s in ("k", "v")}


def scatter_kv_pages(pools, flat_idx, data):
    """Write a gathered transfer buffer back into the pools at
    ``flat_idx``, in place; returns ``pools``."""
    idx = torch.as_tensor(flat_idx, dtype=torch.long).to(pools["k"].device)
    for s in ("k", "v"):
        pools[s].index_copy_(0, idx, torch.as_tensor(data[s]).to(
            device=pools[s].device, dtype=pools[s].dtype))
    return pools


def _layer_params(params, li: int):
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params["layers"])


def _ffn(lp, cfg: ModelConfig, h):
    """The layer's FFN on the whole (N, T, D) batch.  A MoE layer routes
    every row, padding and inactive rows included, as the reference
    does: they share the group's expert capacity, so the port drops the
    (token, expert) pairs the reference drops."""
    return transformer._ffn(lp["ffn"], cfg, h)[0]


def _prefill_layers(params, pools, tokens, q_lens, q_starts, write_from,
                    tables, *, cfg: ModelConfig, page_size: int,
                    psum_attn=None, psum_mlp=None):
    """The shared body of both prefill entry points: run the transformer
    over ``tokens`` at absolute positions ``q_starts + arange(T)``, write
    KV at positions >= ``write_from`` into mapped pages, and attend
    causally through the block tables.  Returns the final hidden states
    before the final norm, (N, T, D).

    ``psum_attn`` / ``psum_mlp``: optional reduction hooks applied to the
    attention out-projection and the FFN output before the residual add
    (the tensor-parallel path sums its partials there,
    ``repro_torch.serve.tp``); head counts come from ``cfg``, which is the
    rank's local config under TP."""
    dev = pools["k"].device
    tokens = tokens.to(dev).long()
    # int32, as the attention kernel takes them (no copy if they are)
    tables = tables.to(dev, torch.int32)
    q_lens = q_lens.to(dev, torch.int32)
    q_starts = q_starts.to(dev, torch.int32)
    write_from = write_from.to(dev).long()
    t = tokens.shape[1]
    maxp = tables.shape[1]
    n_pages, sink = _geometry(cfg, pools)
    ar = torch.arange(t, device=dev)
    pos = q_starts[:, None] + ar[None, :]                   # (N,T) int64
    qvalid = ar[None, :] < q_lens[:, None]
    vpage = (pos // page_size).clamp(max=maxp - 1)
    off = pos % page_size
    ppage = tables.gather(1, vpage).long()                  # (N,T)
    wvalid = qvalid & (pos >= write_from[:, None]) & (ppage >= 0)
    kp, vp = pools["k"], pools["v"]

    x = layers.embed_lookup(params["embed"], tokens)        # (N,T,D)
    for li in range(cfg.n_layers):
        lp = _layer_params(params, li)
        base = li * n_pages
        h = layers.norm_apply(lp["norm1"], x, cfg.norm_eps)
        q, k, v = attention.qkv_proj(lp["attn"], cfg, h)
        if cfg.pos_embed == "rope":
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        # write this chunk's KV first so its queries see their own keys;
        # writes the reference drops go to the sink slot
        dst = torch.where(wvalid, base + ppage, sink)
        kp[dst, off] = k.to(kp.dtype)
        vp[dst, off] = v.to(vp.dtype)
        # causal attention over each row's own pages of this layer
        att = paged_prefill(q, kp[base:base + n_pages],
                            vp[base:base + n_pages], tables, q_starts,
                            q_lens)
        x = _residual(x, attention.out_proj(lp["attn"], cfg, att), psum_attn)
        h = layers.norm_apply(lp["norm2"], x, cfg.norm_eps)
        x = _residual(x, _ffn(lp, cfg, h), psum_mlp)
    return x


def _residual(x, out, hook):
    """``x + hook(out)``: the block's partial output reduced first where a
    hook is given."""
    return x + (out if hook is None else hook(out))


def _prefill_logits(params, pools, tokens, q_lens, q_starts, write_from,
                    tables, *, cfg: ModelConfig, page_size: int,
                    psum_attn=None, psum_mlp=None):
    """Prefill body plus the LM head at each row's last query: (N, V)."""
    dev = pools["k"].device
    x = _prefill_layers(params, pools, tokens, q_lens, q_starts, write_from,
                        tables, cfg=cfg, page_size=page_size,
                        psum_attn=psum_attn, psum_mlp=psum_mlp)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    last = x[torch.arange(x.shape[0], device=dev),
             (q_lens.to(dev).long() - 1).clamp_min(0)]      # (N,D)
    return lm_logits(params, cfg, last)[..., :cfg.vocab_size]


def prefill_shared_paged(params, pools, tokens, q_lens, q_starts,
                         write_from, tables, seed: int, temperatures,
                         top_k=None, top_p=None, seq_ids=None, *,
                         cfg: ModelConfig, page_size: int,
                         filters_on: Optional[bool] = None,
                         psum_attn=None, psum_mlp=None):
    """Suffix prefill for (prefix-shared) admissions; samples each row's
    first token.

    tokens (N, T) int   — row i holds prompt[q_starts[i]:][:q_lens[i]],
                          right-padded;
    q_lens (N,)         — suffix lengths (0 = padding row);
    q_starts (N,)       — absolute position of tokens[i, 0] (len-1 for a
                          fully covered prompt: its KV write is masked);
    write_from (N,)     — KV is written only at positions >= this;
    tables (N, maxp)    — block tables for the full prompt.

    KV lands in ``pools`` in place.  Sampling keys are counter-based on
    ``(seq_id, prompt length)``; without ``seq_ids`` every row uses
    seq_id 0.  ``psum_attn``/``psum_mlp`` are the TP reduction hooks (see
    :func:`_prefill_layers`).  Returns first tokens (N,) int32 on the
    pools' device.
    """
    dev = pools["k"].device
    logits = _prefill_logits(params, pools, tokens, q_lens, q_starts,
                             write_from, tables, cfg=cfg,
                             page_size=page_size, psum_attn=psum_attn,
                             psum_mlp=psum_mlp)
    q_lens, q_starts = q_lens.to(dev).long(), q_starts.to(dev).long()
    if seq_ids is None:
        seq_ids = torch.zeros_like(q_lens)
    keys = fold_row_keys(seed, seq_ids.to(dev), q_starts + q_lens)
    return sample_per_row(keys, logits, temperatures.to(dev),
                          None if top_k is None else top_k.to(dev),
                          None if top_p is None else top_p.to(dev),
                          filters_on=filters_on)


def prefill_chunk_paged(params, pools, tokens, q_lens, q_starts, tables, *,
                        cfg: ModelConfig, page_size: int, psum_attn=None,
                        psum_mlp=None) -> None:
    """One INTERMEDIATE chunk of a streaming prefill: KV only — no final
    norm, no logits, no random numbers.  Row i runs
    ``prompt[q_starts[i]:][:q_lens[i]]`` and writes its KV at those
    absolute positions, in place; earlier positions are never written.
    ``psum_attn``/``psum_mlp``: the TP reduction hooks."""
    _prefill_layers(params, pools, tokens, q_lens, q_starts, q_starts,
                    tables, cfg=cfg, page_size=page_size,
                    psum_attn=psum_attn, psum_mlp=psum_mlp)


def prefill_paged(params, pools, tokens, lens, tables, seed: int,
                  temperatures, top_k=None, top_p=None, seq_ids=None, *,
                  cfg: ModelConfig, page_size: int,
                  filters_on: Optional[bool] = None):
    """Batched prefill: one padded forward for every admitted request.

    tokens (N, S) right-padded prompts; lens (N,) prompt lengths (0 =
    padding row); tables (N, maxp) block tables for the freshly
    allocated sequences; temperatures (N,); optional per-request top_k /
    top_p.  KV lands in ``pools`` in place.  Sampling keys are
    counter-based on ``(seq_id, prompt length)`` (seq_id 0 without
    ``seq_ids``).  Returns the first tokens (N,) int32 on the pools'
    device; padding rows yield tokens the caller ignores."""
    dev = pools["k"].device
    tokens, lens = tokens.to(dev).long(), lens.to(dev).long()
    hidden, _, kv, _ = forward(params, cfg, tokens, collect_kv=True)
    write_prefill(pools, kv, tables, lens, page_size)
    last = hidden[torch.arange(tokens.shape[0], device=dev),
                  (lens - 1).clamp_min(0)]                      # (N, D)
    logits = lm_logits(params, cfg, last)[..., :cfg.vocab_size]
    if seq_ids is None:
        seq_ids = torch.zeros_like(lens)
    keys = fold_row_keys(seed, seq_ids.to(dev), lens)
    return sample_per_row(keys, logits, temperatures.to(dev),
                          None if top_k is None else top_k.to(dev),
                          None if top_p is None else top_p.to(dev),
                          filters_on=filters_on)


def _decode_logits(params, pools, tables, lens, last_tokens, *,
                   cfg: ModelConfig, page_size: int, psum_attn=None,
                   psum_mlp=None):
    """The decode step's layers, KV appends and LM head: (B, V) logits.
    ``psum_attn``/``psum_mlp``: the TP reduction hooks."""
    maxp = tables.shape[1]
    n_pages, sink = _geometry(cfg, pools)
    x = layers.embed_lookup(params["embed"], last_tokens.long()[:, None])
    pos = lens.long()                                 # 0-based new position
    vpage = (pos // page_size).clamp(max=maxp - 1)
    off = pos % page_size
    ppage = tables.gather(1, vpage[:, None])[:, 0].long()
    active = ppage >= 0
    kv_lens = torch.where(active, lens + 1, 0).to(torch.int32)
    kp, vp = pools["k"], pools["v"]
    for li in range(cfg.n_layers):
        lp = _layer_params(params, li)
        base = li * n_pages
        h = layers.norm_apply(lp["norm1"], x, cfg.norm_eps)
        q, k, v = attention.qkv_proj(lp["attn"], cfg, h)
        if cfg.pos_embed == "rope":
            q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
            k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
        # inactive rows write to the sink slot
        dst = torch.where(active, base + ppage, sink)
        kp[dst, off] = k[:, 0].to(kp.dtype)
        vp[dst, off] = v[:, 0].to(vp.dtype)
        att = paged_decode(q[:, 0].contiguous(), kp[base:base + n_pages],
                           vp[base:base + n_pages], tables, kv_lens)
        x = _residual(x, attention.out_proj(lp["attn"], cfg, att[:, None]),
                      psum_attn)
        h = layers.norm_apply(lp["norm2"], x, cfg.norm_eps)
        x = _residual(x, _ffn(lp, cfg, h), psum_mlp)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0, :cfg.vocab_size]


def decode_step_paged(params, pools, tables, lens, last_tokens, seed: int,
                      temperatures, top_k=None, top_p=None, seq_ids=None, *,
                      cfg: ModelConfig, page_size: int,
                      filters_on: Optional[bool] = None,
                      psum_attn=None, psum_mlp=None):
    """One fused decode step for the whole running batch.

    last_tokens (B,) int  — last sampled token per row;
    lens (B,) int32       — tokens already in cache (new token position);
    tables (B, maxp) int32 — MMU block tables (row of -1s = inactive);
    temperatures (B,)     — per-row temperature (<= 0 = greedy);
    top_k (B,) / top_p (B,) — optional per-row filters.

    KV appends land in ``pools`` in place.  Returns ``(next_tokens (B,)
    int32, new_lens (B,) int32)``; the only host traffic a caller needs
    per step is reading back the token vector.  On the card each layer
    launches the paged-attention kernel once.  ``psum_attn``/``psum_mlp``
    are the TP reduction hooks (``cfg`` is then the rank's local config,
    so the kernel runs on the rank's head slice).
    """
    logits = _decode_logits(params, pools, tables, lens, last_tokens,
                            cfg=cfg, page_size=page_size,
                            psum_attn=psum_attn, psum_mlp=psum_mlp)
    pos = lens.long()
    if seq_ids is None:
        seq_ids = torch.zeros_like(pos)
    # lens + 1 == index of the token being sampled.  Every row samples,
    # so a live row whose write page was evicted still emits a (degraded)
    # token, as in the reference.
    keys = fold_row_keys(seed, seq_ids, pos + 1)
    next_tokens = sample_per_row(keys, logits, temperatures, top_k, top_p,
                                 filters_on=filters_on)
    # lens mirrors the host's per-step append unconditionally
    return next_tokens, lens + 1
