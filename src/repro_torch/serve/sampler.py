"""Sampling for the serving engine: greedy, temperature, top-k, top-p
(nucleus), min-p — plain PyTorch, with counter-based random numbers.

Twin of ``repro.serve.sampler``.  The reference folds ``(seq_id,
position)`` into a threefry key; the port does not reproduce threefry.
Its noise is Philox4x32-10 (Salmon et al., SC'11) written in int64 tensor
ops: the key is the engine seed, the counter is ``(vocab index, position,
seq_id, 0)``.  A row's draw therefore depends only on the seed, the
sequence and the index of the token being sampled — never on what else
was batched, how prefill was chunked, or the device: the bits are the
same on the CPU and on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled
    min_p: float = 0.0            # 0 => disabled


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for uint32 values held in int64,
    split in 16-bit pieces so no intermediate leaves int64's range."""
    p_lo = (a & 0xFFFF) * m                     # < 2**48
    p_hi = (a >> 16) * m                        # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)        # < 2**49
    return ((p_hi >> 16) + (mid >> 32)) & _MASK, mid & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 over broadcastable int64 tensors holding uint32 values."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def fold_row_keys(seed: int, seq_ids, positions):
    """Counter-based per-row sampling keys: ``(B, 4)`` int64 rows of
    ``(key lo, key hi, seq_id, position)``.  A row's draw then depends
    only on its identity and the index of the token being sampled — NOT
    on how admission, chunked prefill, or continuous batching happened to
    interleave the batch."""
    seq_ids = torch.as_tensor(seq_ids).long().reshape(-1)
    positions = torch.as_tensor(positions, device=seq_ids.device).long()
    b = seq_ids.shape[0]
    seed = int(seed)
    key = torch.tensor([seed & _MASK, (seed >> 32) & _MASK],
                       dtype=torch.long, device=seq_ids.device)
    return torch.cat([key.expand(b, 2), (seq_ids & _MASK)[:, None],
                      (positions.reshape(-1) & _MASK)[:, None]], dim=1)


def gumbel_rows(keys, vocab: int):
    """(B, vocab) float32 standard Gumbel noise, row i from ``keys[i]``."""
    v = torch.arange(vocab, dtype=torch.long, device=keys.device)[None]
    k0, k1, sid, pos = (keys[:, i:i + 1] for i in range(4))
    x, _, _, _ = philox4x32(v, pos, sid, torch.zeros_like(v), k0, k1)
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))     # in (0, 1)
    return -torch.log(-torch.log(u))


def _filter_per_row(z, top_k, top_p):
    """Per-row top-k then top-p nucleus filtering on temperature-scaled
    logits z (B, V).  top_k (B,) int, 0 = disabled; top_p (B,) float,
    >= 1 = disabled.  At least one token always survives per row."""
    v = z.shape[-1]
    neg = torch.tensor(float("-inf"), device=z.device)
    srt = torch.sort(z, dim=-1, descending=True).values
    # top-k: keep z >= k-th largest (k clamped to [1, V])
    k = torch.where(top_k > 0, top_k.clamp(1, v), v).long()
    kth = srt.gather(-1, (k - 1)[:, None])
    kth = torch.where((top_k > 0)[:, None], kth, neg)
    z = torch.where(z < kth, neg, z)
    # top-p: smallest prefix of the (top-k-filtered) sorted distribution
    # with cumulative probability >= p; masking srt keeps it sorted
    srt2 = torch.where(srt < kth, neg, srt)
    cum = torch.softmax(srt2, dim=-1).cumsum(dim=-1)
    idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=v - 1)
    cutoff = srt2.gather(-1, idx[:, None])
    cutoff = torch.where((top_p < 1.0)[:, None], cutoff, neg)
    return torch.where(z < cutoff, neg, z)


def sample_per_row(keys, logits, temperatures, top_k=None, top_p=None, *,
                   filters_on: Optional[bool] = None):
    """Fused per-row sampling for the decode hot path.

    logits (B, V) float; temperatures (B,) float — rows with temperature
    <= 0 take the argmax, the rest draw via Gumbel-max (argmax of
    logits/T + Gumbel noise == categorical(softmax(logits/T))).  Optional
    per-request filters: top_k (B,) int (0 = disabled) and top_p (B,)
    float (>= 1 = disabled).  ``keys`` are :func:`fold_row_keys` rows.

    ``filters_on`` says whether any row enables a filter.  The engine
    knows that on the host and passes it, so the step needs no device ->
    host read; ``None`` reads it from the tensors.  Returns (B,) int32.
    """
    greedy = logits.argmax(dim=-1).int()
    t = temperatures.float().clamp_min(1e-6)[:, None]
    z = logits.float() / t
    if top_k is not None or top_p is not None:
        b = logits.shape[0]
        tk = (top_k.long() if top_k is not None
              else torch.zeros(b, dtype=torch.long, device=z.device))
        tp = (top_p.float() if top_p is not None
              else torch.ones(b, device=z.device))
        if filters_on is None:
            filters_on = bool((tk > 0).any() or (tp < 1.0).any())
        if filters_on:
            z = _filter_per_row(z, tk, tp)
    g = gumbel_rows(keys, logits.shape[-1])
    noisy = torch.where(torch.isfinite(z), z + g,
                        float("-inf")).argmax(dim=-1).int()
    return torch.where(temperatures > 0, noisy, greedy)


def _apply_top_k(logits, k: int):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def _apply_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always >= 1 token)
    cutoff_idx = (cum < p).sum(dim=-1, keepdim=True).clamp(
        max=logits.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def _apply_min_p(logits, mp: float):
    if mp <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    return logits.masked_fill(probs < mp * top, float("-inf"))


def sample(seed: int, logits, cfg: SamplerConfig = SamplerConfig()):
    """logits (..., V) -> token ids (...,) int32.  Row i of the flattened
    batch draws from the counter ``(seq_id=i, position=0)`` of ``seed``."""
    if cfg.temperature <= 0.0:
        return logits.argmax(dim=-1).int()
    z = logits.float() / cfg.temperature
    z = _apply_min_p(_apply_top_p(_apply_top_k(z, cfg.top_k), cfg.top_p),
                     cfg.min_p)
    flat = z.reshape(-1, z.shape[-1])
    rows = torch.arange(flat.shape[0], device=z.device)
    g = gumbel_rows(fold_row_keys(seed, rows, torch.zeros_like(rows)),
                    flat.shape[-1])
    return (flat + g).argmax(dim=-1).int().reshape(z.shape[:-1])
