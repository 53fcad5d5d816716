"""FLOP and byte counts of the per-layer Mamba-2 / attention hybrid with a
mixture of experts after every mixer (granite-4.0-h-small), from shapes,
held to ``flops.py``'s peaks and conventions.

Configurations are the benchmark's JSON dicts with the port's field
names; the held experts' routed pairs come from the program's counter.
"""
from __future__ import annotations

from perfbench import flops


def layer_kinds(cfg):
    pat = cfg["block_pattern"]
    return [pat[i % len(pat)] for i in range(cfg["n_layers"])]


def attn_matmul_params(cfg) -> int:
    """Weights one token multiplies in one attention mixer: q, k, v, o."""
    d, hd = cfg["d_model"], flops.head_dim(cfg)
    return 2 * d * cfg["n_heads"] * hd + 2 * d * cfg["n_kv_heads"] * hd


def moe_dense_params(cfg) -> int:
    """Weights every token multiplies in one MoE layer whichever experts
    it is routed to: the router and the shared SwiGLU expert."""
    e = cfg["moe"]
    return cfg["d_model"] * (e["n_experts"] + 3 * e["d_ff_shared"])


def expert_params(cfg) -> int:
    """Weights of one expert: what one routed (token, expert) pair
    multiplies."""
    return 3 * cfg["d_model"] * cfg["moe"]["d_ff_expert"]


def flash_case(cfg, batch: int, seq: int):
    """(B, H, K, S, D) of one attention mixer's causal flash call."""
    return (batch, cfg["n_heads"], cfg["n_kv_heads"], seq, flops.head_dim(cfg))


def flash_fwd_flops_bytes(case, elem: int):
    """Visible work of one causal flash forward, 4 D for every (query,
    key) pair a query sees (q k^T and p v), and its least traffic: q, k, v
    read once, o and the float32 log-sum-exp written once."""
    b, h, k, s, d = case
    pairs = b * h * flops.causal_pairs(0, s)
    nbytes = (2 * b * h * s * d + 2 * b * k * s * d) * elem + b * h * s * 4
    return 4 * d * pairs, nbytes


def flash_bwd_flops_bytes(case, elem: int):
    """Work that one causal flash backward needs, 10 D for every visible
    pair (q k^T recomputed, P^T dO, dO v^T, dS k, dS^T q; the split dq and
    dkv kernels recompute q k^T and dO v^T once more each, which is not
    counted), and its least traffic: q, k, v, o and dO read once with the
    log-sum-exp, dq, dk and dv written once."""
    b, h, k, s, d = case
    pairs = b * h * flops.causal_pairs(0, s)
    nbytes = ((3 * b * h * s * d + 4 * b * k * s * d) * elem
              + b * h * s * 4)
    return 10 * d * pairs, nbytes


def hybrid_train_flops(cfg, batch: int, seq: int, held_pairs: int) -> int:
    """Model FLOPs of one training step: 6 x the matmul weights a token
    uses (every mixer's projections, each layer's router and shared
    expert, the tied LM head once over the vocabulary slice) plus 6 x one
    expert's weights for each held expert's routed pair (``held_pairs``,
    summed over layers), plus each attention mixer's causal scores and
    their backward (3 x 4 D a visible pair) and each Mamba-2 mixer's SSD
    scan forward and backward."""
    kinds = layer_kinds(cfg)
    nm, na = kinds.count("mamba_ffn"), kinds.count("attn")
    tokens = batch * seq
    weights = (nm * flops.mamba_layer_matmul_params(cfg)
               + na * attn_matmul_params(cfg)
               + len(kinds) * moe_dense_params(cfg)
               + cfg["d_model"] * cfg["vocab_size"])
    case = flops.ssd_case(cfg, batch, seq)
    scan = (flops.ssd_fwd_flops_bytes(case, 2)[0]
            + flops.ssd_bwd_flops_bytes(case, 2)[0])
    attn = 3 * flash_fwd_flops_bytes(flash_case(cfg, batch, seq), 2)[0]
    return (6 * weights * tokens + 6 * expert_params(cfg) * held_pairs
            + na * attn + nm * scan)
