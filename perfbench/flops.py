"""FLOP and byte counts from shapes, and the peaks they are held to.

Peaks are one NVIDIA H100 SXM's published dense rates at its 700 W limit:
989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s in float32 outside them,
3.35 TB/s of HBM.  A roofline share divides the least time the card could
take (the larger of operations over the peak and bytes over the bandwidth)
by the traced device time; each input byte counts once and each output
byte once, and the operations are those the inputs need, never padding.

Configurations are the benchmark's own JSON dicts (``configs/*.json``),
with the port's field names.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def padded_vocab(cfg) -> int:
    return -(-cfg["vocab_size"] // 128) * 128


# ------------------------------------------------------- dense decoder ----
def dense_layer_matmul_params(cfg) -> int:
    """Weights one token multiplies in one attention + SwiGLU layer."""
    d, hd = cfg["d_model"], head_dim(cfg)
    h, k = cfg["n_heads"], cfg["n_kv_heads"]
    return 2 * d * h * hd + 2 * d * k * hd + 3 * d * cfg["d_ff"]


def causal_pairs(p0: int, p1: int) -> int:
    """(query, key) pairs of queries at positions p0 .. p1 - 1, each seeing
    the keys at positions 0 .. its own."""
    return (p1 * (p1 + 1) - p0 * (p0 + 1)) // 2


def dense_flops(cfg, spans, head_tokens: int) -> int:
    """Model FLOPs of a dense decoder over ``spans`` [(p0, p1), ...] of
    positions run through every layer (each attending causally over the
    positions visible to it) and ``head_tokens`` rows through the LM
    head."""
    tokens = sum(p1 - p0 for p0, p1 in spans)
    pairs = sum(causal_pairs(p0, p1) for p0, p1 in spans)
    per_pair = 4 * cfg["n_heads"] * head_dim(cfg)       # q.k and p.v
    return (cfg["n_layers"] * (2 * dense_layer_matmul_params(cfg) * tokens
                               + per_pair * pairs)
            + 2 * cfg["d_model"] * cfg["vocab_size"] * head_tokens)


def pa_decode_bytes(cfg, kv_len: int, page_size: int, elem: int) -> int:
    """Least bytes of one row of one ``pa_decode_kernel`` launch (one
    layer): K and V of the row's ``kv_len`` tokens, its q and its output,
    and the slice of its block table that maps them."""
    hd = head_dim(cfg)
    return (2 * kv_len * cfg["n_kv_heads"] * hd * elem
            + 2 * cfg["n_heads"] * hd * elem
            + 4 * (-(-kv_len // page_size)))


# ------------------------------------------------------------- mamba2 -----
def ssm_dims(cfg):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    return d_inner, d_inner // s["head_dim"], s["n_groups"] * s["d_state"]


def mamba_layer_matmul_params(cfg) -> int:
    """Weights one token multiplies in one mamba2 block: the z, x, B, C and
    dt projections and the output projection."""
    d = cfg["d_model"]
    di, nh, gn = ssm_dims(cfg)
    return d * (2 * di + 2 * gn + nh) + di * d


def ssd_case(cfg, batch: int, seq: int):
    """(B, S, H, P, G, N, chunk) of one mamba2 layer's scan."""
    s = cfg["ssm"]
    _, nh, _ = ssm_dims(cfg)
    return (batch, seq, nh, s["head_dim"], s["n_groups"], s["d_state"],
            s["chunk_size"])


def ssd_fwd_flops_bytes(case, elem: int):
    """Visible work of one SSD scan (the lower triangles of C B^T and of
    the scores times x, the off-diagonal C . state and the state update,
    per chunk of real positions) and its least traffic (x, B, C, dt read
    once, y and the final state written once)."""
    b, s, h, p, g, n, chunk = case
    flops = 0
    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (n + p) + 4 * m * p * n
    flops *= b * h
    nbytes = (2 * b * s * h * p * elem + 2 * b * s * g * n * elem
              + b * s * h * 4 + h * 4 + b * h * p * n * 4)
    return flops, nbytes


def ssd_bwd_flops_bytes(case, elem: int):
    """Visible work of one SSD backward, per chunk of m real positions and
    head: the lower triangles of C B^T and dy x^T and the four products
    with them (y, g, dC and dB), and six m x P x N products (the state's
    recomputation, y's and dC's terms from the entering state, g's and
    dB's from dh, and dh's update).  Least traffic: x, dy, B, C, dt and A
    read once; dx, dB, dC, ddt and dA written once."""
    b, s, h, p, g, n, chunk = case
    flops = 0
    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (3 * n + 3 * p) + 12 * m * p * n
    flops *= b * h
    nbytes = (3 * b * s * h * p * elem + 4 * b * s * g * n * elem
              + 2 * b * s * h * 4 + 2 * h * 4)
    return flops, nbytes


def least_seconds(flops: int, nbytes: int, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def mamba2_train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: 6 x the matmul weights per token
    (the tied LM head once, over the real vocabulary) plus every layer's
    SSD scan forward and backward."""
    tokens = batch * seq
    weights = (cfg["n_layers"] * mamba_layer_matmul_params(cfg)
               + cfg["d_model"] * cfg["vocab_size"])
    case = ssd_case(cfg, batch, seq)
    scan = ssd_fwd_flops_bytes(case, 2)[0] + ssd_bwd_flops_bytes(case, 2)[0]
    return 6 * weights * tokens + cfg["n_layers"] * scan
