"""Plain float32 reference of a llama-style decoder (h2o-danube-3-4b).

RMSNorm, rotary embeddings (the split-half convention: the first and
second halves of a head rotate together), grouped-query attention with
query head ``k * G + g`` reading KV head ``k``, exact causal softmax over
the whole context (no sliding window: the serving path under test
attends over every position), SwiGLU, an untied LM head.  Every product
is float32 with TF32 off; the bf16 weights the benchmark made are upcast
one layer at a time.  Imports torch alone.

``control=True`` computes the same forward in fp8 (e4m3, scaled per row
of activations and per output column of weights) at every matrix product
and in the K and V it attends over: the next precision below the bf16
the configuration serves in.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t, dim):
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / torch.finfo(FP8).max
    return (t / s).to(FP8).float() * s


def linear(x, w, control):
    if control:
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (S, heads, D), pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, chunk=512):
    """q (S, H, D), k and v (S, K, D) -> (S, H, D), exact, in query
    chunks."""
    s_len, h, d = q.shape
    kh = k.shape[1]
    g = h // kh
    out = []
    for c0 in range(0, s_len, chunk):
        c1 = min(c0 + chunk, s_len)
        qc = q[c0:c1].reshape(c1 - c0, kh, g, d)
        sc = torch.einsum("qkgd,skd->kgqs", qc, k[:c1]) * d ** -0.5
        qpos = torch.arange(c0, c1, device=q.device)[:, None]
        kpos = torch.arange(c1, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("kgqs,skd->qkgd", p, v[:c1])
                   .reshape(c1 - c0, h, d))
    return torch.cat(out)


def logits(params, cfg, tokens, positions, *, control=False):
    """Logits (len(positions), vocab) of a causal forward over ``tokens``
    (a list of ids), read at ``positions``."""
    with no_tf32(), torch.no_grad():
        L, hd = cfg["n_layers"], cfg.get("head_dim") or (
            cfg["d_model"] // cfg["n_heads"])
        h, kh, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["norm_eps"]
        table = params["embed"]["table"]
        dev = table.device
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        pos = torch.arange(len(tokens), device=dev)
        x = table[ids].float()
        lay = params["layers"]
        for li in range(L):
            a = {k: v[li].float() for k, v in lay["attn"].items()}
            f = {k: v[li].float() for k, v in lay["ffn"].items()}
            hx = rmsnorm(x, lay["norm1"]["scale"][li].float(), eps)
            q = linear(hx, a["wq"], control).reshape(-1, h, hd)
            k = linear(hx, a["wk"], control).reshape(-1, kh, hd)
            v = linear(hx, a["wv"], control).reshape(-1, kh, hd)
            q = rope(q, pos, cfg["rope_theta"])
            k = rope(k, pos, cfg["rope_theta"])
            if control:
                k, v = fp8(k, -1), fp8(v, -1)
            att = causal_attention(q, k, v).reshape(-1, h * hd)
            x = x + linear(att, a["wo"], control)
            hx = rmsnorm(x, lay["norm2"]["scale"][li].float(), eps)
            x = x + linear(F.silu(linear(hx, f["w_gate"], control))
                           * linear(hx, f["w_up"], control),
                           f["w_down"], control)
        sel = torch.as_tensor(positions, dtype=torch.long, device=dev)
        hx = rmsnorm(x[sel], params["final_norm"]["scale"].float(), eps)
        return linear(hx, params["lm_head"].float(),
                      control)[:, :cfg["vocab_size"]]


def served_gap(params, cfg, prompt, out, *, control=False) -> float:
    """The widest gap, over the served tokens ``out`` that followed
    ``prompt``, between the reference's best logit at a token's position
    and its logit of the token served there.  ``control``: of the token
    that the fp8 forward puts first there instead."""
    tokens = list(prompt) + list(out[:-1])
    positions = list(range(len(prompt) - 1, len(tokens)))
    lg = logits(params, cfg, tokens, positions)
    if control:
        served = logits(params, cfg, tokens, positions,
                        control=True).argmax(-1)
    else:
        served = torch.as_tensor(out, dtype=torch.long, device=lg.device)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    return float(gap.max())
