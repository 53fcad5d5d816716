"""Plain float32 reference of IBM Granite 4.0-H Small training
(granite-4.0-h-small, ``model_type`` granitemoehybrid) on one chip's share
of an expert-parallel deployment: forward, next-token loss, gradients by
autograd, and AdamW.

The layer equations are those of ``transformers``' granitemoehybrid model:

    x = embedding_multiplier * E[ids]
    per layer: x = x + r * mixer(rmsnorm(x))      Mamba-2 or attention
               x = x + r * (moe(h) + shared(h)),  h = rmsnorm(x)
    logits = rmsnorm(x) E^T / logits_scaling

with r the ``residual_multiplier``.  Attention: GQA, no positional
encoding, causal softmax of q k^T times ``attention_multiplier``.  The
Mamba-2 mixer: the z, x, B, C and dt projections, a causal depthwise
convolution with bias and SiLU over (x, B, C), dt = softplus(dt +
dt_bias), A = -exp(A_log), the SSD scan (``mamba2.ssd``, the paper's
minimal chunked algorithm), the skip D x, RMSNorm of y * silu(z) over all
the inner channels (``norm_before_gate`` False, one group), the output
projection.  The MoE: router logits h W_r over all ``n_experts`` in
float32, the top ``top_k`` of them, gates the softmax over those k
logits; each held expert (experts 0 .. ``experts_held`` - 1) computes its SwiGLU on the tokens routed to it alone,
times its gate, and the absent experts' part is left out (they live on
other chips); the shared SwiGLU expert runs on every token.  The
embedding is tied to the LM head over the configuration's vocabulary
slice, whose softmax is the loss's.  The loss is the mean over every
position but each row's last, plus ``aux_loss_coef`` times the sum over
layers of each layer's Switch load-balancing loss, ``n_experts`` times
the sum over experts of the share of (token, choice) pairs routed to it
and its mean router probability (the port's rule; ``transformers`` pools
every layer's router logits into one such loss and does not divide by
k).  AdamW as ``mamba2.train``.  Every product is float32 with TF32 off;
each block is recomputed in the backward to fit.  Imports torch and the
other references' helpers alone.

``control=True`` computes one notch below the configuration's bf16, as
``mamba2``'s control does: fp8 (e4m3, scaled per row, weights per output
column; e5m2 gradients) wherever the program holds bf16 (the residual
stream, each norm's and projection's output, the convolution's, the
scan's input and output, attention's output, each expert's and the
shared expert's output, the weights of every matrix product), float32
where the program keeps it (dt and A, the router and its gates, the
norms' arithmetic, the LM head and the loss).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense import no_tf32
from perfbench.reference.mamba2 import (decays, flatten, linear, lr_at, rnd,
                                        rmsnorm, ssd)

MAMBA_KEYS = ("mamba/wz", "mamba/wx", "mamba/wB", "mamba/wC", "mamba/wdt",
              "mamba/conv_w", "mamba/conv_b", "mamba/dt_bias", "mamba/A_log",
              "mamba/D", "mamba/norm/scale", "mamba/wo")
ATTN_KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
FFN_KEYS = ("ffn/router", "ffn/w_gate", "ffn/w_up", "ffn/w_down",
            "ffn/shared/w_gate", "ffn/shared/w_up", "ffn/shared/w_down")
STACKS = {"mamba_ffn": ("mamba_layers", MAMBA_KEYS),
          "attn": ("attn_layers", ATTN_KEYS)}


def layer_kinds(cfg):
    pat = cfg["block_pattern"]
    return [pat[i % len(pat)] for i in range(cfg["n_layers"])]


def mamba_mixer(cfg, control, u, wz, wx, wB, wC, wdt, conv_w, conv_b,
                dt_bias, A_log, D, gnorm, wo):
    """The Mamba-2 mixer's output for the normed input ``u`` (B, S, D)."""
    s = cfg["ssm"]
    b, s_len, d = u.shape
    di = s["expand"] * d
    nh, gn = di // s["head_dim"], s["n_groups"] * s["d_state"]

    def q(t):
        return rnd(t, control)

    z = q(linear(u, wz, control))
    xbc = torch.cat([q(linear(u, w, control)) for w in (wx, wB, wC)],
                    dim=-1)
    dt = q(linear(u, wdt, control))
    k = conv_w.shape[0]
    xe = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = q(F.silu(sum(xe[:, i:i + s_len] * conv_w[i] for i in range(k))
                   + conv_b))
    xp, Bp, Cp = torch.split(xbc, [di, gn, gn], dim=-1)
    dt = F.softplus(dt + dt_bias)
    x4 = xp.reshape(b, s_len, nh, s["head_dim"])
    y = q(ssd(x4, dt, -torch.exp(A_log),
              Bp.reshape(b, s_len, s["n_groups"], s["d_state"]),
              Cp.reshape(b, s_len, s["n_groups"], s["d_state"]),
              s["chunk_size"]))
    y = q(y + D[:, None] * x4)
    y = q(rmsnorm(y.reshape(b, s_len, di) * F.silu(z), gnorm,
                  cfg["norm_eps"]))
    return linear(y, wo, control)


def attention(cfg, control, u, wq, wk, wv, wo):
    """Causal GQA over the normed input ``u`` (B, S, D), no positions,
    scores times ``attention_multiplier``; query head h reads KV head
    h // (H / K)."""
    b, s_len, _ = u.shape
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rnd(linear(u, wq, control), control).reshape(b, s_len, h, hd)
    k = rnd(linear(u, wk, control), control).reshape(b, s_len, kh, hd)
    v = rnd(linear(u, wv, control), control).reshape(b, s_len, kh, hd)
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(s_len, s_len, dtype=torch.bool,
                        device=u.device).tril()
    p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    o = rnd(torch.einsum("bhqk,bkhd->bqhd", p, v), control)
    return linear(o.reshape(b, s_len, h * hd), wo, control)


def moe(cfg, control, u, router, w_gate, w_up, w_down, s_gate, s_up,
        s_down):
    """(the held experts' part of the MoE plus the shared expert, the
    layer's Switch loss) for the normed input ``u`` (B, S, D)."""
    e = cfg["moe"]
    b, s_len, d = u.shape
    uf = u.reshape(-1, d)
    logits = uf @ router                                    # float32
    top, idx = torch.topk(logits, e["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    routed = F.one_hot(idx, e["n_experts"]).float().mean(dim=(0, 1))
    aux = e["n_experts"] * (routed * probs.mean(dim=0)).sum()
    out = torch.zeros_like(uf)
    for j in range(w_gate.shape[0]):
        hit = idx == j                                      # (T, k)
        tok = hit.any(dim=-1).nonzero()[:, 0]
        g = (gates * hit).sum(dim=-1)[tok]
        xe = uf[tok]
        y = linear(F.silu(linear(xe, w_gate[j], control))
                   * linear(xe, w_up[j], control), w_down[j], control)
        out = out.index_add(0, tok, rnd(y, control) * g[:, None])
    shared = linear(F.silu(linear(uf, s_gate, control))
                    * linear(uf, s_up, control), s_down, control)
    return (out + rnd(shared, control)).reshape(b, s_len, d), aux


def block(cfg, control, kind, x, n1, n2, *leaves):
    """One layer: (x after both residual branches, its Switch loss)."""
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    nm = len(STACKS[kind][1])
    mix = mamba_mixer if kind == "mamba_ffn" else attention
    u = rnd(rmsnorm(x, n1, eps), control)
    x = rnd(x + r * rnd(mix(cfg, control, u, *leaves[:nm]), control),
            control)
    u = rnd(rmsnorm(x, n2, eps), control)
    f, aux = moe(cfg, control, u, *leaves[nm:])
    return rnd(x + r * rnd(f, control), control), aux


def loss(P, cfg, tokens, *, control=False, chunk=512):
    """Mean next-token loss of ``tokens`` (B, S) plus the weighted Switch
    losses, under the flat float32 parameters ``P`` (the benchmark's tree
    flattened: "embed/table", "mamba_layers/mamba/wz", ...)."""
    tokens = tokens.long()
    table = P["embed/table"]
    x = rnd(cfg["embedding_multiplier"] * table[tokens], control)
    at = {kind: 0 for kind in STACKS}
    aux = 0.0
    for kind in layer_kinds(cfg):
        stack, keys = STACKS[kind]
        li = at[kind]
        at[kind] += 1
        leaves = [P[f"{stack}/{k}"][li]
                  for k in ("norm1/scale", "norm2/scale") + keys + FFN_KEYS]
        x, a = checkpoint(block, cfg, control, kind, x, *leaves,
                          use_reentrant=False)
        aux = aux + a
    h = rnd(rmsnorm(x, P["final_norm/scale"], cfg["norm_eps"]), control)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones_like(tokens, dtype=torch.float32)
    mask[:, -1] = 0.0

    def nll(hc, lab, m):
        lg = (hc @ table.T) / cfg["logits_scaling"]
        return ((torch.logsumexp(lg, -1)
                 - lg.gather(-1, lab[..., None])[..., 0]) * m).sum()

    tot = 0.0
    for c0 in range(0, tokens.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + checkpoint(nll, h[:, sl], labels[:, sl], mask[:, sl],
                               use_reentrant=False)
    return tot / mask.sum() + cfg["moe"]["aux_loss_coef"] * aux


def logits(P, cfg, tokens):
    """(B, S, V) float32 logits of ``tokens``, no recomputation (a small
    size's comparison)."""
    tokens = tokens.long()
    table = P["embed/table"]
    x = cfg["embedding_multiplier"] * table[tokens]
    at = {kind: 0 for kind in STACKS}
    for kind in layer_kinds(cfg):
        stack, keys = STACKS[kind]
        leaves = [P[f"{stack}/{k}"][at[kind]]
                  for k in ("norm1/scale", "norm2/scale") + keys + FFN_KEYS]
        at[kind] += 1
        x, _ = block(cfg, False, kind, x, *leaves)
    h = rmsnorm(x, P["final_norm/scale"], cfg["norm_eps"])
    return (h @ table.T) / cfg["logits_scaling"]


def train(params, cfg, batches, opt, *, control=False):
    """AdamW steps of the reference from ``params`` (the benchmark's tree,
    any dtype; upcast to float32 copies), one per batch, as
    ``mamba2.train``: the losses, each leaf's first gradient as AdamW
    takes it (m / (1 - b1) after step 1) and each leaf's change, by leaf
    path."""
    with no_tf32():
        P = {k: v.detach().float().clone().requires_grad_(True)
             for k, v in flatten(params).items()}
        P0 = {k: v.detach().clone() for k, v in P.items()}
        M = {k: torch.zeros_like(v) for k, v in P.items()}
        V = {k: torch.zeros_like(v) for k, v in P.items()}
        losses, first = [], None
        for i, tokens in enumerate(batches):
            lv = loss(P, cfg, tokens, control=control)
            grads = torch.autograd.grad(lv, list(P.values()))
            losses.append(float(lv.detach()))
            step = i + 1
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = torch.clamp(opt["clip_norm"] / gnorm.clamp_min(1e-9),
                                    max=1.0)
                lr = lr_at(opt, step)
                bc1 = 1 - opt["b1"] ** step
                bc2 = 1 - opt["b2"] ** step
                for (k, p), g in zip(P.items(), grads):
                    g = g * scale
                    M[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    V[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                    upd = (M[k] / bc1) / (torch.sqrt(V[k] / bc2) + opt["eps"])
                    if decays(k):
                        upd = upd + opt["weight_decay"] * p
                    p.sub_(lr * upd)
            if first is None:
                first = {k: float(m.norm()) / (1 - opt["b1"])
                         for k, m in M.items()}
            del grads
        change = {k: float((P[k].detach() - P0[k]).norm()) for k in P}
    return {"losses": losses, "first_grad": first, "change": change}

