"""Plain float32 reference of Mamba-2 training (mamba2-1.3b): forward,
next-token loss, gradients by autograd, and AdamW.

Each block: RMSNorm; the z, x, B, C and dt projections; a depthwise causal
convolution of width ``d_conv`` over (x, B, C) with SiLU; dt = softplus(dt
+ dt_bias) and A = -exp(A_log); the SSD scan, written here as the Mamba-2
paper's minimal chunked algorithm (segment sums within a chunk, a
recurrence over chunk states); the skip D x; RMSNorm of y * silu(z); the
output projection; the residual.  The embedding is tied to the LM head,
whose softmax runs over the whole padded table (as the port's does).  The
loss is the mean over every position but each row's last.  AdamW: global
norm clipping, linear warm-up then cosine decay, bias-corrected moments,
decoupled weight decay on every leaf whose path holds neither "norm" nor
"bias" and does not end in "scale".  Every product is float32 with TF32
off; each block is recomputed in the backward to fit.  Imports torch
alone.

``control=True`` computes one notch below the configuration's bf16: at
every point where the program holds a bf16 tensor (the residual stream,
each norm's and projection's output, the convolution's, the scan's input
and output, the matrix products' weights) the control holds fp8 (e4m3,
scaled per row, per output column for weights; e5m2 gradients in the
backward), and where the program keeps float32 (dt and A, the norms'
arithmetic, the LM head and the loss) so does the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense import no_tf32

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _q(t, dim, fmt):
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / torch.finfo(fmt).max
    return (t / s).to(fmt).float() * s


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _q(x, -1, E4M3)

    @staticmethod
    def backward(ctx, g):
        return _q(g, -1, E5M2)


def rnd(t, control):
    """``t`` where the program holds bf16: fp8 in the control."""
    return _Fp8Round.apply(t) if control else t


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _q(x, -1, E4M3), _q(w, 0, E4M3)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _q(g, -1, E5M2)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def linear(x, w, control):
    return _Fp8Matmul.apply(x, w) if control else x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def segsum(x):
    """x (..., T) -> (..., T, T): out[i, j] = x[j+1] + ... + x[i] for
    i >= j, -inf above the diagonal."""
    t = x.shape[-1]
    rows = x[..., None].expand(*x.shape, t)          # [..., i, j] = x[i]
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    s = torch.cumsum(rows.masked_fill(~low, 0), dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return s.masked_fill(~diag, float("-inf"))


def ssd(x, dt, A, B, C, chunk):
    """y (b, s, h, p) of the Mamba-2 scan h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t^T, y_t = h_t C_t, from a zero state; B and C (b, s, g, n)
    serve heads h // (H / G)."""
    b, s_len, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    nc = s_len // chunk
    X = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    Bc = Bh.reshape(b, nc, chunk, h, -1)
    Cc = Ch.reshape(b, nc, chunk, h, -1)
    a = (dt * A).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # b h c l
    cum = torch.cumsum(a, dim=-1)
    Lm = torch.exp(segsum(a))                                # b h c l s
    cb = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb * Lm, X)
    decay = torch.exp(cum[..., -1:] - cum)                   # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))  # b h c+1 c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s_len, h, p)


LAYER_KEYS = ("norm/scale", "mamba/wz", "mamba/wx", "mamba/wB", "mamba/wC",
              "mamba/wdt", "mamba/conv_w", "mamba/conv_b", "mamba/dt_bias",
              "mamba/A_log", "mamba/D", "mamba/norm/scale", "mamba/wo")


def block(cfg, control, x, norm, wz, wx, wB, wC, wdt, conv_w, conv_b,
          dt_bias, A_log, D, gnorm, wo):
    s = cfg["ssm"]
    eps = cfg["norm_eps"]
    b, s_len, d = x.shape
    di = s["expand"] * d
    nh, gn = di // s["head_dim"], s["n_groups"] * s["d_state"]
    def q(t):
        return rnd(t, control)

    u = q(rmsnorm(x, norm, eps))
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
    y = q(rmsnorm(y.reshape(b, s_len, di) * F.silu(z), gnorm, eps))
    return q(x + q(linear(y, wo, control)))


def loss(P, cfg, tokens, *, control=False, chunk=512):
    """Mean next-token loss of ``tokens`` (B, S) under the flat float32
    parameters ``P`` ({"embed/table": ..., "layers/mamba/wz": ...})."""
    tokens = tokens.long()
    x = rnd(P["embed/table"][tokens], control)
    for li in range(cfg["n_layers"]):
        leaves = [P["layers/" + k][li] for k in LAYER_KEYS]
        x = checkpoint(block, cfg, control, x, *leaves, use_reentrant=False)
    h = rnd(rmsnorm(x, P["final_norm/scale"], cfg["norm_eps"]), control)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones_like(tokens, dtype=torch.float32)
    mask[:, -1] = 0.0

    def nll(hc, lab, m):
        lg = hc @ P["embed/table"].T
        return ((torch.logsumexp(lg, -1)
                 - lg.gather(-1, lab[..., None])[..., 0]) * m).sum()

    tot = 0.0
    for c0 in range(0, tokens.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + checkpoint(nll, h[:, sl], labels[:, sl], mask[:, sl],
                               use_reentrant=False)
    return tot / mask.sum()


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def lr_at(opt, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5
                        * (1 + math.cos(math.pi * t)))


def decays(path: str) -> bool:
    return not ("norm" in path or "bias" in path or path.endswith("scale"))


def train(params, cfg, batches, opt, *, control=False):
    """AdamW steps of the reference from ``params`` (the benchmark's tree,
    any dtype; upcast to float32 copies), one per batch.  Returns the loss
    of each step, each leaf's first gradient as AdamW takes it (after
    clipping), read back from its first moment after step 1 as
    ``m / (1 - b1)``, and each leaf's change over the steps: the last two
    as norms by leaf path."""
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
