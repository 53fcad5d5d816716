"""Mamba-2 (SSD, state-space duality) block: the chunked prefill scan and
the O(1) decode step.

Twin of ``repro.models.ssm``: ``mamba_init``, ``causal_conv``,
``ssd_decode``, ``mamba_apply``, ``mamba_decode`` and ``mamba_cache_init``
with the reference's separate projections (wz/wx/wB/wC/wdt) and its
dtypes: dt goes through softplus in float32, ``A = -exp(A_log)``, the
skip ``y + D x`` is taken in x's dtype, the gated norm upcasts, and
``dt_bias``, ``A_log`` and ``D`` stay float32 whatever the weights' dtype
is.  ``ssd_chunked`` is re-exported from ``kernels/ssd/ref.py`` (the
reverse of the reference's layout, which would be an import cycle here).
``mamba_apply``'s scan goes through ``kernels/ssd/ops.ssd``: the
hand-written CUDA kernel for a CUDA tensor, the plain chunked scan for a
CPU tensor.  ``mamba_specs`` and ``mamba_cache_specs`` are the
reference's partition specs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked  # noqa: F401 (re-export)
from repro_torch.models import layers
from repro_torch.models.sharding import MeshRules, P

# leaves that stay float32 whatever the weights' dtype: the SSM's decay
# and skip parameters (reference ``mamba_init``) and the MoE router
# (reference ``moe_init``); read by ``cast`` and ``params.from_reference``
FLOAT32_LEAVES = ("dt_bias", "A_log", "D", "router")


def cast(tree, device, dtype):
    """Every leaf to ``dtype`` on ``device``, except ``FLOAT32_LEAVES``;
    tuples (a hybrid model's slots) stay tuples."""
    if isinstance(tree, dict):
        return {k: (v.to(device=device, dtype=torch.float32)
                    if k in FLOAT32_LEAVES else cast(v, device, dtype))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(cast(v, device, dtype) for v in tree)
    return tree.to(device=device, dtype=dtype)


# ------------------------------------------------------------- weights ----
def mamba_specs(cfg: ModelConfig, rules: MeshRules) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    tp_i = rules.tp(s.d_inner(d))
    tp_h = rules.tp(s.n_heads(d))
    return {
        "wz": P(rules.fsdp(d), tp_i),
        "wx": P(rules.fsdp(d), tp_i),
        "wB": P(rules.fsdp(d), None),
        "wC": P(rules.fsdp(d), None),
        "wdt": P(rules.fsdp(d), tp_h),
        # conv channels stay replicated (small)
        "conv_w": P(None, None),
        "conv_b": P(None),
        "dt_bias": P(tp_h),
        "A_log": P(tp_h),
        "D": P(tp_h),
        "norm": {"scale": P(tp_i)},
        "wo": P(tp_i, rules.fsdp(d)),
    }


def mamba_cache_specs(cfg: ModelConfig, rules: MeshRules, batch: int) -> dict:
    nh = cfg.ssm.n_heads(cfg.d_model)
    return {
        "conv": P(rules.batch(batch), None, None),
        "ssm": P(rules.batch(batch), rules.tp(nh), None, None),
    }


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *,
               dtype=torch.float32):
    """The reference's key tree, shapes and init scales; random numbers
    from ``gen`` (they differ from JAX's), on the generator's device."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    dev = gen.device
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
    u = torch.rand(nh, generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p = {
        "wz": layers.dense_init(gen, d, di),
        "wx": layers.dense_init(gen, d, di),
        "wB": layers.dense_init(gen, d, gn),
        "wC": layers.dense_init(gen, d, gn),
        "wdt": layers.dense_init(gen, d, nh),
        "conv_w": torch.randn(s.d_conv, di + 2 * gn, generator=gen,
                              device=dev) / math.sqrt(s.d_conv),
        "conv_b": torch.zeros(di + 2 * gn, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # inverse softplus
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones(nh, device=dev),
        "norm": {"scale": torch.ones(di, device=dev)},
        "wo": layers.dense_init(gen, di, d),
    }
    return cast(p, dev, dtype)


# ---------------------------------------------------------------- conv ----
def causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv.  x (B,S,C); w (K,C); b (C,).

    ``state`` (B,K-1,C): trailing context from the previous segment
    (decode), taken in x's dtype.  Returns (silu(y), new_state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], k - 1, x.shape[-1])
    xe = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+K-1, C)
    # a copy, so that a kept state does not keep the whole of xe alive
    new_state = xe[:, -(k - 1):].clone() if k > 1 else state
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xe[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return F.silu(y), new_state


# ----------------------------------------------------------------- SSD ----
def ssd_decode(x, dt, A, Bm, C, state):
    """Single-token SSD update.  x (B,H,P); dt (B,H); Bm/C (B,G,N);
    state (B,H,P,N) float32.  Returns (y, new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    bh = Bm.repeat_interleave(rep, dim=1).float()            # (B,H,N)
    ch = C.repeat_interleave(rep, dim=1).float()
    da = torch.exp(dt * A[None, :])                          # (B,H)
    upd = (dt[:, :, None, None] * bh[:, :, None, :]
           * x.float()[..., None])                           # (B,H,P,N)
    new_state = da[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state


# ------------------------------------------------------------- block ------
def _gated_norm(scale, y, z, eps):
    return layers.rmsnorm({"scale": scale}, y * F.silu(z), eps)


def _proj_all(params, cfg: ModelConfig, u):
    """u (B,S,D) -> z, x, B, C (conv inputs), dt."""
    return tuple(u @ params[k].to(u.dtype)
                 for k in ("wz", "wx", "wB", "wC", "wdt"))


def _dt_a(params, dt):
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    return dt, -torch.exp(params["A_log"])


def mamba_apply(params, cfg: ModelConfig, u, *, init=None):
    """Full-sequence mamba2 block.  u (B,S,D) -> (out, final_cache).

    ``init``/returned cache: {"conv": (B,K-1,C), "ssm": (B,H,P,N) fp32}.
    x, B and C go to the scan as strided views of the conv's output."""
    s = cfg.ssm
    b, sl, d = u.shape
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    z, xp, Bp, Cp, dt = _proj_all(params, cfg, u)
    xbc = torch.cat([xp, Bp, Cp], dim=-1)
    xbc, conv_state = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  state=None if init is None
                                  else init["conv"])
    xp, Bp, Cp = torch.split(xbc, [di, gn, gn], dim=-1)
    dt, A = _dt_a(params, dt)
    x4 = xp.reshape(b, sl, nh, s.head_dim)
    y, final = ops.ssd(x4, dt, A, Bp.reshape(b, sl, s.n_groups, s.d_state),
                       Cp.reshape(b, sl, s.n_groups, s.d_state),
                       chunk=s.chunk_size,
                       init_state=None if init is None else init["ssm"])
    y = y + params["D"][None, None, :, None].to(y.dtype) * x4
    y = _gated_norm(params["norm"]["scale"], y.reshape(b, sl, di), z,
                    cfg.norm_eps)
    return y @ params["wo"].to(y.dtype), {"conv": conv_state, "ssm": final}


def mamba_decode(params, cfg: ModelConfig, u, cache):
    """One-token step.  u (B,1,D); cache {"conv","ssm"}."""
    s = cfg.ssm
    b, _, d = u.shape
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    z, xp, Bp, Cp, dt = _proj_all(params, cfg, u)
    xbc = torch.cat([xp, Bp, Cp], dim=-1)
    xbc, conv_state = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  state=cache["conv"])
    xp, Bp, Cp = torch.split(xbc, [di, gn, gn], dim=-1)
    dt, A = _dt_a(params, dt)
    x3 = xp[:, 0].reshape(b, nh, s.head_dim)
    y, new_state = ssd_decode(
        x3, dt[:, 0], A, Bp[:, 0].reshape(b, s.n_groups, s.d_state),
        Cp[:, 0].reshape(b, s.n_groups, s.d_state), cache["ssm"])
    y = y + params["D"][None, :, None].to(y.dtype) * x3
    y = _gated_norm(params["norm"]["scale"], y.reshape(b, 1, di), z,
                    cfg.norm_eps)
    return (y @ params["wo"].to(y.dtype),
            {"conv": conv_state, "ssm": new_state})


def mamba_cache_init(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
                     device=None):
    s = cfg.ssm
    d = cfg.d_model
    c = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, c, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, s.n_heads(d), s.head_dim, s.d_state,
                           dtype=torch.float32, device=device),
    }
