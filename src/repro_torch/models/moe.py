"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

Twin of ``repro.models.moe``: ``moe_init``, ``_capacity`` and
``moe_apply`` with the reference's semantics, split into the plain
functions it has inline so that a caller can run each stage alone:

  * ``route``    — router logits ``x.float() @ router`` (the router is
    float32 whatever the weights' dtype), softmax, top-k, gates
    normalised by ``max(sum, 1e-9)`` before any drop, and the Switch
    load-balancing loss ``E * sum(frac * me)``;
  * ``dispatch`` — the reference's ``_dispatch_one_group`` over every
    group at once: each (token, choice) pair in flat token-major order
    takes the next row of its expert's capacity buffer; pairs past an
    expert's capacity go to the dump row ``E*C`` and their gate is
    zeroed, with no renormalisation;
  * ``experts``  — the SwiGLU expert products, batched over experts;
  * ``combine``  — each pair's expert output gathered back to its token,
    scaled by its gate and summed over the k choices.

Tokens are grouped batch-major into groups of up to ``group_size`` (4096
halved until it divides the token count); each group has its own
capacity ``max(round_up(ceil(Tg*k*factor/E), 8), 8)``.  Which pairs drop
therefore depends on every token of the group, padding included, exactly
as in the reference.  The scatter is ``index_add_`` into zeros: every
destination but the dump row is unique, so it is a copy, and the dump
row is discarded.  ``moe_specs`` is the reference's expert-parallel
sharding; ``frac_mean`` lets a rank that holds a block of the batch take
the load-balancing loss's routed fractions over the whole batch, as the
reference's one program does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mlp
from repro_torch.models.sharding import MeshRules, P


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             dtype=torch.float32):
    """The reference's key tree, shapes and init scales, drawn from
    ``gen`` on its device; the router stays float32."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert

    def ew(a, b):
        return (torch.randn((e.n_experts, a, b), generator=gen,
                            device=gen.device)
                * (1.0 / math.sqrt(a))).to(dtype)

    p = {
        "router": layers.dense_init(gen, d, e.n_experts),
        "w_gate": ew(d, f),
        "w_up": ew(d, f),
        "w_down": ew(f, d),
    }
    if e.n_shared_experts:
        fs = e.n_shared_experts * f
        p["shared"] = {
            "w_gate": layers.dense_init(gen, d, fs, dtype=dtype),
            "w_up": layers.dense_init(gen, d, fs, dtype=dtype),
            "w_down": layers.dense_init(gen, fs, d, dtype=dtype),
        }
    return p


def moe_specs(cfg: ModelConfig, rules: MeshRules) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    ep = rules.tp(e.n_experts)   # expert-parallel on the model dim
    # d/f inner dims are NOT row-sharded: per-expert weights are small,
    # EP is the sharding
    s = {
        "router": P(None, None),
        "w_gate": P(ep, None, None),
        "w_up": P(ep, None, None),
        "w_down": P(ep, None, None),
    }
    if e.n_shared_experts:
        fs = e.n_shared_experts * f
        s["shared"] = {
            "w_gate": P(rules.fsdp(d), rules.tp(fs)),
            "w_up": P(rules.fsdp(d), rules.tp(fs)),
            "w_down": P(rules.tp(fs), rules.fsdp(d)),
        }
    return s


def _capacity(tg: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(tg * top_k * factor / n_experts))
    return max(_round_up(c, 8), 8)


def group_size_for(t: int, group_size: int = 4096) -> int:
    """Tokens per dispatch group: ``min(group_size, t)`` halved until it
    divides ``t``."""
    gsz = min(group_size, t)
    while t % gsz:
        gsz //= 2
    return gsz


def route(params, cfg: ModelConfig, xf, frac_mean=None):
    """xf (T, D) -> gates (T, k) float32 normalised before any drop,
    expert ids (T, k) int64, aux loss (float32 scalar).  ``frac_mean``
    maps this block's routed fractions (E,) to the whole batch's (the
    mean over the ranks that split the batch); they carry no gradient."""
    e = cfg.moe
    logits = xf.float() @ params["router"].float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, e.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)                                     # (E,)
    frac = F.one_hot(eidx, e.n_experts).float().mean(dim=(0, 1))
    if frac_mean is not None:
        frac = frac_mean(frac)
    aux = e.n_experts * (frac * me).sum()
    return gates, eidx, aux


def dispatch(xg, gates, eidx, n_experts: int, capacity: int):
    """xg (G, Tg, D); gates/eidx (G, Tg, k).  Returns (buf (G, E*C+1, D),
    dest (G, Tg*k) with the dump row ``E*C`` for dropped pairs, gates with
    the dropped pairs' zeroed)."""
    ng, tg, k = eidx.shape
    d = xg.shape[-1]
    flat_e = eidx.reshape(ng, tg * k)
    oh = F.one_hot(flat_e, n_experts)                          # (G,Tg*k,E)
    pos = (oh.cumsum(dim=1) * oh).sum(dim=-1) - 1              # in expert
    dropped = pos >= capacity
    dump = n_experts * capacity
    dest = torch.where(dropped, dump, flat_e * capacity + pos)
    gates = torch.where(dropped.reshape(ng, tg, k), 0.0, gates)
    rows = dump + 1
    flat = (dest + rows * torch.arange(ng, device=dest.device)[:, None])
    buf = torch.zeros(ng * rows, d, dtype=xg.dtype, device=xg.device)
    buf = buf.index_add(0, flat.reshape(-1),
                        xg.repeat_interleave(k, dim=1).reshape(-1, d))
    return buf.reshape(ng, rows, d), dest, gates


def experts(params, ein):
    """ein (G, E, C, D) -> the SwiGLU expert outputs (G, E, C, D)."""
    dt = ein.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", ein,
                            params["w_gate"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", ein, params["w_up"].to(dt))
    return torch.einsum("gecf,efd->gecd", h, params["w_down"].to(dt))


def combine(eout, dest, gates):
    """eout (G, E, C, D); dest (G, Tg*k); gates (G, Tg, k) in the
    activation dtype -> (G, Tg, D): the dump row reads zeros."""
    ng, n_e, cap, d = eout.shape
    tg, k = gates.shape[1:]
    eflat = torch.cat([eout.reshape(ng, n_e * cap, d),
                       eout.new_zeros(ng, 1, d)], dim=1)
    y = torch.gather(eflat, 1, dest[..., None].expand(ng, tg * k, d))
    y = y.reshape(ng, tg, k, d) * gates[..., None]
    return y.sum(dim=2)


def moe_apply(params, cfg: ModelConfig, x, *, capacity_factor: float = 0.0,
              group_size: int = 4096, frac_mean=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss float32 scalar).
    ``frac_mean``: see :func:`route`."""
    e = cfg.moe
    capacity_factor = capacity_factor or e.capacity_factor
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, eidx, aux = route(params, cfg, xf, frac_mean)
    gsz = group_size_for(t, group_size)
    ng = t // gsz
    cap = _capacity(gsz, e.top_k, e.n_experts, capacity_factor)
    buf, dest, gg = dispatch(xf.reshape(ng, gsz, d),
                             gates.to(xf.dtype).reshape(ng, gsz, e.top_k),
                             eidx.reshape(ng, gsz, e.top_k), e.n_experts,
                             cap)
    eout = experts(params, buf[:, :-1].reshape(ng, e.n_experts, cap, d))
    out = combine(eout, dest, gg).reshape(b, s, d)
    if e.n_shared_experts:
        out = out + mlp.mlp_apply(params["shared"], cfg, x)
    return out, aux.float()
