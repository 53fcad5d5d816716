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

A ``dropless`` configuration (granite-4.0-h-small; no JAX twin) takes
``held_apply`` instead: the router scores all ``n_experts`` and the layer
computes only its held block of ``experts_held`` experts (one chip's share
of an expert-parallel deployment; on one chip there is no exchange), with
no capacity: ``dropless`` gathers each held expert's routed rows into a
block of its own, runs the experts' SwiGLU on their blocks alone (bf16 on
the card: three ``torch._grouped_mm``, whose offsets stay on the card;
else one product per expert) and adds the gated rows back to their
tokens; the shared expert runs while the host waits for the rows' split.
It
counts, in ``telemetry.spans``, every routed pair (``moe.pairs``), the
pairs of held experts (``moe.pairs_held``) and the largest held expert's
(``moe.pairs_held_max``, summed over layers).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mlp
from repro_torch.models.sharding import MeshRules, P
from repro_torch.telemetry import spans


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             dtype=torch.float32):
    """The reference's key tree, shapes and init scales, drawn from
    ``gen`` on its device; the router stays float32."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert

    def ew(a, b):
        return (torch.randn((e.n_held, a, b), generator=gen,
                            device=gen.device)
                * (1.0 / math.sqrt(a))).to(dtype)

    p = {
        "router": layers.dense_init(gen, d, e.n_experts),
        "w_gate": ew(d, f),
        "w_up": ew(d, f),
        "w_down": ew(f, d),
    }
    if e.shared_width:
        fs = e.shared_width
        p["shared"] = {
            "w_gate": layers.dense_init(gen, d, fs, dtype=dtype),
            "w_up": layers.dense_init(gen, d, fs, dtype=dtype),
            "w_down": layers.dense_init(gen, fs, d, dtype=dtype),
        }
    return p


def moe_specs(cfg: ModelConfig, rules: MeshRules) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    ep = rules.tp(e.n_held)      # expert-parallel on the model dim
    # d/f inner dims are NOT row-sharded: per-expert weights are small,
    # EP is the sharding
    s = {
        "router": P(None, None),
        "w_gate": P(ep, None, None),
        "w_up": P(ep, None, None),
        "w_down": P(ep, None, None),
    }
    if e.shared_width:
        fs = e.shared_width
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
    if e.dropless:
        return held_apply(params, cfg, x)
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


# rows each held expert's block is padded to (at least one block, so none
# is empty): the grouped products' offsets are then aligned, and in the
# per-expert loop padded row counts repeat
ROW_ALIGN = 128


def _to_host(counts, work):
    """(``counts`` as a host list, ``work()``'s result): on the card the
    copy is enqueued, then ``work``, and the host waits for the copy
    alone, so the card runs ``work`` while the host takes the counts and
    enqueues what follows."""
    if counts.device.type != "cuda":
        return counts.tolist(), work()
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    out = work()
    done.synchronize()
    return host.tolist(), out


def grouped(x) -> bool:
    """Whether the held experts' products on ``x`` are grouped GEMMs
    (``torch._grouped_mm``: bf16 on the card), not one product per
    expert."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def _swiglu_blocks(buf, wg, wu, wd, blocks, blocks_t, group):
    """Each held expert's SwiGLU on its block of ``buf`` (rows in expert
    order, block i ``blocks[i]`` rows): three grouped GEMMs, or three
    products per expert."""
    if group:
        offs = torch.cumsum(blocks_t, 0).to(torch.int32)
        h = (F.silu(torch._grouped_mm(buf, wg, offs=offs))
             * torch._grouped_mm(buf, wu, offs=offs))
        return torch._grouped_mm(h, wd, offs=offs)
    return torch.cat([(F.silu(xe @ wg[i]) * (xe @ wu[i])) @ wd[i]
                      for i, xe in enumerate(buf.split(blocks))])


def dropless(params, xf, gates, local, n_held: int, work=None,
             group=None):
    """xf (T, D); gates (T, k) float32; local (T, k) each pair's expert
    (held: 0 .. n_held - 1).  Every pair whose expert is held is computed:
    its row of ``xf`` goes into its expert's block (blocks padded with zero
    rows to a multiple of ``ROW_ALIGN``), each block through its expert's
    SwiGLU (``group``: grouped GEMMs, default ``grouped(xf)``), times its
    gate, and is added back to its token.  The layer waits once for the
    experts' row counts; what needs no count (the pairs' order and block
    rows, the weights' casts, ``work``: the shared expert) is enqueued
    before it, so the card runs it while the host waits.  Returns ((T, D)
    in xf's dtype, each held expert's pair count, ``work()``'s result)."""
    t, k = local.shape
    dt = xf.dtype
    flat = local.reshape(-1)
    key = torch.where((flat >= 0) & (flat < n_held), flat, n_held)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_held + 1)[:n_held]

    def before_the_wait():
        blocks_t = torch.div(counts + ROW_ALIGN - 1, ROW_ALIGN,
                             rounding_mode="floor").clamp_min(1) * ROW_ALIGN
        # each sorted pair's row: its expert's block start plus its rank
        # among that expert's pairs (held pairs come first in ``order``;
        # the rest take the last entry and are cut off after the wait)
        shift = torch.cat([torch.cumsum(blocks_t, 0) - blocks_t
                           - torch.cumsum(counts, 0) + counts,
                           counts.new_zeros(1)])
        dest = (torch.arange(t * k, device=xf.device)
                + shift[key.index_select(0, order)])
        w = [params[n].to(dt) for n in ("w_gate", "w_up", "w_down")]
        return (blocks_t, dest, torch.div(order, k, rounding_mode="floor"),
                gates.reshape(-1).index_select(0, order).to(dt), w,
                work() if work else None)

    sizes, (blocks_t, dest, rows, g, (wg, wu, wd), extra) = _to_host(
        counts, before_the_wait)
    n = sum(sizes)
    dest, rows, g = dest[:n], rows[:n], g[:n]
    blocks = [max(-(-c // ROW_ALIGN), 1) * ROW_ALIGN for c in sizes]
    buf = xf.new_zeros(sum(blocks), xf.shape[1]).index_copy(0, dest,
                                                            xf[rows])
    y = _swiglu_blocks(buf, wg, wu, wd, blocks, blocks_t,
                       grouped(xf) if group is None else group)
    y = y.index_select(0, dest) * g[:, None]
    out = torch.zeros(t, xf.shape[1], dtype=torch.float32, device=xf.device)
    return out.index_add(0, rows, y.float()).to(dt), sizes, extra


def held_apply(params, cfg: ModelConfig, x
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux loss): routing over all ``n_experts``
    (float32 logits, top-k, gates normalised over the k), the held
    experts' part of the result by :func:`dropless`, plus the shared
    expert, which every chip computes alike."""
    e = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, eidx, aux = route(params, cfg, xf)
    shared = ((lambda: mlp.mlp_apply(params["shared"], cfg, x))
              if e.shared_width else None)
    y, sizes, sh = dropless(params, xf, gates, eidx, e.n_held, shared)
    spans.count("moe.pairs", eidx.numel())
    spans.count("moe.pairs_held", sum(sizes))
    spans.count("moe.pairs_held_max", max(sizes))
    out = y.reshape(b, s, d)
    return (out if sh is None else out + sh), aux.float()
