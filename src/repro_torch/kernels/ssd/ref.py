"""Plain PyTorch versions of the Mamba-2 SSD scan.

Twins of ``repro.kernels.ssd.ref.ssd_sequential`` (the token-by-token
recurrence) and ``repro.models.ssm.ssd_chunked`` (the chunked algorithm
the model runs, with ``init_state`` and the dt = 0 padding of S to a chunk
multiple).  In the reference the chunked scan lives in ``models/ssm.py``
and ``kernels/ssd/ref.py`` re-exports it; here it is the other way round
(``repro_torch.models.ssm`` re-exports it from this module), because
``models/ssm.py`` dispatches through ``kernels/ssd/ops.py``, which needs
this module: the reference's layout would be an import cycle.

These are the CPU path of ``ops.ssd`` and the yardstick the CUDA kernel is
held to.  Inputs: x (B,S,H,P); dt (B,S,H) after softplus; A (H,)
negative; Bm, C (B,S,G,N) with G dividing H, head h reading group
h // (H/G).  Everything is computed in float32; y comes back in x's dtype
and the final state (B,H,P,N) in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_sequential(x, dt, A, Bm, C):
    """Token-by-token recurrence.  Returns (y, final_state)."""
    b, s_len, h, pd = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    state = torch.zeros(b, h, pd, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s_len):
        bh = Bm[:, t].repeat_interleave(rep, dim=1).float()       # (B,H,N)
        ch = C[:, t].repeat_interleave(rep, dim=1).float()
        dtt = dt[:, t].float()                                    # (B,H)
        da = torch.exp(dtt * A[None, :])
        upd = (dtt[..., None, None] * bh[:, :, None, :]
               * x[:, t].float()[..., None])
        state = da[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch))
    y = torch.stack(ys, dim=1) if ys else x.float()
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, Bm, C, *, chunk: int, init_state=None):
    """Chunked SSD scan (Mamba-2 algorithm 1).  Returns (y, final_state).

    Heads are grouped as (G, H/G) views instead of the reference's
    ``jnp.repeat`` of B and C, which is the same arithmetic without the
    repeated copies."""
    b, s_len, h, pd = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-s_len) % chunk
    if pad:                       # dt = 0: identity decay, no input
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.float().reshape(b, nc, chunk, g, rep, pd)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = Bm.float().reshape(b, nc, chunk, g, n)
    Cc = C.float().reshape(b, nc, chunk, g, n)

    cum = torch.cumsum(dtc * A.float()[None, None, None, :], dim=2)
    seg_sum = cum[:, :, -1]                                   # (B,nc,H)

    # intra-chunk (diagonal) term: decay[i,j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(li - lj),
                        torch.zeros((), device=x.device))     # (B,nc,L,L,H)
    scores = torch.einsum("bclgn,bcmgn->bclmg", Cc, Bc)       # (B,nc,L,L,G)
    w = (scores[..., None]
         * (decay * dtc[:, :, None, :, :]).reshape(b, nc, chunk, chunk, g,
                                                   rep))
    y_diag = torch.einsum("bclmgr,bcmgrp->bclgrp", w, xc)

    # per-chunk input states: sum_j exp(seg - cum_j) dt_j B_j x_j
    dstate = (torch.exp(seg_sum[:, :, None, :] - cum) * dtc).reshape(
        b, nc, chunk, g, rep)
    states = torch.einsum("bclgr,bclgn,bclgrp->bcgrpn", dstate, Bc, xc)
    states = states.reshape(b, nc, h, pd, n)

    # inter-chunk recurrence, emitting the state before each chunk
    st = (torch.zeros(b, h, pd, n, dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(st)
        st = torch.exp(seg_sum[:, c])[:, :, None, None] * st + states[:, c]
    prev = torch.stack(prevs, dim=1).reshape(b, nc, g, rep, pd, n)

    # inter-chunk (off-diagonal) output: C_i . S_prev * exp(cum_i)
    y_off = (torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev)
             * torch.exp(cum).reshape(b, nc, chunk, g, rep)[..., None])
    y = (y_diag + y_off).reshape(b, nc * chunk, h, pd)[:, :s_len]
    return y.to(x.dtype), st


def ssd_chunked_bwd(x, dt, A, Bm, C, dy, *, chunk: int, init_state=None,
                    dfinal_state=None):
    """The chunked SSD scan's backward, in explicit steps: the yardstick of
    the CUDA backward kernel and the CPU backward of ``ops.ssd``.

    ``dy`` (B,S,H,P) is the gradient of y, ``dfinal_state`` (B,H,P,N) that
    of the final state (None: zero).  Returns (dx, ddt, dA, dBm, dC,
    dinit): dx, dBm and dC in their inputs' dtypes, ddt, dA and dinit (the
    gradient of ``init_state``, zeros when it is None) in float32.

    Per chunk, with cum the inclusive prefix sum of dt A, decay[t,s] =
    exp(cum_t - cum_s) for s <= t (0 above the diagonal, masked before the
    exp), h_in / h_out the states entering and leaving the chunk and
    dh_out the gradient of h_out (the next chunk's dh_in):
      g_s     = sum_t (C_t . B_s) decay[t,s] dy_t + exp(seg - cum_s) dh_out B_s
      dx_s    = dt_s g_s;   ddt_s = x_s . g_s  (+ A R_s, below)
      dC_t    = sum_s decay[t,s] dt_s (dy_t . x_s) B_s + exp(cum_t) dy_t h_in
      dB_s    = dt_s [sum_t decay[t,s] (dy_t . x_s) C_t
                      + exp(seg - cum_s) x_s dh_out]
      dh_in   = exp(seg) dh_out + sum_t exp(cum_t) dy_t (x) C_t  (serial)
      dcum_t  = dy_t . y_t - x_t . dx_t,  + <dh_out, h_out> at t = L - 1
      R_u     = sum_{t >= u} dcum_t;  ddt_u += A R_u;  dA = sum dt_u R_u
    with y recomputed in float32.  dB and dC sum the heads of each group.
    Positions past S are dt = 0 (the forward's padding) and get no
    gradient."""
    b, s_len, h, pd = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-s_len) % chunk
    f = [t.float() for t in (x, Bm, C, dy)]
    dtf = dt.float()
    if pad:
        f = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in f]
        dtf = F.pad(dtf, (0, 0, 0, pad))
    xf, Bf, Cf, dyf = f
    nc = xf.shape[1] // chunk
    xc = xf.reshape(b, nc, chunk, h, pd)
    dyc = dyf.reshape(b, nc, chunk, h, pd)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bh = Bf.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = Cf.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Af = A.float()

    cum = torch.cumsum(dtc * Af, dim=2)                       # (B,nc,L,H)
    seg = cum[:, :, -1]                                       # (B,nc,H)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [t, s]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh)           # C_t . B_s
    tail = torch.exp(seg[:, :, None, :] - cum)                # exp(seg-cum_s)

    # the states entering each chunk, and the one leaving the last
    own = torch.einsum("bcsh,bcshp,bcshn->bchpn", tail * dtc, xc, Bh)
    st = (torch.zeros(b, h, pd, n, dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(st)
        st = torch.exp(seg[:, c])[..., None, None] * st + own[:, c]
    h_in = torch.stack(h_in, dim=1)                           # (B,nc,H,P,N)
    h_out = torch.cat([h_in[:, 1:], st[:, None]], dim=1)

    # y in float32, for dcum
    y = (torch.einsum("bctsh,bcshp->bcthp", cb * decay * dtc[:, :, None],
                      xc)
         + torch.einsum("bcthn,bchpn->bcthp", Ch, h_in)
         * torch.exp(cum)[..., None])

    # the reverse serial pass over the chunks: dh_out of each chunk
    q = torch.einsum("bcth,bcthp,bcthn->bchpn", torch.exp(cum), dyc, Ch)
    dh = (torch.zeros_like(st) if dfinal_state is None
          else dfinal_state.float())
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = torch.exp(seg[:, c])[..., None, None] * dh + q[:, c]
    dinit = dh
    dh_out = torch.stack(dh_out, dim=1)                       # (B,nc,H,P,N)

    gs = (torch.einsum("bctsh,bcthp->bcshp", cb * decay, dyc)
          + torch.einsum("bcshn,bchpn->bcshp", Bh, dh_out)
          * tail[..., None])
    dx = dtc[..., None] * gs
    xg = (xc * gs).sum(-1)                                    # (B,nc,L,H)
    dyx = torch.einsum("bcthp,bcshp->bctsh", dyc, xc) * decay
    dC = (torch.einsum("bctsh,bcsh,bcshn->bcthn", dyx, dtc, Bh)
          + torch.einsum("bcthp,bchpn->bcthn", dyc, h_in)
          * torch.exp(cum)[..., None])
    dB = dtc[..., None] * (
        torch.einsum("bctsh,bcthn->bcshn", dyx, Ch)
        + torch.einsum("bcshp,bchpn->bcshn", xc, dh_out) * tail[..., None])

    dcum = (dyc * y).sum(-1) - dtc * xg
    dcum[:, :, -1] += (dh_out * h_out).sum((-2, -1))
    rsum = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = xg + Af * rsum
    dA = (dtc * rsum).sum((0, 1, 2))

    def out(t, like):
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s_len].to(like)

    def grouped(t):
        return t.reshape(b, nc, chunk, g, rep, n).sum(4)

    return (out(dx, x.dtype), out(ddt, torch.float32), dA,
            out(grouped(dB), Bm.dtype), out(grouped(dC), C.dtype), dinit)
