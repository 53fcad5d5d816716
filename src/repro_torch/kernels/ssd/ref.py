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
