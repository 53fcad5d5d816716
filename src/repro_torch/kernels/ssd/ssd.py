"""CUDA Mamba-2 SSD chunked-scan kernel for Hopper: the wrapper.

Replaces the Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd/ssd.py:34``), the prefill hot spot of a mamba
model: one launch per mamba layer per ``prefill`` call.  The kernel is
``repro_torch/csrc/ssd.cu``, built with ``nvcc`` for ``sm_90a`` at first
use (:mod:`repro_torch.kernels._build`) and bound through ``ctypes``.

What bounds it on an H100 at the main prefill shape: bytes and operations
about equally (86 GFLOP of visible work, 298 MB of least traffic in
bf16).  The input's dtype picks the kernels:

* bf16: the chunk-parallel SSD split, four kernels on one stream with
  every product on ``wgmma``: C B^T once per (chunk, B/C group) for all
  its heads (``ssd_cb_kernel``), each chunk's own state
  (``ssd_state_kernel``), the serial hand-over of the state from chunk to
  chunk (``ssd_pass_kernel``), and y (``ssd_scan_kernel``).  The float32
  operands (the decayed scores, w B and the states) go through two bf16
  products as hi + lo, which keeps the float32 tolerances.  Float32
  workspaces (``workspace_sizes``) hold C B^T, the states, cum and dt.
* float32: ``ssd_kernel``, one block per (head, batch row) walking the
  chunks in float32 FMA with the state in shared memory.

The kernels read x, B and C through their strides (last dimension
contiguous, 16-byte aligned rows, else a copy: ``kernels.readable``), so
``mamba_apply``'s views split out of the convolution's output go in with
no copy; dt may be strided too.  A ragged S is handled
inside the kernel (positions past S count as dt = 0), with no padded copy.
Shapes are fixed at build time: (P, N) in ``SHAPES`` and the chunk in
``CHUNKS``; anything else raises.  This wrapper launches or raises: it
never falls back to the plain version (``ref.py``), and it does not
synchronise.  ``LAUNCHES`` counts its calls (one a call, whatever the
number of CUDA kernels), ``TC_LAUNCHES`` and ``FMA_LAUNCHES`` those of
each path.

``ssd_scan_bwd`` is the scan's gradient: ``repro_torch/csrc/ssd_bwd.cu``
(no Pallas counterpart: the reference differentiates its jnp scan), with
the same shapes, strides and ragged S as the forward.  The dtype picks
the path, and a call launches it or raises:

* bf16: chunk-parallel on the tensor cores.  The forward's own
  ``ssd_cb_kernel``, ``ssd_state_kernel`` and ``ssd_pass_kernel``
  (``repro_ssd_states`` in ``ssd.cu``) rebuild C B^T, cum, dt and the
  state entering each chunk; then five kernels of ``ssd_bwd.cu``: each
  chunk's share of dh_in, the serial reverse pass of dh, the key side (dx,
  dB, x . g) and the query side (y in float32, dC, dy . y) per 64-row
  tile, and the suffix sums of dcum (ddt, dA).  Float32 workspaces
  (``workspace_sizes`` and ``bwd_workspace_sizes``).
* float32: ``ssd_bwd_kernel``, one block per (head, batch row) walking
  the chunks in float32 FMA.

Both write per-head float32 partials of dB and dC and per-row (bf16: per
row and chunk) ones of dA, which this wrapper sums over the heads of each
group and over the batch: no atomics, so the card gives the same bits
from run to run.  ``BWD_LAUNCHES`` counts its calls, ``BWD_TC_LAUNCHES``
and ``BWD_FMA_LAUNCHES`` those of each path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, readable

LAUNCHES = 0
TC_LAUNCHES = 0             # bf16: the four tensor-core kernels
FMA_LAUNCHES = 0            # float32: ssd_kernel
BWD_LAUNCHES = 0            # the backward, either path
BWD_TC_LAUNCHES = 0         # bf16: the backward's tensor-core kernels
BWD_FMA_LAUNCHES = 0        # float32: ssd_bwd_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((64, 128), (64, 64), (64, 32), (32, 16))     # (head_dim, d_state)
CHUNKS = (32, 64, 128, 256)
_FN = None
_STATES_FN = None
_BWD_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssd").repro_ssd_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _states_fn():
    global _STATES_FN
    if _STATES_FN is None:
        fn = _build.load("ssd").repro_ssd_states
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        _STATES_FN = fn
    return _STATES_FN


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = _build.load("ssd_bwd").repro_ssd_scan_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def workspace_sizes(b, s, h, p, g, n, chunk):
    """Float32 elements of the bf16 path's workspaces: C B^T (B, nc, G, LT,
    LT), the states (B, nc, H, P, N), cum and dt (B, H, nc, LT) each, with
    nc = ceil(S / L) chunks of LT = L rounded up to 64 rows."""
    nc, lt = -(-s // chunk), -(-chunk // 64) * 64
    return (b * nc * g * lt * lt, b * nc * h * p * n, b * h * nc * lt,
            b * h * nc * lt)


def bwd_workspace_sizes(b, s, h, p, n, chunk):
    """Float32 elements of the bf16 backward's own workspaces: the final
    state (B, H, P, N), dstates (B, nc, H, P, N: each chunk's share of
    dh_in, then the dh leaving it), dy . y and x . g (B, H, nc, LT each),
    and the reverse pass's parts of <dh_out, h_out> (B, H, nc,
    ceil(P N / 256))."""
    nc, lt = -(-s // chunk), -(-chunk // 64) * 64
    return (b * h * p * n, b * nc * h * p * n, b * h * nc * lt,
            b * h * nc * lt, b * h * nc * -(-(p * n) // 256))


def _check(x, dt, A, Bm, C, chunk, init_state):
    name = "ssd_scan"
    dev = x.device
    for t in (x, dt, A, Bm, C) + (() if init_state is None
                                  else (init_state,)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: a tensor is on {t.device}; every "
                             "input must be on the same CUDA device")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, Bm and C must share a dtype of "
                        f"float32 or bfloat16 ({x.dtype}, {Bm.dtype}, "
                        f"{C.dtype})")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != C.shape:
        raise ValueError(f"{name}: x must be (B, S, H, P) and Bm, C "
                         "(B, S, G, N)")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"{name}: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} or Bm {tuple(Bm.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{name}: {h} heads do not group over {g} B/C "
                         "groups")
    if (p, n) not in SHAPES or chunk not in CHUNKS:
        raise ValueError(f"{name}: (head_dim, d_state) = {(p, n)} or chunk "
                         f"{chunk} is not built; the kernel takes (P, N) in "
                         f"{SHAPES} and chunks in {CHUNKS}")
    if b > 65535 or s == 0:
        raise ValueError(f"{name}: batch {b} exceeds the grid's 65535, or "
                         "the sequence is empty")
    if init_state is not None and (init_state.dtype != torch.float32
                                   or tuple(init_state.shape) != (b, h, p, n)):
        raise ValueError(f"{name}: init_state must be float32 "
                         f"(B, H, P, N) = {(b, h, p, n)}")


def ssd_scan(x, dt, A, Bm, C, *, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """The SSD scan on the card.

    x (B,S,H,P); dt (B,S,H) float32 after softplus; A (H,) float32,
    negative; Bm, C (B,S,G,N) in x's dtype; init_state (B,H,P,N) float32
    or None for zeros.  Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) float32)."""
    global LAUNCHES, TC_LAUNCHES, FMA_LAUNCHES
    _check(x, dt, A, Bm, C, chunk, init_state)
    x, Bm, C = (readable(t) for t in (x, Bm, C))
    A = A.contiguous()
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty(b, s, h, p, dtype=x.dtype, device=x.device)
    init = None if init_state is None else init_state.contiguous()
    st = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    vals = [v for t in (x, dt, Bm, C) for v in t.stride()[:3]]
    strides = (ctypes.c_longlong * 12)(*vals)
    ws, ptrs = [], None
    if x.dtype == torch.bfloat16:
        ws = [torch.empty(k, dtype=torch.float32, device=x.device)
              for k in workspace_sizes(b, s, h, p, g, n, chunk)]
        ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in ws))
        TC_LAUNCHES += 1
    else:
        FMA_LAUNCHES += 1
    LAUNCHES += 1
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), C.data_ptr(),
                    None if init is None else init.data_ptr(), y.data_ptr(),
                    st.data_ptr(), ptrs, strides, b, s, h, g, p, n, chunk,
                    DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"repro_ssd_scan launch failed: CUDA error {err}")
    return y, st


def ssd_scan_bwd(x, dt, A, Bm, C, dy, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None,
                 dfinal_state: Optional[torch.Tensor] = None):
    """The SSD scan's backward on the card.

    The forward's inputs, ``dy`` (B,S,H,P) in x's dtype and
    ``dfinal_state`` (B,H,P,N) float32 or None for zeros.  Returns (dx in
    x's dtype, ddt float32, dA float32, dBm and dC in their dtypes, dinit
    float32), dx, ddt and dinit contiguous."""
    global BWD_LAUNCHES, BWD_TC_LAUNCHES, BWD_FMA_LAUNCHES
    name = "ssd_scan_bwd"
    _check(x, dt, A, Bm, C, chunk, init_state)
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"{name}: dy must match x in device, dtype and "
                         f"shape ({dy.device}, {dy.dtype}, "
                         f"{tuple(dy.shape)})")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if dfinal_state is not None and (
            dfinal_state.device != x.device
            or dfinal_state.dtype != torch.float32
            or tuple(dfinal_state.shape) != (b, h, p, n)):
        raise ValueError(f"{name}: dfinal_state must be float32 "
                         f"(B, H, P, N) = {(b, h, p, n)} on {x.device}")
    x, Bm, C, dy = (readable(t) for t in (x, Bm, C, dy))
    A = A.contiguous()
    init = None if init_state is None else init_state.contiguous()
    dfin = None if dfinal_state is None else dfinal_state.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = -(-s // chunk)
    tc = x.dtype == torch.bfloat16
    dx = torch.empty(b, s, h, p, dtype=x.dtype, device=x.device)
    ddt = torch.empty(b, s, h, **f32)
    da = torch.empty(b, nc, h, **f32) if tc else torch.empty(b, h, **f32)
    db = torch.empty(b, s, h, n, **f32)
    dc = torch.empty(b, s, h, n, **f32)
    dinit = torch.empty(b, h, p, n, **f32)
    vals = [v for t in (x, dt, Bm, C, dy) for v in t.stride()[:3]]
    strides = (ctypes.c_longlong * 15)(*vals)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    outs = (x, dt, A, Bm, C, init, dy, dfin, dx, ddt, da, db, dc, dinit)
    if tc:
        # stage 1: the forward's own kernels rebuild C B^T, cum, dt and the
        # state entering each chunk
        fws = [torch.empty(k, **f32)
               for k in workspace_sizes(b, s, h, p, g, n, chunk)]
        bws = [torch.empty(k, **f32)
               for k in bwd_workspace_sizes(b, s, h, p, n, chunk)]
        cb, states, cum, dtw = fws
        with torch.cuda.device(x.device):
            err = _states_fn()(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                C.data_ptr(), None if init is None else init.data_ptr(),
                bws[0].data_ptr(),
                (ctypes.c_void_p * 4)(*(t.data_ptr() for t in fws)),
                (ctypes.c_longlong * 12)(*vals[:12]), b, s, h, g, p, n,
                chunk, stream)
        if err:
            raise RuntimeError(f"repro_ssd_states launch failed: CUDA error "
                               f"{err}")
        work = (states, cb, cum, dtw, *bws)
        BWD_TC_LAUNCHES += 1
    else:
        work = (torch.empty(b * nc * h * p * n, **f32),)     # hin
        BWD_FMA_LAUNCHES += 1
    ptrs = (ctypes.c_void_p * (len(outs) + len(work)))(*(
        None if t is None else t.data_ptr() for t in outs + work))
    BWD_LAUNCHES += 1
    with torch.cuda.device(x.device):
        err = _bwd_fn()(ptrs, strides, b, s, h, g, p, n, chunk,
                        DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"repro_ssd_scan_bwd launch failed: CUDA error "
                           f"{err}")
    rep = h // g
    return (dx, ddt, da.view(-1, h).sum(0),
            db.view(b, s, g, rep, n).sum(3).to(Bm.dtype),
            dc.view(b, s, g, rep, n).sum(3).to(C.dtype), dinit)
