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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, readable

LAUNCHES = 0
TC_LAUNCHES = 0             # bf16: the four tensor-core kernels
FMA_LAUNCHES = 0            # float32: ssd_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((64, 128), (64, 64), (64, 32), (32, 16))     # (head_dim, d_state)
CHUNKS = (32, 64, 128, 256)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssd").repro_ssd_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def workspace_sizes(b, s, h, p, g, n, chunk):
    """Float32 elements of the bf16 path's workspaces: C B^T (B, nc, G, LT,
    LT), the states (B, nc, H, P, N), cum and dt (B, H, nc, LT) each, with
    nc = ceil(S / L) chunks of LT = L rounded up to 64 rows."""
    nc, lt = -(-s // chunk), -(-chunk // 64) * 64
    return (b * nc * g * lt * lt, b * nc * h * p * n, b * h * nc * lt,
            b * h * nc * lt)


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
