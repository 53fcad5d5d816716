"""CUDA Mamba-2 SSD chunked-scan kernel for Hopper: the wrapper.

Replaces the Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd/ssd.py:34``), the prefill hot spot of a mamba
model: one launch per mamba layer per ``prefill`` call.  The kernel is
``repro_torch/csrc/ssd.cu``, built with ``nvcc`` for ``sm_90a`` at first
use (:mod:`repro_torch.kernels._build`) and bound through ``ctypes``.

What bounds it on an H100 at the main prefill shape: bytes and operations
about equally (86 GFLOP of visible work, 298 MB of least traffic in
bf16).  The design keeps the float32 (P, N) state in shared memory across
the chunks of one (batch row, head), tiles each chunk into 64-row tiles
(32 when the chunk is 32) so that no L x L matrix is ever held, computes
the decay only where it is visible, and runs float32 FMA on the CUDA
cores: at the main shape 139,264 bytes of shared memory (one block per
SM) and, by ptxas, 206 registers with no spill.  wgmma and a
chunk-parallel scan are later work.

The kernel reads x, B and C through their strides (last dimension
contiguous), so ``mamba_apply``'s views split out of the convolution's
output go in with no copy; dt may be strided too.  A ragged S is handled
inside the kernel (positions past S count as dt = 0), with no padded copy.
Shapes are fixed at build time: (P, N) in ``SHAPES`` and the chunk in
``CHUNKS``; anything else raises.  This wrapper launches or raises: it
never falls back to the plain version (``ref.py``), and it does not
synchronise.  ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((64, 128), (64, 64), (64, 32), (32, 16))     # (head_dim, d_state)
CHUNKS = (32, 64, 128, 256)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssd").repro_ssd_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _last_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


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
    global LAUNCHES
    _check(x, dt, A, Bm, C, chunk, init_state)
    x, Bm, C = (_last_contiguous(t) for t in (x, Bm, C))
    A = A.contiguous()
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty(b, s, h, p, dtype=x.dtype, device=x.device)
    init = None if init_state is None else init_state.contiguous()
    st = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    vals = [v for t in (x, dt, Bm, C) for v in t.stride()[:3]]
    strides = (ctypes.c_longlong * 12)(*vals)
    LAUNCHES += 1
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), C.data_ptr(),
                    None if init is None else init.data_ptr(), y.data_ptr(),
                    st.data_ptr(), strides, b, s, h, g, p, n, chunk,
                    DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"repro_ssd_scan launch failed: CUDA error {err}")
    return y, st
