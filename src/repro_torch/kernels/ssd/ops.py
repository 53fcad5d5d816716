"""Dispatch for the SSD scan, on the tensor's device, with its gradient.

Twin of ``repro.kernels.ssd.ops.ssd``, which picks the Pallas kernel or
the chunked jnp scan by a flag.  Here ``ssd`` is one
``torch.autograd.Function`` for both devices.  A CUDA tensor goes to the
hand-written kernels: the forward scan (``ssd.ssd_scan``) and, for the
gradient, the backward kernel (``ssd.ssd_scan_bwd``); each launches or
raises.  A CPU tensor goes to the plain versions: ``ref.ssd_chunked`` and
``ref.ssd_chunked_bwd``.  Any other device raises.  There is no flag to
pick the plain version on the card.

The reference has no backward kernel: it trains mamba models by
differentiating its jnp scan, and the gradient here is held to
``jax.grad`` of that scan (``tests/test_torch_ssd.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.kernels.ssd.ssd import ssd_scan, ssd_scan_bwd


def _device(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return x.device.type


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, init_state, chunk):
        fwd = ssd_scan if _device(x) == "cuda" else ssd_chunked
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, C, init_state)
        return fwd(x, dt, A, Bm, C, chunk=chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, C, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = ssd_scan_bwd if x.device.type == "cuda" else ssd_chunked_bwd
        dx, ddt, dA, dB, dC, dinit = bwd(
            x, dt, A, Bm, C, dy, chunk=ctx.chunk, init_state=init_state,
            dfinal_state=dfinal)
        return (dx, ddt, dA, dB, dC,
                None if init_state is None else dinit, None)


def ssd(x, dt, A, Bm, C, *, chunk: int = 256, init_state=None):
    """x (B,S,H,P); dt (B,S,H) after softplus; A (H,); Bm, C (B,S,G,N);
    init_state (B,H,P,N) or None.  Returns (y, final_state float32);
    differentiable in every input."""
    return _SSD.apply(x, dt, A, Bm, C, init_state, chunk)
