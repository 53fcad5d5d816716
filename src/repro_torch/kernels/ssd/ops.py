"""Dispatch for the SSD scan, on the tensor's device.

Twin of ``repro.kernels.ssd.ops.ssd``, which picks the Pallas kernel or
the chunked jnp scan by a flag.  Here a CUDA tensor goes to the
hand-written kernel, which launches or raises; a CPU tensor goes to the
plain chunked scan (``ref.ssd_chunked``); any other device raises.  There
is no flag to pick the plain version on the card.

The kernel is forward-only, as the Pallas kernel is; the reference trains
mamba models by differentiating the jnp scan.  So a CUDA input that needs
a gradient raises ``NotImplementedError`` (SSM training on the card,
ROADMAP queue 1 item 19) instead of silently taking the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.kernels.ssd.ssd import ssd_scan


def ssd(x, dt, A, Bm, C, *, chunk: int = 256, init_state=None):
    """x (B,S,H,P); dt (B,S,H) after softplus; A (H,); Bm, C (B,S,G,N);
    init_state (B,H,P,N) or None.  Returns (y, final_state float32)."""
    if x.device.type == "cuda":
        inputs = (x, dt, A, Bm, C) + (() if init_state is None
                                      else (init_state,))
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            raise NotImplementedError(
                "ssd: the CUDA SSD kernel has no backward; SSM training on "
                "the card waits for ROADMAP queue 1 item 19")
        return ssd_scan(x, dt, A, Bm, C, chunk=chunk, init_state=init_state)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, C, chunk=chunk,
                           init_state=init_state)
    raise ValueError(f"ssd: no kernel for device {x.device}")
