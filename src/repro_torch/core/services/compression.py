"""Gradient-compression service (paper Req. 1 names "compression cores").

Twin of ``repro.core.services.compression``.  Distributed-optimization
trick for 1000+-node DP: gradients crossing the slow (inter-pod) links are
quantized to int8 with per-block scales and an error-feedback accumulator,
optionally top-k sparsified.  The service is reconfigurable at run time
(swap bits / block / top-k without touching the apps), and a trainer
consumes it as ``apply(grads, state)``.

All math is tensor ops on the gradients' device; ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the quantized values are the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core.services.base import Service


@dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8                 # 8 -> int8 quantization
    block: int = 256              # elements per scale block
    error_feedback: bool = True
    topk_frac: float = 0.0        # 0 -> dense; 0.01 -> keep top 1%


def _quantize_blockwise(x: torch.Tensor, block: int, bits: int):
    """x (flat,) fp32 -> (q int8, scales fp32 (nblocks,), n)."""
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    xb = x.reshape(-1, block)
    qmax = 2.0 ** (bits - 1) - 1
    scale = xb.abs().amax(dim=1, keepdim=True) / qmax
    scale = scale.clamp_min(1e-12)
    q = torch.round(xb / scale).clamp(-qmax, qmax).to(torch.int8)
    return q, scale[:, 0], n


def _dequantize_blockwise(q, scale, n: int):
    x = q.to(torch.float32) * scale[:, None]
    return x.reshape(-1)[:n]


def _topk_mask(x: torch.Tensor, frac: float):
    k = max(int(x.shape[0] * frac), 1)
    thresh = torch.topk(x.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


def _is_leaf_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


class GradCompression(Service):
    NAME = "compression"
    PORT_METHODS = ("init_state", "compress_leaf", "decompress_leaf",
                    "apply", "ratio_metrics", "status", "configure")
    PORT_MEM_MODEL = "device"

    def __init__(self, config: Optional[CompressionConfig] = None):
        super().__init__(config if config is not None
                         else CompressionConfig())

    def init_state(self, params) -> Any:
        """Error-feedback residuals, one per leaf (zeros)."""
        if not self.config.error_feedback:
            return None
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    def compress_leaf(self, g: torch.Tensor):
        c: CompressionConfig = self.config
        flat = g.to(torch.float32).reshape(-1)
        if c.topk_frac > 0:
            flat = _topk_mask(flat, c.topk_frac)
        q, scale, n = _quantize_blockwise(flat, c.block, c.bits)
        return {"q": q, "scale": scale, "n": n, "shape": tuple(g.shape)}

    def decompress_leaf(self, payload) -> torch.Tensor:
        x = _dequantize_blockwise(payload["q"], payload["scale"],
                                  payload["n"])
        return x.reshape(payload["shape"])

    def apply(self, grads, state):
        """Quantize->dequantize every gradient leaf with error feedback —
        exactly what arrives after a compressed all-reduce.  Returns
        (grads_hat, new_state, metrics)."""
        c: CompressionConfig = self.config

        def one(g, e):
            gf = g.to(torch.float32)
            if e is not None:
                gf = gf + e
            flat = gf.reshape(-1)
            if c.topk_frac > 0:
                flat = _topk_mask(flat, c.topk_frac)
            q, scale, n = _quantize_blockwise(flat, c.block, c.bits)
            ghat = _dequantize_blockwise(q, scale, n).reshape(g.shape)
            new_e = (gf - ghat) if e is not None else None
            return ghat.to(g.dtype), new_e

        if state is None:
            outs = pytree.tree_map(lambda g: one(g, None)[0], grads)
            return outs, None, self.ratio_metrics(grads)
        flat_g, treedef = pytree.tree_flatten(grads)
        flat_e = pytree.tree_leaves(state)
        pairs = [one(g, e) for g, e in zip(flat_g, flat_e)]
        ghat = pytree.tree_unflatten([p[0] for p in pairs], treedef)
        new_state = pytree.tree_unflatten([p[1] for p in pairs], treedef)
        return ghat, new_state, self.ratio_metrics(grads)

    def ratio_metrics(self, grads) -> Dict[str, float]:
        c: CompressionConfig = self.config
        leaves = [g for g in pytree.tree_leaves(grads) if _is_leaf_tensor(g)]
        raw = sum(g.numel() * 4 for g in leaves)
        comp = sum(g.numel() * c.bits // 8 + (g.numel() // c.block + 1) * 4
                   for g in leaves)
        if c.topk_frac > 0:
            comp = int(comp * c.topk_frac) + raw // 8  # indices bitmap
        return {"bytes_raw": float(raw), "bytes_compressed": float(comp),
                "compression_ratio": raw / max(comp, 1)}
