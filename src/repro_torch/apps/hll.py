"""HyperLogLog cardinality estimation on tensors (paper §9.6).

Twin of ``repro.apps.hll``.  32-bit HLL: h1 selects the register (top p
bits), rho = clz(h2)+1 is the rank.  Registers merge with a scatter-max —
a one-pass streaming sketch, matching the HLS kernel the paper deploys.

PyTorch's uint32 has few CUDA ops, so the 32-bit hash runs in int64
masked to 32 bits, each 32 x 32-bit product split into 16-bit halves so
that no intermediate passes 2^49 (nothing relies on signed overflow).
``clz`` is ``32 - exponent`` of ``torch.frexp`` in float64 (exact below
2^53).  As in the reference, rho is the clz of h2 read as int32, so a hash
at or above 2^31 counts as negative: clz 0, rho 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit ``c``:
    lo * c < 2^48, and the high half only reaches bits 16-31."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3-style finalizer on 32-bit values held in int64."""
    x = (x.to(torch.int64) & _MASK32) ^ seed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of positive 32-bit values held in int64."""
    return 32 - torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def hll_sketch(items: torch.Tensor, *, p: int = 12) -> torch.Tensor:
    """items (N,) int -> registers (2^p,) uint8, on the items' device."""
    m = 1 << p
    h1 = _mix32(items, 0x9E3779B9)
    h2 = _mix32(items, 0x85EBCA77)
    idx = h1 >> (32 - p)
    clz = torch.where(h2 >= 1 << 31, torch.zeros_like(h2), _clz32(h2 | 1))
    rho = (clz + 1).to(torch.int32)                  # 1..32
    regs = torch.zeros((m,), dtype=torch.int32, device=items.device)
    regs.scatter_reduce_(0, idx, rho, "amax")
    return regs.to(torch.uint8)


def hll_merge(a: torch.Tensor, b: torch.Tensor, *, p: int = 12
              ) -> torch.Tensor:
    return torch.maximum(a, b)


def hll_estimate(regs: torch.Tensor, *, p: int = 12) -> torch.Tensor:
    m = 1 << p
    alpha = 0.7213 / (1 + 1.079 / m)
    inv = torch.sum(torch.exp2(-regs.to(torch.float32)))
    raw = alpha * m * m / inv
    zeros = torch.sum(regs == 0).to(torch.float32)
    linear = m * torch.log(m / torch.clamp_min(zeros, 1.0))
    return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


def hll_count(items, *, p: int = 12) -> float:
    return float(hll_estimate(hll_sketch(torch.as_tensor(items), p=p), p=p))


# ---- vFPGA app wrapper -----------------------------------------------------
@dataclass(frozen=True)
class HLLConfig:
    p: int = 12


def hll_app_fn(iface, vfpga, data):
    """User logic for the vFPGA slot: consume a stream buffer, return the
    cardinality estimate (raised to host via the interrupt channel too).
    The byte buffer is reinterpreted as 32-bit items with zero host-side
    conversion cost (an int32 view, masked to uint32 in the hash), then
    moved to the slot's device."""
    items = torch.from_numpy(np.asarray(data).view(np.int32)).to(
        vfpga.static.device)
    est = hll_count(items)
    iface.irq.raise_irq(int(est) & 0x7FFFFFFF)
    return est


def make_hll_artifact():
    from repro_torch.core.port import PortCapabilities
    from repro_torch.core.services.base import ServiceRequirement
    from repro_torch.core.vfpga import AppArtifact
    return AppArtifact(name="hll", fn=hll_app_fn,
                       requires=[ServiceRequirement("mmu", {})],
                       config_repr=HLLConfig(),
                       capabilities=PortCapabilities(
                           name="hll", kind="app", streams=1, csr_map={},
                           mem_model="host",
                           ops=("local_transfer", "kernel")))
