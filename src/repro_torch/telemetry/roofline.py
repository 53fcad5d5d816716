"""Roofline analysis of a PyTorch callable on one NVIDIA H100.

Twin of ``repro.telemetry.roofline``.  The reference reads a compiled XLA
executable; a PyTorch program has none, so:

  * FLOPs come from running the callable once under
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    convolutions and attention: the operations PyTorch counts);
  * bytes are the callable's inputs and outputs, each once, plus the
    caller's ``extra_bytes_per_device`` (kernel boundary traffic, for
    example :func:`fused_boundary_bytes`);
  * collectives are parsed from HLO-like text where a caller has one
    (:func:`parse_collectives`, shared with ``hlo_cost``).

Hardware model: NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit) —
  989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32 outside them,
  3.35 TB/s HBM, 450 GB/s NVLink each way to the host's other cards.

Terms (seconds; per device, so chips cancels):
  compute    = FLOPs_per_device / peak (bf16)
  memory     = bytes_per_device / hbm_bw
  collective = wire_bytes_per_device / link_bw
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12      # bf16 tensor cores / card
PEAK_FLOPS_F32 = 67e12   # float32 outside the tensor cores / card
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s / card, NVLink, each way

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

# `= <result-type> <op>(` where op may be the async `-start` variant.
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_GROUPS_TILED_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_naive: Dict[str, int] = field(default_factory=dict)  # Σ result sizes
    bytes_wire: Dict[str, float] = field(default_factory=dict)  # ring estimate

    @property
    def total_naive(self) -> int:
        return sum(self.bytes_naive.values())

    @property
    def total_wire(self) -> float:
        return sum(self.bytes_wire.values())

    def as_dict(self) -> Dict:
        return {"counts": self.counts, "bytes_naive": self.bytes_naive,
                "bytes_wire": self.bytes_wire,
                "total_naive": self.total_naive,
                "total_wire": self.total_wire}


def _group_size(line: str) -> int:
    m = _GROUPS_TILED_RE.search(line)
    if m:
        return int(m.group(2))          # [n_groups, group_size]<=[N]
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def _wire_factor(op: str, g: int) -> float:
    """Ring-algorithm bytes-on-wire per participating device, as a factor of
    the *result* buffer size."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-gather":
        return (g - 1) / g              # result is the gathered (big) buffer
    if op == "reduce-scatter":
        return float(g - 1)             # result is the scattered (small) one
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


def parse_collectives(hlo_text: str) -> CollectiveStats:
    st = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        nbytes = _type_bytes(type_str)
        g = _group_size(line)
        st.counts[op] = st.counts.get(op, 0) + 1
        st.bytes_naive[op] = st.bytes_naive.get(op, 0) + nbytes
        st.bytes_wire[op] = (st.bytes_wire.get(op, 0.0)
                             + nbytes * _wire_factor(op, g))
    return st


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll: CollectiveStats
    chips: int
    model_flops: float = 0.0            # 6·N·D (or 2·N·D inference), global
    xla_flops: float = 0.0              # no counterpart here: always 0
    xla_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll.total_wire / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilisation at the bound: what MFU would be if the
        dominant term ran at peak."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / self.chips / PEAK_FLOPS) / self.bound_s

    def as_dict(self) -> Dict:
        return {
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "xla_flops": self.xla_flops,
            "xla_bytes": self.xla_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.coll.as_dict(),
        }


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def analyze(fn, *args, chips: int = 1, model_flops: float = 0.0,
            extra_bytes_per_device: float = 0.0, **kwargs) -> Roofline:
    """Roofline terms of one call ``fn(*args, **kwargs)``, which runs once.

    FLOPs are what ``FlopCounterMode`` counts over the call (a backward
    inside ``fn`` included); bytes are every tensor among the inputs and
    the outputs once, plus ``extra_bytes_per_device``.  The reference's
    ``xla_flops`` and ``xla_bytes`` (XLA's own ``cost_analysis()``, loop
    bodies counted once) and its ``discount_scope`` (zeroing the HBM bytes
    of regions that run as one Pallas kernel) have no counterpart: there is
    no compiled module, so the two fields stay 0, and the call's traffic
    is only its boundary's.  No collectives are counted."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
    return Roofline(flops_per_device=float(counter.get_total_flops()),
                    bytes_per_device=nbytes + extra_bytes_per_device,
                    coll=CollectiveStats(), chips=chips,
                    model_flops=model_flops)


def fused_boundary_bytes(cfg, shape, chips: int, *,
                         act_bytes: int = 2) -> float:
    """Per-device HBM boundary traffic of the fused attention kernels.

    Flash fwd reads q,k,v and writes o per layer; the bwd kernel reads
    q,k,v,o,do and writes dq,dk,dv (factor ~3.5 total for training).
    Decode reads the KV cache (the fundamental term) + writes one token.
    """
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for k in cfg.layer_kinds() if k != "mamba")
    if n_attn == 0:
        return 0.0
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if shape.kind in ("train", "prefill"):
        per_token = (2 * h + 2 * kv) * hd * act_bytes   # q+o + k+v
        mult = 3.5 if shape.kind == "train" else 1.0
        total = (n_attn * shape.global_batch * shape.seq_len
                 * per_token * mult)
        if cfg.n_encoder_layers:                        # cross + encoder
            total *= 2
        return total / chips
    # decode: each step reads the whole (windowed) cache per layer
    kl = shape.seq_len
    if cfg.swa_window:
        kl = min(kl, cfg.swa_window)
    elif cfg.family == "hybrid":
        kl = min(kl, 4096)
    cache = n_attn * shape.global_batch * kl * 2 * kv * hd * act_bytes
    return cache / chips


def memory_stats(device=None) -> Dict[str, int]:
    """The CUDA caching allocator's byte counts on ``device`` (default: the
    current card): peak and current, allocated and reserved.  Empty
    without a card, as the reference's is when XLA gives no analysis."""
    if not torch.cuda.is_available():
        return {}
    return {
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(device)),
        "max_memory_reserved": int(torch.cuda.max_memory_reserved(device)),
        "memory_allocated": int(torch.cuda.memory_allocated(device)),
        "memory_reserved": int(torch.cuda.memory_reserved(device)),
    }


def model_flops_for(cfg, shape, n_params_active: Optional[int] = None) -> float:
    """6·N·D train / 2·N·D single forward, D = global tokens this step."""
    n = n_params_active if n_params_active is not None else cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch

