"""Trip-count-aware cost analysis over optimized HLO text.

``compiled.cost_analysis()`` counts a ``while`` body ONCE regardless of trip
count — under a layers-scan that under-counts an 80-layer model by 80x, and
the same bug hits any naive collective-bytes grep.  This walker parses the
post-partitioning HLO module, builds the call graph (while bodies, fusions,
calls, conditionals), multiplies every computation's cost by the product of
its ancestors' ``known_trip_count`` annotations, and accumulates:

  * flops            — 2·|out|·K for every dot (K = contracted extent);
                       |out| for elementwise at fusion granularity (minor)
  * bytes            — Σ(operands + outputs) at *fusion boundaries* (HBM
                       traffic model: fusion internals live in registers)
  * collectives      — per-op counts/bytes (naive = result sizes; wire =
                       ring-algorithm bytes on the link), trip-multiplied

Shapes in the SPMD module are per-device, so all results are per-device.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->")
_VAR_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*")
_SIMPLE_TYPE_RE = re.compile(
    r"([a-z][a-z0-9]*\[[0-9,]*\](?:\{[^}]*\})?)\s*")
_OPCODE_RE = re.compile(r"([\w\-]+)\(")
_TRIP_RE = re.compile(r'known_trip_count[^0-9]*(\d+)')
_CALLS_RE = re.compile(
    r"(?:body|calls|to_apply|condition|branch_computations)="
    r"(?:\{([^}]*)\}|%?([\w.\-]+))")
_CDIM_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_GROUPS_TILED_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _parse_shapes(type_str: str) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt in _DTYPE_BYTES:
            out.append((dt, tuple(int(d) for d in dims.split(",") if d.strip())))
    return out


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _parse_shapes(type_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _type_elems(type_str: str) -> int:
    total = 0
    for _, dims in _parse_shapes(type_str):
        n = 1
        for d in dims:
            n *= d
        total += n
    return total


@dataclass
class Op:
    var: str
    type_str: str
    opcode: str
    operands: List[str]
    attrs: str
    callees: List[str] = field(default_factory=list)
    raw_operands: str = ""
    is_root: bool = False


@dataclass
class Computation:
    name: str
    params: Dict[str, str]               # param var -> type string
    ops: List[Op] = field(default_factory=list)
    types: Dict[str, str] = field(default_factory=dict)  # var -> type


def _split_top(s: str) -> List[str]:
    """Split on commas at paren/brace depth 0."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


def _split_operands_attrs(rest: str) -> Tuple[str, str]:
    """rest starts after the opening '(' of the op: 'operands), attrs'."""
    depth = 1
    for i, ch in enumerate(rest):
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
            if depth == 0:
                return rest[:i], rest[i + 1:]
    return rest, ""


def _parse_op_line(line: str) -> Optional[Tuple[str, str, str, str]]:
    """Parse '%var = TYPE opcode(rest' -> (var, type_str, opcode, rest).

    Tuple types may embed /*index=N*/ comments (which contain '=' and ','),
    so the type is extracted with a balanced-paren scan, not a regex."""
    m = _VAR_RE.match(line)
    if not m:
        return None
    var = m.group(1)
    rest = line[m.end():]
    if rest.startswith("("):
        depth = 0
        j = -1
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    j = i
                    break
        if j < 0:
            return None
        type_str = rest[:j + 1]
        rest = rest[j + 1:].lstrip()
    else:
        m2 = _SIMPLE_TYPE_RE.match(rest)
        if not m2:
            return None
        type_str = m2.group(1)
        rest = rest[m2.end():]
    m3 = _OPCODE_RE.match(rest)
    if not m3:
        return None
    return var, type_str, m3.group(1), rest[m3.end():]


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    entry: Optional[str] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if cur is None:
            if line.endswith("{") and ("->" in line):
                m = _COMP_HDR_RE.match(line.strip())
                if m:
                    name = m.group(1)
                    params = {}
                    for p in _split_top(m.group(2)):
                        if ":" in p:
                            pname, ptype = p.split(":", 1)
                            pname = pname.strip().lstrip("%")
                            params[pname] = ptype.strip()
                    cur = Computation(name=name, params=params,
                                      types=dict(params))
                    if line.strip().startswith("ENTRY"):
                        entry = name
            continue
        if line.strip() == "}":
            comps[cur.name] = cur
            cur = None
            continue
        parsed = _parse_op_line(line)
        if parsed is None:
            continue
        var, type_str, opcode, rest = parsed
        operands_str, attrs = _split_operands_attrs(rest)
        operands = [o.split()[-1].lstrip("%")
                    for o in _split_top(operands_str)
                    if o.lstrip().startswith("%") or " %" in o]
        callees = []
        for g1, g2 in _CALLS_RE.findall(attrs):
            if g1:
                callees += [c.strip().lstrip("%") for c in g1.split(",")]
            elif g2:
                callees.append(g2)
        cur.types[var] = type_str
        cur.ops.append(Op(var=var, type_str=type_str, opcode=opcode,
                          operands=operands, attrs=attrs, callees=callees,
                          raw_operands=operands_str,
                          is_root="ROOT" in line.split("%")[0]))
    if entry is not None:
        comps["__entry__"] = comps[entry]
    return comps


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_counts: Dict[str, float] = field(default_factory=dict)
    coll_bytes_naive: Dict[str, float] = field(default_factory=dict)
    coll_bytes_wire: Dict[str, float] = field(default_factory=dict)

    @property
    def coll_total_naive(self) -> float:
        return sum(self.coll_bytes_naive.values())

    @property
    def coll_total_wire(self) -> float:
        return sum(self.coll_bytes_wire.values())

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_counts": self.coll_counts,
                "coll_bytes_naive": self.coll_bytes_naive,
                "coll_bytes_wire": self.coll_bytes_wire,
                "coll_total_naive": self.coll_total_naive,
                "coll_total_wire": self.coll_total_wire}


def _group_size(attrs: str) -> int:
    m = _GROUPS_TILED_RE.search(attrs)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(attrs)
    if m:
        return len(m.group(1).split(","))
    return 1


def _wire_factor(op: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-gather":
        return (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)
    if op in ("all-to-all", "ragged-all-to-all"):
        return (g - 1) / g
    return 1.0                           # collective-permute


# opcodes that move no bytes themselves
_FREE_OPS = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast",
             "bitcast-convert", "after-all", "partition-id", "replica-id",
             "iota", "rng-bit-generator"}
_CONTROL_OPS = {"while", "call", "conditional", "fusion", "async-start",
                "async-done", "custom-call"}


def _dot_flops(op: Op, comp: Computation) -> float:
    out_elems = _type_elems(op.type_str)
    k = 1
    m = _CDIM_RE.search(op.attrs)
    if m and op.operands:
        lhs_t = comp.types.get(op.operands[0], "")
        shapes = _parse_shapes(lhs_t)
        if shapes:
            dims = shapes[0][1]
            for idx in m.group(1).split(","):
                if idx.strip() and int(idx) < len(dims):
                    k *= dims[int(idx)]
    return 2.0 * out_elems * k


class HloCost:
    """``discount_scope``: ops whose metadata op_name contains this marker
    are charged ZERO HBM bytes (flops still count).  The model wraps
    regions that execute as single Pallas kernels on the TPU target (flash
    attention, SSD) in ``jax.named_scope("vmem_fused_*")`` — their interior
    traffic lives in VMEM; the caller adds the kernel's boundary bytes
    back analytically (roofline.fused_boundary_bytes)."""

    def __init__(self, text: str, discount_scope: Optional[str] = None):
        self.comps = parse_module(text)
        self.totals = CostTotals()
        self.discount_scope = discount_scope
        self.discounted_bytes = 0.0
        self._memo: Dict[str, CostTotals] = {}
        if "__entry__" in self.comps:
            self._walk(self.comps["__entry__"].name, 1.0, self.totals,
                       inside_fusion=False)

    def _discounted(self, op: Op) -> bool:
        return (self.discount_scope is not None
                and self.discount_scope in op.attrs)

    # ------------------------------------------------------------------
    def _charge(self, acc: CostTotals, op: Op, amount: float) -> None:
        if self._discounted(op):
            self.discounted_bytes += amount
        else:
            acc.bytes += amount

    def _walk(self, comp_name: str, mult: float, acc: CostTotals, *,
              inside_fusion: bool):
        comp = self.comps.get(comp_name)
        if comp is None:
            return
        for op in comp.ops:
            oc = op.opcode
            base = oc[:-6] if oc.endswith("-start") else oc
            if base in COLLECTIVES:
                nbytes = _type_bytes(op.type_str)
                g = _group_size(op.attrs)
                acc.coll_counts[base] = acc.coll_counts.get(base, 0) + mult
                acc.coll_bytes_naive[base] = (
                    acc.coll_bytes_naive.get(base, 0.0) + mult * nbytes)
                acc.coll_bytes_wire[base] = (
                    acc.coll_bytes_wire.get(base, 0.0)
                    + mult * nbytes * _wire_factor(base, g))
                if not inside_fusion:
                    self._charge(acc, op, mult * self._io_bytes(op, comp))
                continue
            if oc == "while":
                trip = 1
                m = _TRIP_RE.search(op.attrs)
                if m:
                    trip = int(m.group(1))
                for callee in op.callees:
                    self._walk(callee, mult * trip, acc,
                               inside_fusion=inside_fusion)
                continue
            if oc in ("call", "conditional"):
                for callee in op.callees:
                    self._walk(callee, mult, acc, inside_fusion=inside_fusion)
                continue
            if oc == "fusion":
                if not inside_fusion:
                    self._charge(acc, op, mult * self._fusion_io_bytes(op))
                # count dot flops inside the fused computation
                for callee in op.callees:
                    self._walk(callee, mult, acc, inside_fusion=True)
                continue
            if oc == "dot":
                acc.flops += mult * _dot_flops(op, comp)
                if not inside_fusion:
                    self._charge(acc, op, mult * self._io_bytes(op, comp))
                continue
            if oc in _FREE_OPS:
                continue
            if oc == "dynamic-update-slice":
                # in-place: traffic = update read + write, not the big buf
                upd = (comp.types.get(op.operands[1], "")
                       if len(op.operands) > 1 else op.type_str)
                if not inside_fusion:
                    self._charge(acc, op, mult * 2 * _type_bytes(upd))
                continue
            if oc in ("dynamic-slice", "gather", "slice"):
                # reads only the sliced/gathered region, not the operand
                if not inside_fusion:
                    self._charge(acc, op, mult * 2 * _type_bytes(op.type_str))
                continue
            if oc == "scatter":
                # in-place contract: traffic = updates read + written region
                # + indices, NOT the full operand buffer
                upd = (comp.types.get(op.operands[2], "")
                       if len(op.operands) > 2 else "")
                idx = (comp.types.get(op.operands[1], "")
                       if len(op.operands) > 1 else "")
                if not inside_fusion:
                    self._charge(acc, op, mult * (2 * _type_bytes(upd)
                                                  + _type_bytes(idx)))
                continue
            # generic op: 1 flop/elem, operand+output traffic at top level
            acc.flops += mult * _type_elems(op.type_str)
            if not inside_fusion:
                self._charge(acc, op, mult * self._io_bytes(op, comp))
            if oc == "reduce" or oc == "sort" or oc == "scatter":
                for callee in op.callees:
                    self._walk(callee, mult, acc, inside_fusion=True)

    def _io_bytes(self, op: Op, comp: Computation) -> float:
        total = float(_type_bytes(op.type_str))
        for o in op.operands:
            total += _type_bytes(comp.types.get(o, ""))
        return total

    def _fusion_io_bytes(self, op: Op) -> float:
        """Slice-aware, convert-transparent traffic at a fusion boundary.

        A fused parameter consumed only by dynamic-slice/gather (possibly
        through dtype casts) reads only the slices; a fusion rooted at
        dynamic-update-slice/scatter writes only the update region; pure
        cast/copy fusions are free (fused into consumers on the TPU
        target — the CPU backend's bf16 legalization inserts them)."""
        fused = self.comps.get(op.callees[0]) if op.callees else None
        if fused is None:
            return float(_type_bytes(op.type_str)) * 2
        return (_fusion_reads(fused)
                + _fusion_writes(fused, float(_type_bytes(op.type_str))))

# ops that are looked through when attributing fused traffic: on the TPU
# target, dtype casts / layout bitcasts fuse into their consumers (the CPU
# backend's bf16->f32 legalization round-trips must not be charged)
_TRANSPARENT = ("convert", "bitcast", "copy", "reshape", "transpose")


class _FusionView:
    """Use/def analysis inside one fused computation, convert-transparent."""

    def __init__(self, fused: Computation):
        self.fused = fused
        self.defs = {o.var: o for o in fused.ops}

    def effective_uses(self, var: str) -> List[Op]:
        out, frontier, seen = [], [var], set()
        while frontier:
            v = frontier.pop()
            for u in self.fused.ops:
                if v not in u.operands:
                    continue
                if u.opcode in _TRANSPARENT:
                    if u.var not in seen:
                        seen.add(u.var)
                        frontier.append(u.var)
                else:
                    out.append((v, u))
        return out

    def effective_root(self, op: Op) -> Op:
        seen = set()
        while (op.opcode in _TRANSPARENT and op.operands
               and op.operands[0] in self.defs
               and op.var not in seen):
            seen.add(op.var)
            op = self.defs[op.operands[0]]
        return op


def _fusion_reads(fused: Computation) -> float:
    view = _FusionView(fused)
    reads = 0.0
    for fop in fused.ops:
        if fop.opcode != "parameter":
            continue
        pvar = fop.var
        full = float(_type_bytes(fused.types.get(pvar, "")))
        uses = view.effective_uses(pvar)
        if not uses:
            continue                     # pure cast/copy: charged at root
        if all(u.opcode in ("dynamic-slice", "gather", "slice")
               or (u.opcode in ("dynamic-update-slice", "scatter")
                   and u.operands and u.operands[0] == via)
               for via, u in uses):
            part = 0.0
            for via, u in uses:
                if u.opcode in ("dynamic-update-slice", "scatter"):
                    continue             # pure write target: no read
                part += _type_bytes(u.type_str)
            reads += min(part, full)
        else:
            reads += full
    return reads


def _fusion_writes(fused: Computation, fallback: float) -> float:
    view = _FusionView(fused)
    root = next((o for o in fused.ops if o.is_root), None)
    if root is None:
        return fallback
    elems = []
    if root.opcode == "tuple":
        for ov in root.operands:
            d = view.defs.get(ov)
            elems.append(view.effective_root(d) if d is not None else root)
    else:
        elems = [view.effective_root(root)]
    writes = 0.0
    for r in elems:
        if r.opcode == "dynamic-update-slice" and len(r.operands) > 1:
            writes += _type_bytes(fused.types.get(r.operands[1], "")) or 0.0
        elif r.opcode == "scatter" and len(r.operands) > 2:
            writes += _type_bytes(fused.types.get(r.operands[2], "")) or 0.0
        elif r.opcode == "parameter":
            writes += 0.0                # pure pass-through/cast fusion
        else:
            writes += _type_bytes(r.type_str)
    return writes


def analyze_text(text: str, discount_scope: Optional[str] = None
                 ) -> CostTotals:
    return HloCost(text, discount_scope=discount_scope).totals
