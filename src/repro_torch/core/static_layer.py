"""Static layer: the never-reconfigured substrate (paper §5).

Twin of ``repro.core.static_layer``.  Owns exactly what Coyote v2's static
layer owns — the host link, the reconfiguration controller, and the
interrupt plumbing — and nothing else:

  * :class:`TransferEngine` — the XDMA analogue on a ``torch.device``.
    Chunked host->device upload staged through a ring of two pinned host
    buffers (the host fills slot *i* while the DMA drains slot *i-1*), a
    deliberately word-granular "HWICAP" path for the Table 2 comparison,
    and one whole-buffer copy as the upper bound.
  * :class:`CompileCache` — the routed-and-locked-checkpoint analogue:
    built artifacts keyed by (name, config, mesh, specs), reused across
    shell reconfigurations (nested build flow, Fig 7b).
  * :class:`InterruptBus` — MSI-X analogue: page faults, reconfiguration
    completions, TLB invalidations and user IRQs all land here.
  * :class:`ReconfigController` — streams "partial bitstreams" (serialized
    artifacts) from disk through the utility channel at full bandwidth.

Eager PyTorch has no ahead-of-time compiler, so "synthesis"
(:func:`build_eager`) runs the function once on ``meta`` tensors of its
:class:`TensorSpec` arguments — a shape and dtype check that allocates
nothing — reported as ``lower_s``; ``compile_s`` is 0.0.

The static layer routes; it never interprets payloads (paper §3).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.credits import Link
from repro_torch.core.interfaces import Completion, CompletionQueue, InterruptQueue, Oper
from repro_torch.device import resolve_device

# Interrupt source ids (paper §5.1 lists these four)
IRQ_PAGE_FAULT = 1
IRQ_RECONFIG_DONE = 2
IRQ_TLB_INVALIDATION = 3
IRQ_USER = 4


# ============================================================ specs / trees =
@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a build argument (``jax.ShapeDtypeStruct``'s
    place in the port)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def array_leaves(tree: Any) -> List[Any]:
    """The tensor and numpy leaves of a dict/list/tuple tree."""
    return [x for x in pytree.tree_leaves(tree) if _is_array(x)]


def nbytes_of(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def local_specs(specs: Tuple[Any, ...], shardings: Tuple[Any, ...]):
    """``specs`` (trees of :class:`TensorSpec` or ``meta`` tensors of
    global shapes) -> :class:`TensorSpec` s of this rank's block shapes
    under ``shardings`` (congruent trees of ``NamedSharding``)."""
    from repro_torch.models.sharding import shard_shape

    def block(s, sh):
        return TensorSpec(shard_shape(tuple(s.shape), sh.mesh, sh.spec),
                          s.dtype)
    return pytree.tree_map(block, tuple(specs), tuple(shardings))


def build_eager(fn: Callable, specs: Tuple[Any, ...]
                ) -> Tuple[Callable, float, float]:
    """Synthesis of the port: run ``fn`` once on meta tensors of ``specs``
    (a tree of :class:`TensorSpec`), which checks every shape and dtype
    and allocates nothing.  Returns ``(fn, lower_s, compile_s)``; eager
    PyTorch compiles nothing, so ``compile_s`` is 0.0 and the built
    artifact is ``fn`` itself."""
    t0 = time.perf_counter()
    fn(*pytree.tree_map(
        lambda s: s.meta() if isinstance(s, TensorSpec) else s, specs))
    return fn, time.perf_counter() - t0, 0.0


# ============================================================ transfers ====
@dataclass
class TransferStats:
    nbytes: int = 0
    seconds: float = 0.0
    chunks: int = 0

    @property
    def mbps(self) -> float:
        return self.nbytes / max(self.seconds, 1e-12) / 1e6


class TransferEngine:
    """Host<->device data movement (XDMA core analogue).

    Three paths, mirroring Table 2's controller comparison:
      * ``upload_word_granular``  — HWICAP analogue: tiny synchronous writes,
        one blocking round-trip per word-burst.
      * ``upload``                — Coyote path: large chunks staged through
        two pinned host buffers, each chunk's DMA recorded on a CUDA event
        so the host's copy into one slot overlaps the DMA out of the
        other, device-side offset writes, a single sync at the end.
      * ``upload_whole``          — one copy of the whole buffer (upper
        bound).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ring: List[torch.Tensor] = []       # two pinned host slots
        self._ring_events: List[Any] = []
        self._slot = 0
        self._ring_lock = threading.Lock()
        self._stream = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _flat_bytes(data: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)

    # -- HWICAP analogue: word-granular, fully synchronous ------------------
    def upload_word_granular(self, data: np.ndarray, *,
                             word_bytes: int = 4096
                             ) -> Tuple[torch.Tensor, TransferStats]:
        flat = self._flat_bytes(data)
        n = flat.size
        t0 = time.perf_counter()
        dst = torch.zeros((n,), dtype=torch.uint8, device=self.device)
        off = 0
        chunks = 0
        while off < n:
            end = min(off + word_bytes, n)
            dst[off:end].copy_(torch.from_numpy(flat[off:end]))
            self._sync()                     # sync per word-burst
            off = end
            chunks += 1
        dt = time.perf_counter() - t0
        return dst, TransferStats(nbytes=n, seconds=dt, chunks=chunks)

    # -- Coyote ICAP path: streamed chunks, one sync -------------------------
    def _stage(self, part: np.ndarray, out: torch.Tensor) -> None:
        """Copy the bytes ``part`` into the flat uint8 device view ``out``
        through the next of two pinned host slots: the host waits only
        for that slot's previous DMA, fills it, and issues the DMA on the
        engine's copy stream; the current stream waits for the copy's
        event, so work issued after it sees the data."""
        if self.device.type != "cuda":
            out.copy_(torch.from_numpy(part))
            return
        with self._ring_lock:
            if not self._ring or self._ring[0].numel() < part.size:
                for ev in self._ring_events:
                    if ev is not None:
                        ev.synchronize()         # old slots have drained
                self._ring = [torch.empty((part.size,), dtype=torch.uint8,
                                          pin_memory=True) for _ in range(2)]
                self._ring_events = [None, None]
                self._stream = torch.cuda.Stream(self.device)
            k = self._slot
            self._slot ^= 1
            if self._ring_events[k] is not None:
                self._ring_events[k].synchronize()   # slot k has drained
            host = self._ring[k][:part.size]
            host.numpy()[:] = part                   # host copy into slot k
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out.copy_(host, non_blocking=True)   # DMA out of slot k
                ev = torch.cuda.Event()
                ev.record(self._stream)
            self._ring_events[k] = ev
            cur.wait_event(ev)

    def upload(self, data: np.ndarray, *,
               chunk_bytes: int = 16 << 20
               ) -> Tuple[torch.Tensor, TransferStats]:
        flat = self._flat_bytes(data)
        n = flat.size
        t0 = time.perf_counter()
        dst = torch.empty((n,), dtype=torch.uint8, device=self.device)
        off = 0
        chunks = 0
        while off < n:
            end = min(off + chunk_bytes, n)
            self._stage(flat[off:end], dst[off:end])   # DMA at offset
            off = end
            chunks += 1
        self._sync()                             # single completion sync
        dt = time.perf_counter() - t0
        return dst, TransferStats(nbytes=n, seconds=dt, chunks=chunks)

    def stream_rows(self, x: np.ndarray, rows: int) -> Iterator[torch.Tensor]:
        """Device tensors of ``x[i:i + rows]`` for i = 0, rows, ..., each
        staged through the pinned ring as :meth:`upload` stages chunks:
        the host fills one slot while the other's DMA runs and the
        consumer computes on the batch before."""
        for i in range(0, x.shape[0], rows):
            part = np.ascontiguousarray(x[i:i + rows])
            dev = torch.empty(part.shape, device=self.device,
                              dtype=torch.from_numpy(part).dtype)
            self._stage(part.reshape(-1).view(np.uint8),
                        dev.view(-1).view(torch.uint8))
            yield dev

    def upload_whole(self, data: np.ndarray
                     ) -> Tuple[torch.Tensor, TransferStats]:
        t0 = time.perf_counter()
        out = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        self._sync()
        dt = time.perf_counter() - t0
        return out, TransferStats(nbytes=data.nbytes, seconds=dt, chunks=1)

    def download(self, arr: torch.Tensor
                 ) -> Tuple[np.ndarray, TransferStats]:
        t0 = time.perf_counter()
        out = arr.detach().cpu().numpy()
        dt = time.perf_counter() - t0
        return out, TransferStats(nbytes=out.nbytes, seconds=dt, chunks=1)

    # -- tree migration (the migration channel, §5.1) ------------------------
    def migrate_tree(self, tree, shardings=None, *,
                     donate_stale: bool = True) -> Tuple[Any, TransferStats]:
        """Move a host tree (dict/list/tuple of numpy arrays or tensors)
        to the device (weights-before-serving migration).  ``shardings``:
        a congruent tree of ``NamedSharding`` s (the reference's
        ``device_put(tree, shardings)``): each leaf arrives as this rank's
        block (``models.sharding.local_shard``), and only those bytes
        move."""
        from repro_torch.models.sharding import local_shard
        t0 = time.perf_counter()

        def move(x, sh=None):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if isinstance(x, torch.Tensor):
                if sh is not None:
                    x = local_shard(x, sh.mesh, sh.spec)
                return x.to(self.device)
            return x

        out = (pytree.tree_map(move, tree) if shardings is None
               else pytree.tree_map(move, tree, shardings))
        self._sync()
        dt = time.perf_counter() - t0
        leaves = array_leaves(out)
        return out, TransferStats(nbytes=sum(nbytes_of(x) for x in leaves),
                                  seconds=dt, chunks=len(leaves))


# ========================================================== compile cache ==
@dataclass
class CacheEntry:
    compiled: Any
    lower_s: float
    compile_s: float
    hits: int = 0
    key: str = ""


def _spec_repr(x: Any) -> Any:
    if isinstance(x, TensorSpec):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return {k: _spec_repr(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_spec_repr(v) for v in x)
    return x


class CompileCache:
    """Built-artifact cache keyed by (name, config-hash, mesh, specs) — the
    'routed & locked checkpoint' a new app links against (paper §4)."""

    def __init__(self):
        self._entries: Dict[str, CacheEntry] = {}
        self._lock = threading.Lock()

    @staticmethod
    def make_key(name: str, config_repr: Any, mesh=None,
                 avals: Any = None) -> str:
        h = hashlib.sha256()
        h.update(name.encode())
        h.update(repr(config_repr).encode())
        if mesh is not None:
            # the mesh's shape and dim names, as the reference keys it; a
            # DeviceMesh's repr can hold rank-specific state
            h.update(repr((tuple(zip(mesh.mesh_dim_names,
                                     (int(s) for s in mesh.shape))),
                           tuple(mesh.mesh_dim_names))).encode())
        if avals is not None:
            h.update(repr(_spec_repr(avals)).encode())
        return h.hexdigest()[:24]

    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.hits += 1
            return e

    def get_or_build(self, key: str,
                     build: Callable[[], Tuple[Any, float, float]]
                     ) -> Tuple[CacheEntry, bool]:
        """build() -> (compiled, lower_s, compile_s).  Returns (entry, hit)."""
        e = self.get(key)
        if e is not None:
            return e, True
        compiled, lower_s, compile_s = build()
        e = CacheEntry(compiled=compiled, lower_s=lower_s,
                       compile_s=compile_s, key=key)
        with self._lock:
            self._entries[key] = e
        return e, False

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries),
                    "hits": sum(e.hits for e in self._entries.values()),
                    "compile_s_saved": sum(
                        e.hits * (e.lower_s + e.compile_s)
                        for e in self._entries.values())}


# =========================================================== interrupts ====
class InterruptBus:
    """Central MSI-X analogue.  Sources post (slot, irq_type, value); the
    per-vFPGA InterruptQueue fan-out happens here."""

    def __init__(self):
        self._queues: Dict[int, InterruptQueue] = {}
        self.log: List[Tuple[float, int, int, int]] = []
        self._lock = threading.Lock()

    def register(self, slot: int, q: InterruptQueue) -> None:
        with self._lock:
            self._queues[slot] = q

    def post(self, slot: int, irq_type: int, value: int = 0) -> None:
        with self._lock:
            self.log.append((time.perf_counter(), slot, irq_type, value))
            q = self._queues.get(slot)
        if q is not None:
            q.raise_irq((irq_type << 32) | (value & 0xFFFFFFFF))


# ====================================================== reconfig control ===
class ReconfigController:
    """ICAP analogue (paper §5.3, Table 2): streams partial "bitstreams"
    (serialized artifact blobs) from disk into device memory.

    Kernel latency  = deserialize + device upload (the actual reconfig).
    Total latency   = disk read + copy-to-"kernel"-buffer + kernel latency.
    """

    def __init__(self, engine: TransferEngine, bus: InterruptBus):
        self.engine = engine
        self.bus = bus

    @staticmethod
    def write_bitstream(path: str, payload: Any) -> int:
        """Serialize a payload dict ({kind?, arrays?, ...metadata}) into
        the safe npz+JSON container (no pickle)."""
        from repro_torch.core import bitstream as B
        if not isinstance(payload, dict):
            payload = {"value": B.jsonable(payload)}
        kind = payload.get("kind", "raw")
        header = {k: B.jsonable(v) for k, v in payload.items()
                  if k not in ("kind", "arrays")}
        blob = B.encode(kind, header, arrays=payload.get("arrays"))
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)

    def load_bitstream(self, path: str, *, slot: int = 0,
                       chunk_bytes: int = 16 << 20):
        """Returns (payload, kernel_s, total_s, nbytes).  The blob is
        parsed by the safe container codec; malformed/unknown bitstreams
        raise :class:`repro_torch.core.bitstream.BitstreamError` rather
        than deserializing arbitrary objects."""
        from repro_torch.core import bitstream as B
        t_total0 = time.perf_counter()
        with open(path, "rb") as f:
            blob = f.read()                       # disk -> user space
        staged = bytearray(blob)                  # user -> kernel copy
        t_k0 = time.perf_counter()
        kind, header, arrays = B.decode(bytes(staged))
        payload = dict(header, kind=kind)
        if arrays is not None:
            dev, _ = self.engine.migrate_tree(arrays)
            payload["arrays"] = dev
        t1 = time.perf_counter()
        self.bus.post(slot, IRQ_RECONFIG_DONE, value=len(blob) & 0xFFFFFFFF)
        return payload, (t1 - t_k0), (t1 - t_total0), len(blob)


# ============================================================ the layer ====
class StaticLayer:
    """Host link + reconfig + interrupts; routes everything else upward.
    ``device=None`` means the CUDA card (raises without one).  ``mesh``
    (a ``DeviceMesh``, or None) is stored for the layers above, which key
    built artifacts by it."""

    def __init__(self, mesh=None, *, pcie_gbps: float = 12e9, device=None):
        self.mesh = mesh
        self.engine = TransferEngine(device)
        self.compile_cache = CompileCache()
        self.interrupts = InterruptBus()
        self.reconfig = ReconfigController(self.engine, self.interrupts)
        # modeled links for the fairness/packetization layer
        self.pcie = Link("pcie", pcie_gbps)
        self.writebacks = CompletionQueue()

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def route_completion(self, ticket: int, tid: int, op: Oper, nbytes: int,
                         t_submit: float, result: Any = None) -> None:
        self.writebacks.complete(Completion(
            ticket=ticket, tid=tid, opcode=op, nbytes=nbytes,
            t_submit=t_submit, t_done=time.perf_counter(), result=result))
