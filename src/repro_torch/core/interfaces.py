"""Unified generic application interface (paper §7.1, Fig 5).

Every vFPGA slot gets the same interface bundle, mirroring Coyote v2's
AXI-based spec mapped onto host-framework constructs:

  * control bus        -> :class:`ControlRegisters` (CSR map, user-space)
  * interrupt channel  -> :class:`InterruptQueue` (eventfd-style callbacks)
  * parallel host/card/net streams -> :class:`StreamEndpoint` xN, TID-tagged
  * read/write send queues + completion queues -> :class:`SendQueue`,
    :class:`CompletionQueue` (HW-initiated DMA without host involvement)

Streams carry numpy/JAX arrays split into packets by the credit layer; the
TID field (AXI TID analogue) keeps cThreads apart on shared pipelines.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple


class Oper(Enum):
    LOCAL_TRANSFER = "local_transfer"    # host <-> vFPGA stream
    LOCAL_OFFLOAD = "local_offload"      # host -> card memory
    LOCAL_SYNC = "local_sync"            # card memory -> host
    REMOTE_WRITE = "remote_write"        # RDMA write
    REMOTE_READ = "remote_read"          # RDMA read
    KERNEL = "kernel"                    # invoke compute, streams pre-wired


@dataclass
class SgEntry:
    """Scatter-gather descriptor (paper Code 1)."""
    src: Any = None                      # array or buffer handle
    dst: Any = None
    length: int = 0
    src_stream: int = 0
    dst_stream: int = 0
    tid: int = 0                         # cThread id (AXI TID)
    opcode: Oper = Oper.LOCAL_TRANSFER
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Completion:
    ticket: int
    tid: int
    opcode: Oper
    nbytes: int
    t_submit: float
    t_done: float
    ok: bool = True
    result: Any = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class ControlRegisters:
    """Memory-mapped CSR analogue: user-space get/set with change hooks."""

    def __init__(self):
        self._regs: Dict[int, int] = {}
        self._hooks: Dict[int, List[Callable[[int], None]]] = {}
        self._lock = threading.Lock()

    def set_csr(self, value: int, reg: int) -> None:
        with self._lock:
            self._regs[reg] = value
            hooks = list(self._hooks.get(reg, ()))
        for h in hooks:
            h(value)

    def get_csr(self, reg: int, default: int = 0) -> int:
        with self._lock:
            return self._regs.get(reg, default)

    def on_write(self, reg: int, hook: Callable[[int], None]) -> None:
        with self._lock:
            self._hooks.setdefault(reg, []).append(hook)

    def snapshot(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._regs)


class InterruptQueue:
    """User interrupts: hardware raises arbitrary values; host polls via an
    eventfd-style queue or registers a callback (paper §7.1)."""

    def __init__(self):
        self._q: "queue.Queue[Tuple[int, float]]" = queue.Queue()
        self._callbacks: List[Callable[[int], None]] = []
        self.raised = 0

    def raise_irq(self, value: int) -> None:
        self.raised += 1
        self._q.put((value, time.perf_counter()))
        for cb in list(self._callbacks):
            cb(value)

    def poll(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            v, _ = self._q.get(timeout=timeout)
            return v
        except queue.Empty:
            return None

    def on_interrupt(self, cb: Callable[[int], None]) -> None:
        self._callbacks.append(cb)

    def pending(self) -> int:
        return self._q.qsize()


class StreamKind(Enum):
    HOST = "host"
    CARD = "card"
    NET = "net"


@dataclass
class Packet:
    tid: int
    seq_no: int
    payload: Any                         # ndarray view / bytes
    nbytes: int
    last: bool
    stream_id: int = 0
    src: str = ""
    dst: str = ""


class StreamEndpoint:
    """One parallel AXI-stream analogue.  FIFO of packets, TID-tagged."""

    def __init__(self, kind: StreamKind, stream_id: int, depth: int = 64):
        self.kind = kind
        self.stream_id = stream_id
        self.depth = depth
        self._q: "queue.Queue[Packet]" = queue.Queue(maxsize=depth)
        self.bytes_in = 0
        self.bytes_out = 0

    def push(self, pkt: Packet, timeout: Optional[float] = None) -> bool:
        try:
            self._q.put(pkt, timeout=timeout)
            self.bytes_in += pkt.nbytes
            return True
        except queue.Full:
            return False

    def pop(self, timeout: Optional[float] = None) -> Optional[Packet]:
        try:
            pkt = self._q.get(timeout=timeout)
            self.bytes_out += pkt.nbytes
            return pkt
        except queue.Empty:
            return None

    def free_slots(self) -> int:
        return self.depth - self._q.qsize()

    def __len__(self):
        return self._q.qsize()


class SendQueue:
    """HW-initiated DMA request queue (read/write send queues, Fig 5)."""

    def __init__(self):
        self._q: "queue.Queue[Tuple[int, SgEntry]]" = queue.Queue()
        self._ticket = itertools.count()

    def submit(self, sg: SgEntry) -> int:
        t = next(self._ticket)
        self._q.put((t, sg))
        return t

    def pop(self, timeout: Optional[float] = None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def __len__(self):
        return self._q.qsize()


class CompletionQueue:
    """Completion records + host-visible writeback counter (paper §5.1:
    'writeback mechanism enables efficient completion tracking by updating
    host memory counters when transfers finish')."""

    def __init__(self):
        self._q: "queue.Queue[Completion]" = queue.Queue()
        self.writeback_counter = 0       # host-mapped counter analogue
        self._by_ticket: Dict[int, Completion] = {}
        self._lock = threading.Lock()

    def complete(self, c: Completion) -> None:
        with self._lock:
            self.writeback_counter += 1
            self._by_ticket[c.ticket] = c
        self._q.put(c)

    def writeback(self, c: Completion) -> None:
        """Record a completion in the host-visible writeback counter
        WITHOUT retaining the record.  Port-mediated submissions use
        this: their synchronization object is the PortFuture, so parking
        the Completion in the queue as well would leak one record per
        invocation (nothing ever ``wait()``s for it) and its ticket (a
        per-port counter) could shadow a SendQueue ticket for legacy
        ``wait(ticket)`` callers on the same queue."""
        with self._lock:
            self.writeback_counter += 1

    def wait(self, ticket: Optional[int] = None,
             timeout: Optional[float] = None) -> Optional[Completion]:
        if ticket is None:
            try:
                return self._q.get(timeout=timeout)
            except queue.Empty:
                return None
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                if ticket in self._by_ticket:
                    return self._by_ticket.pop(ticket)
            try:
                remaining = (None if deadline is None
                             else max(deadline - time.perf_counter(), 0.0))
                c = self._q.get(timeout=remaining if remaining else 0.05)
                with self._lock:
                    self._by_ticket[c.ticket] = c
            except queue.Empty:
                if deadline is not None and time.perf_counter() > deadline:
                    return None


@dataclass
class AppInterface:
    """The full per-vFPGA bundle (paper Fig 5)."""
    n_streams: int
    csr: ControlRegisters = field(default_factory=ControlRegisters)
    irq: InterruptQueue = field(default_factory=InterruptQueue)
    host_in: List[StreamEndpoint] = field(default_factory=list)
    host_out: List[StreamEndpoint] = field(default_factory=list)
    card_in: List[StreamEndpoint] = field(default_factory=list)
    card_out: List[StreamEndpoint] = field(default_factory=list)
    net_in: List[StreamEndpoint] = field(default_factory=list)
    net_out: List[StreamEndpoint] = field(default_factory=list)
    sq_read: SendQueue = field(default_factory=SendQueue)
    sq_write: SendQueue = field(default_factory=SendQueue)
    cq_read: CompletionQueue = field(default_factory=CompletionQueue)
    cq_write: CompletionQueue = field(default_factory=CompletionQueue)

    @classmethod
    def create(cls, n_streams: int = 4, depth: int = 64) -> "AppInterface":
        iface = cls(n_streams=n_streams)
        for i in range(n_streams):
            iface.host_in.append(StreamEndpoint(StreamKind.HOST, i, depth))
            iface.host_out.append(StreamEndpoint(StreamKind.HOST, i, depth))
            iface.card_in.append(StreamEndpoint(StreamKind.CARD, i, depth))
            iface.card_out.append(StreamEndpoint(StreamKind.CARD, i, depth))
            iface.net_in.append(StreamEndpoint(StreamKind.NET, i, depth))
            iface.net_out.append(StreamEndpoint(StreamKind.NET, i, depth))
        return iface

    def stats(self) -> Dict[str, int]:
        return {
            "host_bytes_in": sum(s.bytes_in for s in self.host_in),
            "host_bytes_out": sum(s.bytes_out for s in self.host_out),
            "card_bytes_in": sum(s.bytes_in for s in self.card_in),
            "card_bytes_out": sum(s.bytes_out for s in self.card_out),
            "net_bytes_in": sum(s.bytes_in for s in self.net_in),
            "net_bytes_out": sum(s.bytes_out for s in self.net_out),
            "interrupts": self.irq.raised,
            "completions": (self.cq_read.writeback_counter
                            + self.cq_write.writeback_counter),
        }
