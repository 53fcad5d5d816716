"""Multi-tenant fair sharing: packetization + credits + RR interleave (§6.3).

Coyote v2 divides every transfer into 4 KB packets (configurable), grants
each (vFPGA, stream) a credit budget bounded by its destination-queue depth,
and round-robins packets over the bandwidth-constrained link.  Requests
beyond the credit budget stall the *requester*, never the link — that is the
paper's back-pressure containment (§7.2).

The :class:`Link` here does double duty: it models a bandwidth-limited,
in-order link with a virtual clock (deterministic fairness benchmarks — the
Fig 8 reproduction), and it can wrap a real transfer callable so the same
arbiter drives actual host<->device movement.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

DEFAULT_PACKET_BYTES = 4096


# ------------------------------------------------------------ packetizer ---
def packetize(nbytes: int, packet_bytes: int = DEFAULT_PACKET_BYTES
              ) -> List[int]:
    """Split a transfer length into packet lengths (last may be short)."""
    if nbytes <= 0:
        return []
    full, rem = divmod(nbytes, packet_bytes)
    out = [packet_bytes] * full
    if rem:
        out.append(rem)
    return out


# ---------------------------------------------------------------- credits --
class CreditAccount:
    """Per-(vFPGA, stream) credit pool; capacity == destination queue depth.

    Requests acquire one credit per packet and block (back-pressure onto the
    requester) when exhausted; completions replenish.  ``on_release`` (if
    given) fires after every replenish, outside the account's lock — the
    shell scheduler uses it to wake its issue loop when an executor lane
    returns credits asynchronously."""

    def __init__(self, capacity: int,
                 on_release: Optional[Callable[[], None]] = None):
        self.capacity = capacity
        self._avail = capacity
        self._cv = threading.Condition()
        self.stalls = 0
        self.on_release = on_release

    def acquire(self, n: int = 1, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._avail < n:
                self.stalls += 1
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            self._avail -= n
            return True

    def try_acquire(self, n: int = 1) -> bool:
        with self._cv:
            if self._avail < n:
                self.stalls += 1
                return False
            self._avail -= n
            return True

    def release(self, n: int = 1) -> None:
        with self._cv:
            self._avail = min(self._avail + n, self.capacity)
            self._cv.notify_all()
        if self.on_release is not None:
            self.on_release()       # outside the lock: the callback may
                                    # take the scheduler's own lock

    @property
    def available(self) -> int:
        with self._cv:
            return self._avail


# ------------------------------------------------------------------ link ---
@dataclass
class LinkEvent:
    t: float               # virtual completion time (s)
    src: str
    dst: str
    nbytes: int
    tag: str = ""


class Link:
    """Bandwidth-limited in-order link with a virtual clock.

    ``transfer(nbytes)`` advances the clock by nbytes/bandwidth and returns
    the completion time.  ``real_fn`` optionally performs an actual data
    movement (e.g. device_put) — the virtual clock still tracks modeled
    occupancy so fairness stats stay deterministic."""

    def __init__(self, name: str, bandwidth: float,
                 real_fn: Optional[Callable[[Any], Any]] = None):
        self.name = name
        self.bandwidth = bandwidth       # bytes/s (modeled)
        self.real_fn = real_fn
        self.clock = 0.0                 # virtual seconds of occupancy
        self.bytes_moved = 0
        self._lock = threading.Lock()
        self._listeners: List[Callable[[LinkEvent], None]] = []

    def on_event(self, cb: Callable[[LinkEvent], None]) -> None:
        self._listeners.append(cb)

    def transfer(self, nbytes: int, payload: Any = None, *, src: str = "",
                 dst: str = "", tag: str = "") -> Tuple[float, Any]:
        with self._lock:
            self.clock += nbytes / self.bandwidth
            self.bytes_moved += nbytes
            t = self.clock
        result = self.real_fn(payload) if self.real_fn is not None else None
        ev = LinkEvent(t=t, src=src, dst=dst, nbytes=nbytes, tag=tag)
        for cb in self._listeners:
            cb(ev)
        return t, result


# --------------------------------------------------------------- arbiter ---
@dataclass
class _Request:
    requester: str
    packets: Deque[int]
    tag: str
    on_done: Optional[Callable[[float], None]]
    t_enqueue: float
    bytes_total: int
    bytes_done: int = 0
    t_done: float = 0.0


class RRArbiter:
    """Round-robin packet interleaving across requesters (paper Fig 8).

    Each requester (a vFPGA stream) owns a FIFO of requests; the arbiter
    visits requesters cyclically, moving ONE packet per visit, guaranteeing
    equal bandwidth allocation while preserving per-requester ordering."""

    def __init__(self, link: Link,
                 packet_bytes: int = DEFAULT_PACKET_BYTES):
        self.link = link
        self.packet_bytes = packet_bytes
        self._queues: Dict[str, Deque[_Request]] = {}
        self._order: List[str] = []
        self._rr = 0
        self.delivered: Dict[str, int] = {}
        self.completions: List[Tuple[str, float, int]] = []

    def _effective_packet_bytes(self, nbytes: int) -> int:
        """Descriptor size for one request.  Plain RR moves exactly one
        packet per visit, so its equal-bandwidth guarantee requires a
        uniform packet size — no scaling here."""
        return self.packet_bytes

    def submit(self, requester: str, nbytes: int, *, tag: str = "",
               on_done: Optional[Callable[[float], None]] = None) -> None:
        if requester not in self._queues:
            self._queues[requester] = deque()
            self._order.append(requester)
            self.delivered.setdefault(requester, 0)
        pkts = deque(packetize(nbytes, self._effective_packet_bytes(nbytes)))
        self._queues[requester].append(_Request(
            requester=requester, packets=pkts, tag=tag, on_done=on_done,
            t_enqueue=self.link.clock, bytes_total=nbytes))

    def pending(self) -> bool:
        return any(q for q in self._queues.values())

    def backlogged(self, requester: str) -> bool:
        """True while the requester has queued (unsent) packets."""
        return bool(self._queues.get(requester))

    def step(self) -> bool:
        """Move one packet from the next non-empty requester.  False if
        nothing is pending."""
        n = len(self._order)
        for _ in range(n):
            name = self._order[self._rr % n]
            self._rr += 1
            q = self._queues[name]
            if not q:
                continue
            req = q[0]
            pkt = req.packets.popleft()
            t, _ = self.link.transfer(pkt, src=name, dst="link",
                                      tag=req.tag)
            req.bytes_done += pkt
            self.delivered[name] += pkt
            if not req.packets:
                q.popleft()
                req.t_done = t
                self.completions.append((name, t, req.bytes_total))
                if req.on_done is not None:
                    req.on_done(t)
            return True
        return False

    def drain(self) -> None:
        while self.step():
            pass

    def fairness(self) -> Dict[str, float]:
        """Fraction of link bytes each requester received."""
        total = sum(self.delivered.values()) or 1
        return {k: v / total for k, v in self.delivered.items()}


class WeightedRRArbiter(RRArbiter):
    """Deficit-weighted round robin (DWRR) over requesters.

    Each requester carries a weight; every visit grants it a byte quantum
    of ``weight * packet_bytes`` and it sends while its deficit covers the
    head packet.  Equal weights degenerate to plain RR (one packet per
    visit at uniform packet size), so all RRArbiter invariants — per
    requester FIFO ordering, every byte moved exactly once — carry over.
    Idle requesters forfeit their deficit: no banking bandwidth while
    the queue is empty (standard DWRR)."""

    # bound on descriptors per request, like a DMA descriptor ring: very
    # large transfers ride proportionally larger bursts instead of tens
    # of thousands of per-packet Python iterations.  Safe under DWRR
    # because arbitration is byte-deficit-based: a big packet just waits
    # more visits for its deficit, so weighted byte shares are unchanged.
    # Transfers under MAX_PACKETS * packet_bytes (1 MB at the 4 KB
    # default) keep exact per-packet granularity, so sniffer-event and
    # per-packet fairness semantics are unchanged where observable.
    MAX_PACKETS_PER_REQUEST = 256

    def __init__(self, link: Link, packet_bytes: int = DEFAULT_PACKET_BYTES,
                 default_weight: float = 1.0):
        super().__init__(link, packet_bytes=packet_bytes)
        self.default_weight = default_weight
        self._weights: Dict[str, float] = {}
        self._deficit: Dict[str, float] = {}

    def _effective_packet_bytes(self, nbytes: int) -> int:
        if nbytes > self.MAX_PACKETS_PER_REQUEST * self.packet_bytes:
            return -(-nbytes // self.MAX_PACKETS_PER_REQUEST)
        return self.packet_bytes

    def set_weight(self, requester: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._weights[requester] = weight

    def weight(self, requester: str) -> float:
        return self._weights.get(requester, self.default_weight)

    def submit(self, requester: str, nbytes: int, *, tag: str = "",
               weight: Optional[float] = None,
               on_done: Optional[Callable[[float], None]] = None) -> None:
        if weight is not None:
            self.set_weight(requester, weight)
        super().submit(requester, nbytes, tag=tag, on_done=on_done)

    def step(self) -> bool:
        if not self.pending():
            return False
        n = len(self._order)
        while True:
            name = self._order[self._rr % n]
            q = self._queues[name]
            if not q:
                self._deficit[name] = 0.0      # idle: forfeit deficit
                self._rr += 1
                continue
            req = q[0]
            pkt_len = req.packets[0]
            d = self._deficit.get(name, 0.0)
            if d < pkt_len:
                # grant this round's quantum and move on; weight > 0
                # guarantees the deficit eventually covers the packet.
                self._deficit[name] = d + self.weight(name) * self.packet_bytes
                self._rr += 1
                continue
            pkt = req.packets.popleft()
            self._deficit[name] = d - pkt
            t, _ = self.link.transfer(pkt, src=name, dst="link",
                                      tag=req.tag)
            req.bytes_done += pkt
            self.delivered[name] += pkt
            if not req.packets:
                q.popleft()
                req.t_done = t
                self.completions.append((name, t, req.bytes_total))
                if req.on_done is not None:
                    req.on_done(t)
            # NOTE: _rr not advanced — the requester keeps the link while
            # its deficit covers the next packet (its weighted burst).
            return True


def jains_index(shares: Dict[str, float]) -> float:
    """Jain's fairness index: 1.0 = perfectly fair."""
    vals = list(shares.values())
    if not vals:
        return 1.0
    s = sum(vals)
    s2 = sum(v * v for v in vals)
    return (s * s) / (len(vals) * s2) if s2 else 1.0


def weighted_jains_index(shares: Dict[str, float],
                         weights: Dict[str, float]) -> float:
    """Jain's index over weight-normalized shares: 1.0 means every party
    received bandwidth exactly proportional to its configured weight."""
    wtot = sum(weights.get(k, 1.0) for k in shares) or 1.0
    norm = {k: v / (weights.get(k, 1.0) / wtot)
            for k, v in shares.items()}
    return jains_index(norm)
