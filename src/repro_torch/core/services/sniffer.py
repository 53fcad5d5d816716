"""Traffic-sniffer service (paper §8, Fig 6): ibdump/tcpdump for the shell.

Two capture planes, matching the adaptation in DESIGN.md:

  * **live plane** — subscribes to :class:`repro.core.credits.Link` events
    (every packet the arbiter moves) with a CSR-controlled filter; records
    land in a ring buffer ("HBM buffer") and export as PCAP-like dicts for
    offline analysis.
  * **compiled plane** — captures the *collective* traffic of a compiled
    program from its HLO (the ICI "packets"), via the trip-count-aware
    walker.  This is the network debugger for pjit programs.

Control mirrors the paper: the filter and start/stop are CSRs, headers-only
capture is supported, and the service is insertable/removable at run time
(reconfiguration scenario #3 in Table 3).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.credits import Link, LinkEvent
from repro_torch.core.interfaces import ControlRegisters
from repro_torch.core.services.base import Service

CSR_SNIFFER_ENABLE = 0x100
CSR_SNIFFER_HEADERS_ONLY = 0x101
CSR_SNIFFER_FILTER_ID = 0x102


@dataclass(frozen=True)
class SnifferConfig:
    buffer_packets: int = 65536
    headers_only: bool = False
    src_filter: str = ""          # substring match, "" = all
    dst_filter: str = ""


@dataclass
class CaptureRecord:
    ts: float
    src: str
    dst: str
    nbytes: int
    tag: str
    payload_meta: Dict[str, Any] = field(default_factory=dict)


class TrafficSniffer(Service):
    NAME = "sniffer"
    PORT_METHODS = ("start", "stop", "to_records", "clear", "status",
                    "configure")
    PORT_CSR_MAP = {"enable": CSR_SNIFFER_ENABLE,
                    "headers_only": CSR_SNIFFER_HEADERS_ONLY,
                    "filter_id": CSR_SNIFFER_FILTER_ID}
    PORT_MEM_MODEL = "host"

    def __init__(self, config: Optional[SnifferConfig] = None):
        if config is None:
            config = SnifferConfig()
        super().__init__(config)
        self._ring: deque = deque(maxlen=config.buffer_packets)
        self._running = False
        self._attached: List[Link] = []
        self.dropped = 0
        self.csr = ControlRegisters()
        self.csr.on_write(CSR_SNIFFER_ENABLE,
                          lambda v: self.start() if v else self.stop())

    # -- lifecycle -------------------------------------------------------------
    def attach(self, link: Link) -> None:
        """Insert the filter between the stacks and the CMAC (Fig 6)."""
        link.on_event(self._on_event)
        self._attached.append(link)

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def configure(self, config: SnifferConfig) -> None:
        super().configure(config)
        self._ring = deque(self._ring, maxlen=config.buffer_packets)

    # -- data plane ---------------------------------------------------------------
    def _on_event(self, ev: LinkEvent) -> None:
        if not self._running:
            return
        c: SnifferConfig = self.config
        if c.src_filter and c.src_filter not in ev.src:
            return
        if c.dst_filter and c.dst_filter not in ev.dst:
            return
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        rec = CaptureRecord(ts=ev.t, src=ev.src, dst=ev.dst,
                            nbytes=0 if c.headers_only else ev.nbytes,
                            tag=ev.tag)
        if c.headers_only:
            rec.payload_meta = {"len": ev.nbytes}
        self._ring.append(rec)

    # -- sync back to host + export (the software parser) ---------------------------
    def to_records(self) -> List[Dict[str, Any]]:
        """PCAP-like export for analysis with standard tooling."""
        return [{"ts": r.ts, "src": r.src, "dst": r.dst, "len": r.nbytes,
                 "tag": r.tag, **r.payload_meta} for r in self._ring]

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    # -- compiled plane ---------------------------------------------------------------
    @staticmethod
    def capture_compiled(compiled) -> List[Dict[str, Any]]:
        """Collective 'packets' of a compiled pjit program."""
        from repro_torch.telemetry import hlo_cost
        totals = hlo_cost.analyze_text(compiled.as_text())
        out = []
        for op, count in sorted(totals.coll_counts.items()):
            out.append({
                "op": op,
                "count": int(count),
                "bytes": int(totals.coll_bytes_naive.get(op, 0)),
                "wire_bytes": int(totals.coll_bytes_wire.get(op, 0)),
            })
        return out

    def status(self) -> Dict[str, Any]:
        s = super().status()
        s.update(running=self._running, captured=len(self._ring),
                 dropped=self.dropped, links=len(self._attached))
        return s
