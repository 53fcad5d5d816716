"""cThreads: software threads multiplexed onto one vFPGA pipeline (§7.3).

Mirrors the paper's Code 1 API: ``getMem`` (huge-page host allocation that
registers with the address map / TLB), ``setCSR``/``getCSR``, and
``invoke`` submitting scatter-gather work to the slot's send queues.  Many
cThreads share one vFPGA; the TID keeps their data apart on the parallel
streams, which is what fills the pipeline bubbles of sequential workloads
(AES-CBC, LLM decode — Fig 9/10).
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.interfaces import Completion, Oper, SgEntry
from repro_torch.core.vfpga import VFpga

_tid_counter = itertools.count()


class Alloc(Enum):
    REG = "regular"
    THP = "transparent_huge"
    HPF = "huge_page"         # 2 MB / 1 GB huge pages in the paper


@dataclass
class MemHandle:
    vaddr: int
    array: np.ndarray
    kind: Alloc


class CThread:
    """A Coyote thread bound to one vFPGA slot."""

    def __init__(self, vfpga: VFpga, pid: int, tid: Optional[int] = None):
        self.vfpga = vfpga
        self.pid = pid
        self.tid = next(_tid_counter) if tid is None else tid
        self._mem: Dict[int, MemHandle] = {}
        self._pending: Dict[int, float] = {}

    # -- memory (Code 1: getMem({Alloc::HPF, 4096})) ---------------------------
    def getMem(self, spec: Tuple[Alloc, int]) -> np.ndarray:
        kind, nbytes = spec
        # huge-page allocations are alignment-padded (2 MB analogue)
        align = (2 << 20) if kind == Alloc.HPF else 4096
        padded = -(-nbytes // align) * align if kind == Alloc.HPF else nbytes
        buf = np.zeros(max(padded, nbytes), dtype=np.uint8)[:nbytes]
        vaddr = self.vfpga.register_buffer(buf)
        self._mem[vaddr] = MemHandle(vaddr=vaddr, array=buf, kind=kind)
        return buf

    def freeMem(self, buf: np.ndarray) -> None:
        for vaddr, h in list(self._mem.items()):
            if h.array is buf:
                del self._mem[vaddr]
                return

    def vaddr_of(self, buf: np.ndarray) -> int:
        for vaddr, h in self._mem.items():
            if h.array is buf:
                return vaddr
        raise KeyError("buffer not allocated by this cThread")

    # -- control registers --------------------------------------------------------
    def setCSR(self, value: int, reg: int) -> None:
        self.vfpga.iface.csr.set_csr(value, reg)

    def getCSR(self, reg: int) -> int:
        return self.vfpga.iface.csr.get_csr(reg)

    # -- invocation ------------------------------------------------------------------
    @property
    def port(self):
        """The slot's unified Port (the v2 submission surface)."""
        return self.vfpga.attach_port()

    def invoke(self, oper: Oper, sg: SgEntry, *,
               wait: bool = True,
               timeout: Optional[float] = None) -> Optional[Completion]:
        """Deprecated shim over ``port.submit`` (Port API v2).

        Builds an :class:`~repro.core.port.Invocation` from the SG entry
        and routes it through the slot's port — the scheduler still
        batches, credits, and arbitrates, and completions still land on
        the legacy completion queues.  New code should call
        ``shell.attach(slot).submit(...)`` directly and keep the future.
        """
        from repro_torch.core.port import Invocation
        sg.opcode = oper
        sg.tid = self.tid
        fut = self.port.submit(Invocation.from_sg(sg))
        self._pending[fut.ticket] = time.perf_counter()
        if not wait:
            return None
        comp = fut.completion(timeout=timeout)
        self._pending.pop(fut.ticket, None)
        return comp

    # -- interrupts --------------------------------------------------------------------
    def poll_interrupt(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.vfpga.iface.irq.poll(timeout=timeout)

    def on_interrupt(self, cb) -> None:
        self.vfpga.iface.irq.on_interrupt(cb)
