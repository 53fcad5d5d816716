"""Application layer: vFPGA slots (paper §7).

A :class:`VFpga` is one reconfigurable slot holding arbitrary user logic
behind the unified interface.  Slots are untrusted: each gets an HBM budget
(the floor-planning constraint of partial reconfiguration mapped to memory),
per-slot credit accounts, and its requests are checked against the shell's
services before load — the fail-safe that keeps a running app from losing a
service it depends on (paper §4).

Twin of ``repro.core.vfpga``.  A slot's device is its static layer's
(``static.device``); an app's "compiled" logic is the function itself
after :func:`repro_torch.core.static_layer.build_eager` checked it on meta
tensors of its ``abstract_args``.  A sharded app (``in_shardings`` set,
one rank of a mesh: a ``launch.steps.StepBundle``'s function and
shardings) gets this rank's blocks: its weights, the function's first
argument, migrate under ``in_shardings[0]``, and the build runs on the
rank's block shapes (``static_layer.local_specs``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.interfaces import (AppInterface, Completion, Oper, SgEntry)
from repro_torch.core.services.base import ServiceRegistry, ServiceRequirement
from repro_torch.core.static_layer import (IRQ_USER, StaticLayer,
                                           array_leaves, build_eager,
                                           local_specs, nbytes_of)


class SlotState(Enum):
    EMPTY = "empty"
    LOADED = "loaded"
    RUNNING = "running"


@dataclass
class AppArtifact:
    """A 'partial bitstream': everything needed to (re)configure a slot.

    ``fn`` is the user logic — a host callable ``fn(iface, vfpga, **invoke
    kwargs)`` for streaming apps, or a pure PyTorch function when
    ``abstract_args`` (a tuple of ``TensorSpec`` trees) is provided (then
    it is checked on meta tensors through the static layer's compile
    cache and invoked with device tensors).

    ``capabilities`` is the Port API v2 capability descriptor
    (:class:`repro_torch.core.port.PortCapabilities`): streams, CSR map and
    memory model, registered with the shell at ``Shell.attach()``."""
    name: str
    fn: Callable
    version: str = "0"
    weights: Any = None
    requires: List[ServiceRequirement] = field(default_factory=list)
    abstract_args: Optional[Tuple[Any, ...]] = None
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnums: Tuple[int, ...] = ()
    config_repr: Any = None
    capabilities: Any = None               # Optional[PortCapabilities]

    def weight_bytes(self) -> int:
        if self.weights is None:
            return 0
        return sum(nbytes_of(x) for x in array_leaves(self.weights))


class LinkError(RuntimeError):
    pass


class VFpga:
    """One application slot."""

    def __init__(self, slot: int, static: StaticLayer, *,
                 n_streams: int = 4, hbm_budget: int = 1 << 32):
        self.slot = slot
        self.static = static
        self.iface = AppInterface.create(n_streams=n_streams)
        self.state = SlotState.EMPTY
        self.app: Optional[AppArtifact] = None
        self.compiled: Optional[Any] = None
        self.device_weights: Any = None
        self.hbm_budget = hbm_budget
        self.hbm_used = 0
        self.load_history: List[Tuple[str, float]] = []
        self.tenant: Optional[str] = None   # QoS principal (shell scheduler)
        self.preemptions = 0                # checkpoint yields taken here
        self._addr_map: Dict[int, np.ndarray] = {}   # cThread buffers
        self._next_vaddr = 0x1000
        self._port = None                   # lazily-created unified port
        static.interrupts.register(slot, self.iface.irq)

    # -- unified port (Port API v2) ---------------------------------------------
    def attach_port(self):
        """The slot's unified typed interface (one per slot, lazily
        created).  Registered with the owning shell's port table when one
        exists, so capability descriptors surface in ``Shell.status()``."""
        if self._port is None:
            from repro_torch.core.port import VFpgaPort
            self._port = VFpgaPort(self)
        shell = getattr(self, "shell", None)
        if shell is not None:
            shell._register_port(self._port)
        return self._port

    # -- cooperative preemption (executor lanes) --------------------------------
    def checkpoint(self) -> int:
        """Preemption point for long-running user logic: call between
        natural units of work (a decode step, one stream batch).  If
        strictly-higher-priority granted work waits on this slot's
        executor lane it runs now, on this thread, and this invocation
        resumes afterwards (hold-and-resume).  Returns the number of
        preempting batches run; 0 outside a lane or with lanes off."""
        shell = getattr(self, "shell", None)
        if shell is None:
            return 0
        ran = shell.scheduler.checkpoint(self.slot)
        self.preemptions += ran
        return ran

    def preempt_requested(self) -> bool:
        """Cheap probe: does higher-priority work wait on this slot's
        lane?  Lets logic choose a cheaper checkpoint cadence."""
        shell = getattr(self, "shell", None)
        return (shell is not None
                and shell.scheduler.preempt_requested(self.slot))

    # -- partial reconfiguration ------------------------------------------------
    def check_link(self, artifact: AppArtifact,
                   services: ServiceRegistry) -> None:
        """The linking rule: every required service must be present and
        satisfy the app's constraints (paper §4 fail-safe)."""
        for req in artifact.requires:
            if not services.check(req):
                raise LinkError(
                    f"app {artifact.name!r} requires service "
                    f"{req.service!r} with {req.constraints}; shell does "
                    f"not provide it")
        if artifact.weight_bytes() > self.hbm_budget:
            raise LinkError(
                f"app {artifact.name!r} weights ({artifact.weight_bytes()}"
                f" B) exceed slot {self.slot} HBM budget {self.hbm_budget}")

    def load(self, artifact: AppArtifact, services: ServiceRegistry,
             mesh=None) -> Dict[str, float]:
        """Reconfigure this slot: link-check, migrate weights, build (or
        cache-hit) the logic.  Other slots keep running."""
        t0 = time.perf_counter()
        self.check_link(artifact, services)
        self.unload()
        t_mig = 0.0
        sharded = artifact.in_shardings is not None
        if artifact.weights is not None:
            m0 = time.perf_counter()
            self.device_weights, moved = self.static.engine.migrate_tree(
                artifact.weights,
                artifact.in_shardings[0] if sharded else None)
            t_mig = time.perf_counter() - m0
            self.hbm_used = moved.nbytes
        t_comp = 0.0
        hit = True
        if artifact.abstract_args is not None:
            key = self.static.compile_cache.make_key(
                artifact.name, artifact.config_repr, mesh,
                artifact.abstract_args)

            def build():
                specs = artifact.abstract_args
                if sharded:
                    specs = local_specs(specs, artifact.in_shardings)
                return build_eager(artifact.fn, specs)

            c0 = time.perf_counter()
            entry, hit = self.static.compile_cache.get_or_build(key, build)
            t_comp = time.perf_counter() - c0
            self.compiled = entry.compiled
        self.app = artifact
        self.state = SlotState.LOADED
        self.load_history.append((artifact.name, time.perf_counter()))
        return {"total_s": time.perf_counter() - t0, "migrate_s": t_mig,
                "compile_s": t_comp, "compile_cache_hit": float(hit)}

    def unload(self) -> None:
        # a serving engine bound to this slot dies with the logic: drop
        # it from the shell registry and release its MMU pager so the
        # replacement app can register its own pool owner
        shell = getattr(self, "shell", None)
        if shell is not None:
            eng = shell.engines.pop(self.slot, None)
            if eng is not None:
                eng.mmu.unregister_pager(eng)
        self.app = None
        self.compiled = None
        self.device_weights = None
        self.hbm_used = 0
        self.state = SlotState.EMPTY

    # -- execution ------------------------------------------------------------------
    def invoke_kernel(self, *args) -> Any:
        """Direct kernel launch (built PyTorch app)."""
        if self.compiled is not None:
            return self.compiled(*args)
        if self.app is None:
            raise RuntimeError(f"slot {self.slot} is empty")
        self.state = SlotState.RUNNING
        try:
            return self.app.fn(self.iface, self, *args)
        finally:
            self.state = SlotState.LOADED

    def execute_sg(self, ticket: int, sg: SgEntry) -> Completion:
        """Process one scatter-gather descriptor (the DMA datapath)."""
        t0 = time.perf_counter()
        result = None
        ok = True
        try:
            if sg.opcode in (Oper.LOCAL_TRANSFER, Oper.KERNEL):
                src = self.resolve(sg.src)
                result = self.invoke_kernel(src) if self.app else src
                if sg.dst is not None:
                    dst = self.resolve(sg.dst)
                    host = (result.detach().cpu().numpy()
                            if isinstance(result, torch.Tensor) else result)
                    out = np.asarray(host).view(dst.dtype)[:dst.size]
                    dst.flat[:out.size] = out.reshape(-1)[:dst.size]
            elif sg.opcode == Oper.LOCAL_OFFLOAD:
                result, _ = self.static.engine.upload(
                    np.asarray(self.resolve(sg.src)))
            elif sg.opcode == Oper.LOCAL_SYNC:
                result, _ = self.static.engine.download(sg.src)
            else:
                raise NotImplementedError(sg.opcode)
        except Exception as e:   # noqa: BLE001 — fault -> interrupt, not crash
            ok = False
            result = e
            self.static.interrupts.post(self.slot, IRQ_USER, 0xDEAD)
        return Completion(ticket=ticket, tid=sg.tid, opcode=sg.opcode,
                          nbytes=sg.length, t_submit=t0,
                          t_done=time.perf_counter(), ok=ok, result=result)

    # -- cThread buffer registry (getMem-backed address map) --------------------------
    def register_buffer(self, buf: np.ndarray) -> int:
        vaddr = self._next_vaddr
        self._next_vaddr += max(buf.nbytes, 4096)
        self._addr_map[vaddr] = buf
        return vaddr

    def resolve(self, ref) -> Any:
        if isinstance(ref, int) and ref in self._addr_map:
            return self._addr_map[ref]
        return ref

    def status(self) -> Dict[str, Any]:
        return {"slot": self.slot, "state": self.state.value,
                "app": self.app.name if self.app else None,
                "tenant": self.tenant,
                "preemptions": self.preemptions,
                "hbm_used": self.hbm_used, "hbm_budget": self.hbm_budget,
                **self.iface.stats()}
