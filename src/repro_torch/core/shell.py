"""The shell: dynamic (services) layer + application layer (paper §3/§4).

``Shell`` composes the three-layer design:

  static layer   (never reconfigured)  — StaticLayer: host link, compile
                                         cache, interrupts, reconfig ctrl
  dynamic layer  (reconfigurable)      — ServiceRegistry: MMU, collectives,
                                         compression, encryption, sniffer
  app layer      (reconfigurable)      — VFpga slots behind the unified
                                         interface, shared via cThreads

Reconfiguration contract (paper §4): a *shell* reconfiguration swaps
services and relinks apps (refusing configurations that strand a loaded
app); an *app* reconfiguration touches one slot only.  Both are an order of
magnitude cheaper than :meth:`cold_restart`, the full-reprogramming
analogue (Table 3).

Twin of ``repro.core.shell``.  The shell lives on one ``torch.device``
(``device=None`` means the CUDA card and raises without one); its
"synthesis" checks each service kernel on meta tensors
(:func:`repro_torch.core.static_layer.build_eager`), so a build allocates
nothing on the device, whatever the MMU's pool size.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import credits as C
from repro_torch.core.cthread import CThread
from repro_torch.core.faults import FaultKind, FaultPlan
from repro_torch.core.health import HealthMonitor, Watchdog
from repro_torch.core.interfaces import Oper
from repro_torch.core.port import (Port, SERVICE_SLOT_BASE, ServicePort,
                                   VFpgaPort)
from repro_torch.core.scheduler import ShellScheduler, Tenant
from repro_torch.core.services.base import Service, ServiceRegistry
from repro_torch.core.services.collectives import CollectiveConfig, CollectiveService
from repro_torch.core.services.compression import CompressionConfig, GradCompression
from repro_torch.core.services.encryption import AESConfig, AESService
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.core.services.sniffer import SnifferConfig, TrafficSniffer
from repro_torch.core.static_layer import (IRQ_PAGE_FAULT, StaticLayer,
                                           TensorSpec, build_eager)
from repro_torch.core.vfpga import AppArtifact, VFpga

SERVICE_TYPES = {
    "mmu": (MMU, MMUConfig),
    "collectives": (CollectiveService, CollectiveConfig),
    "compression": (GradCompression, CompressionConfig),
    "encryption": (AESService, AESConfig),
    "sniffer": (TrafficSniffer, SnifferConfig),
}


@dataclass(frozen=True)
class ShellConfig:
    """Compile-time shell parametrization (paper §4: 'a shell is fully
    parametrized by its services and the user applications')."""
    services: Tuple[Tuple[str, Any], ...] = ()
    n_vfpgas: int = 4
    n_streams: int = 4
    packet_bytes: int = 4096
    stream_depth: int = 64
    hbm_budget: int = 1 << 32
    pcie_gbps: float = 12e9
    # per-slot executor lanes (False serializes all execution on the
    # scheduler worker — the pre-lane baseline, kept for A/B benches)
    executor_lanes: bool = True

    @staticmethod
    def make(services: Dict[str, Any] = None, **kw) -> "ShellConfig":
        svc = tuple(sorted((services or {}).items(), key=lambda x: x[0]))
        return ShellConfig(services=svc, **kw)


@dataclass
class BuildReport:
    flow: str
    components: Dict[str, Dict[str, float]] = field(default_factory=dict)
    total_s: float = 0.0
    cache_hits: int = 0

    def add(self, name: str, lower_s: float, compile_s: float,
            hit: bool) -> None:
        self.components[name] = {"lower_s": lower_s, "compile_s": compile_s,
                                 "cached": float(hit)}
        self.cache_hits += int(hit)


class Shell:
    def __init__(self, config: ShellConfig,
                 static: Optional[StaticLayer] = None, mesh=None,
                 name: Optional[str] = None, device=None):
        self.config = config
        # fleet identity: how a FleetController addresses this member
        self.name = name or f"shell-{id(self) & 0xFFFF:04x}"
        self.static = static or StaticLayer(mesh, pcie_gbps=config.pcie_gbps,
                                            device=device)
        self.mesh = mesh
        self.services = ServiceRegistry()
        self.vfpgas: List[VFpga] = []
        self.arbiter = C.WeightedRRArbiter(self.static.pcie,
                                           packet_bytes=config.packet_bytes)
        self.scheduler = ShellScheduler(self.arbiter,
                                        packet_bytes=config.packet_bytes,
                                        stream_depth=config.stream_depth,
                                        lanes=config.executor_lanes)
        self.ports: Dict[str, Port] = {}     # unified port registry (v2)
        # slot -> serving engine bound to that slot (ServingEngine
        # registers itself): how a slot's paged state is found
        self.engines: Dict[int, Any] = {}
        self.built = False
        # robustness layer: passive health ledger (heartbeats, fault
        # counts, quarantines) plus an optional armed fault plan, both
        # shared with the scheduler/MMU via set_fault_plan
        self.health = HealthMonitor()
        self.faults: Optional[FaultPlan] = None
        self._watchdog: Optional[Watchdog] = None
        self.scheduler.health = self.health

    @property
    def device(self) -> torch.device:
        return self.static.device

    # ==================================================== build ("synthesis")
    def build(self, *, flow: str = "shell") -> BuildReport:
        """Synthesize the shell.  ``flow='shell'`` builds services + slots;
        ``flow='app'`` assumes service artifacts are already in the compile
        cache (the nested build flow, Fig 7b) and only prepares slots."""
        t0 = time.perf_counter()
        report = BuildReport(flow=flow)
        self._instantiate_services()
        for name in self.services.names():
            svc = self.services.get(name)
            for aname, stats in self._build_service(svc).items():
                report.add(f"{name}/{aname}", stats["lower_s"],
                           stats["compile_s"], stats["cached"])
        if not self.vfpgas:
            for slot in range(self.config.n_vfpgas):
                self.vfpgas.append(VFpga(
                    slot, self.static, n_streams=self.config.n_streams,
                    hbm_budget=self.config.hbm_budget))
                self.vfpgas[-1].shell = self
        report.total_s = time.perf_counter() - t0
        self.built = True
        return report

    def _instantiate_services(self) -> None:
        for name, svc_cfg in self.config.services:
            cls, _cfg_cls = SERVICE_TYPES[name]
            if name in self.services:
                existing = self.services.get(name)
                if existing.config != svc_cfg:
                    existing.configure(svc_cfg)
                continue
            if name == "mmu":
                svc = cls(svc_cfg, interrupt_post=lambda slot, v:
                          self.static.interrupts.post(slot, IRQ_PAGE_FAULT, v))
            else:
                svc = cls(svc_cfg)
            if name == "sniffer":
                svc.attach(self.static.pcie)
            self.services.add(svc)
        # drop services not in the new config
        wanted = {n for n, _ in self.config.services}
        for name in list(self.services.names()):
            if name not in wanted:
                self.services.remove(name)
        # (re)arm the pager fault hooks on whatever MMU instance the
        # build produced — set_fault_plan before OR after build both work
        mmu = self.services.get("mmu")
        if mmu is not None:
            mmu.faults = self.faults

    def _build_service(self, svc: Service) -> Dict[str, Dict[str, float]]:
        """Build a service's device artifacts through the compile cache:
        each is checked once on meta tensors of its specs."""
        out: Dict[str, Dict[str, float]] = {}
        for aname, fn, args in self._service_kernels(svc):
            key = self.static.compile_cache.make_key(
                f"svc:{svc.NAME}:{aname}", svc.config, self.mesh,
                args)

            def build(fn=fn, args=args):
                return build_eager(fn, args)

            entry, hit = self.static.compile_cache.get_or_build(key, build)
            out[aname] = {"lower_s": entry.lower_s,
                          "compile_s": entry.compile_s, "cached": hit}
            setattr(svc, f"kernel_{aname}", entry.compiled)
        return out

    def _service_kernels(self, svc: Service):
        """Device kernels each service contributes to the shell bitstream.

        The MMU's probe pool at the default config is (4096, 256, 8, 64)
        bf16, 1.07 GB: it exists only as a meta tensor.  The CBC probe is
        one link of the 64-stream chain (``cbc_step`` on (64, 16)): the
        chain of 256 blocks runs that step 256 times on the same shapes,
        and meta tensors pay a host dispatch per op, so checking the step
        checks the chain at 1/256 of the cost."""
        if svc.NAME == "mmu":
            c: MMUConfig = svc.config
            pool = TensorSpec((c.n_pages, c.page_size, 8, 64), torch.bfloat16)
            table = TensorSpec((8, 16), torch.int32)

            def gather_pages(pool, table):
                safe = table.clamp_min(0)
                return pool.index_select(0, safe.reshape(-1).long())
            yield "gather_pages", gather_pages, (pool, table)
        elif svc.NAME == "encryption":
            from repro_torch.core.services import encryption as E
            blocks = TensorSpec((4096, 16), torch.uint8)
            keys = TensorSpec((11, 16), torch.uint8)
            yield "aes_ecb", E.encrypt_block, (blocks, keys)
            iv = TensorSpec((64, 16), torch.uint8)
            yield "aes_cbc_ms", E.cbc_step, (iv, iv, keys)
        elif svc.NAME == "compression":
            from repro_torch.core.services.compression import _quantize_blockwise
            g = TensorSpec((1 << 20,), torch.float32)
            yield "quantize", lambda x: _quantize_blockwise(
                x, svc.config.block, svc.config.bits)[:2], (g,)
        elif svc.NAME == "collectives":
            x = TensorSpec((1 << 16,), torch.float32)
            yield "allreduce_probe", lambda x: x * 2.0, (x,)

    # ================================================= reconfiguration =====
    def reconfigure_shell(self, new_config: ShellConfig, *,
                          bitstream_path: Optional[str] = None
                          ) -> Dict[str, float]:
        """Swap the dynamic layer (Table 3).  Loaded apps are re-linked
        against the new services first; a violation aborts the swap."""
        t_total0 = time.perf_counter()
        if bitstream_path is not None:
            # stream the shell bitstream through the utility channel
            _, kernel_io_s, _, _ = self.static.reconfig.load_bitstream(
                bitstream_path, slot=0)
        t_k0 = time.perf_counter()
        # fail-safe: dry-check every loaded app against the new services
        trial = Shell(new_config, static=self.static, mesh=self.mesh)
        trial._instantiate_services = Shell._instantiate_services.__get__(trial)
        probe = ServiceRegistry()
        for name, svc_cfg in new_config.services:
            cls, _ = SERVICE_TYPES[name]
            probe.add(cls(svc_cfg))
        for vf in self.vfpgas:
            if vf.app is not None:
                for req in vf.app.requires:
                    if not probe.check(req):
                        raise RuntimeError(
                            f"shell reconfiguration would strand app "
                            f"{vf.app.name!r} in slot {vf.slot} "
                            f"(missing {req.service}:{req.constraints})")
        self.config = new_config
        self.build(flow="shell")
        # relink loaded apps against the new shell
        for vf in self.vfpgas:
            if vf.app is not None:
                art = vf.app
                vf.load(art, self.services, self.mesh)
        t1 = time.perf_counter()
        return {"kernel_s": t1 - t_k0, "total_s": t1 - t_total0}

    def reconfigure_app(self, slot: int, artifact: AppArtifact
                        ) -> Dict[str, float]:
        """App-only partial reconfiguration: one slot, services untouched.
        Deprecated shim over :meth:`reconfigure` (now drain-aware)."""
        return self.reconfigure(slot, artifact)

    def reconfigure(self, slot: int, bitstream, *,
                    drain_timeout: float = 30.0) -> Dict[str, float]:
        """Drain-aware hot-swap of ONE slot (Port API v2).

        ``bitstream`` is an :class:`AppArtifact` or a path to an app
        bitstream file (safe npz+JSON format,
        ``repro_torch.core.reconfig``).
        The slot's port is quiesced first — intake held, every in-flight
        invocation completed — then the slot state (CSR file, cThread
        address map) is snapshotted, the new logic is loaded, state is
        restored, and invocations submitted during the swap are replayed
        in FIFO order against the new logic.  No completion is ever lost
        or duplicated; other slots' traffic is never paused.
        """
        t0 = time.perf_counter()
        if isinstance(bitstream, AppArtifact):
            artifact = bitstream
        else:
            from repro_torch.core.reconfig import load_app_bitstream
            artifact = load_app_bitstream(str(bitstream))
        port = self.attach(slot)
        t_d0 = time.perf_counter()
        if not port.quiesce(timeout=drain_timeout):
            port.resume()                 # reopen intake; nothing was lost
            raise RuntimeError(
                f"slot {slot} failed to quiesce within {drain_timeout}s "
                f"({port.inflight()} invocations still in flight); "
                f"hot-swap aborted and intake resumed")
        drain_s = time.perf_counter() - t_d0
        snap = port.snapshot()
        try:
            if self.faults is not None:
                self.faults.fire("reconfig.load", slot=slot)
            stats = self.vfpgas[slot].load(artifact, self.services,
                                           self.mesh)
            port.restore(snap)
        except BaseException as e:
            # failed swap must not wedge the slot: reopen intake (held
            # invocations replay against whatever logic is loaded)
            self.health.record_fault(
                getattr(e, "kind", FaultKind.RECONFIG_ABORT), slot=slot,
                site="reconfig.load", strike=False, msg=str(e))
            port.resume()
            raise
        replayed = port.resume()
        stats["kernel_s"] = stats["total_s"]
        stats.update({
            "total_s": time.perf_counter() - t0,
            "drain_s": drain_s,
            "replayed": float(replayed),
        })
        return stats

    def cold_restart(self) -> Dict[str, float]:
        """Full re-programming analogue (Vivado flow + hot-plug): drop
        every built artifact and service, clear all caches (the compile
        cache and, on the card, the allocator's cached blocks), rebuild,
        reload."""
        t0 = time.perf_counter()
        apps = [(vf.slot, vf.app) for vf in self.vfpgas if vf.app]
        for vf in self.vfpgas:
            vf.unload()
        for name in list(self.services.names()):
            self.services.remove(name)
        self.static.compile_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.vfpgas.clear()
        # every pre-restart port wraps a torn-down slot/service: close
        # them (externally held references fail fast instead of silently
        # dispatching against dead objects) and empty the registry —
        # Shell.attach() hands out live ports against the rebuilt shell.
        for p in self.ports.values():
            p.close()
        self.ports.clear()
        self.engines.clear()                 # engines wrap torn-down slots
        self.build(flow="shell")
        for slot, art in apps:
            self.vfpgas[slot].load(art, self.services, self.mesh)
        return {"total_s": time.perf_counter() - t0}

    # ================================================= app/thread access ====
    def load_app(self, slot: int, artifact: AppArtifact) -> Dict[str, float]:
        if not self.built:
            self.build()
        return self.vfpgas[slot].load(artifact, self.services, self.mesh)

    def attach_thread(self, slot: int, pid: int,
                      tenant: Optional[str] = None) -> CThread:
        if tenant is not None:
            self.scheduler.bind_slot(slot, tenant)
        t = CThread(self.vfpgas[slot], pid)
        return t

    # ================================================= ports (API v2) =======
    def attach(self, target, *, tenant: Optional[str] = None) -> Port:
        """Attach to a slot's or a service's unified Port.

        ``target`` is a vFPGA slot index (int) or a service name (str).
        The port's capability descriptor (streams, CSR map, memory model)
        is registered in the shell's port table — the capability handshake
        of the paper's unified interface.  Optionally binds the port's
        traffic to a QoS ``tenant``.
        """
        if isinstance(target, int):
            if not self.built:
                self.build()
            if tenant is not None:
                self.scheduler.bind_slot(target, tenant)
                self.vfpgas[target].tenant = tenant
            return self.vfpgas[target].attach_port()
        svc = self.services.get(target)
        if svc is None:
            raise KeyError(
                f"no service {target!r} in this shell "
                f"(have: {self.services.names()})")
        port = self.ports.get(target)
        if not isinstance(port, ServicePort) or port.service is not svc:
            port = ServicePort(
                svc, shell=self,
                slot=SERVICE_SLOT_BASE + self.services.names().index(target),
                tenant=tenant)
            self._register_port(port)
        elif tenant is not None:
            port.tenant = tenant
        return port

    def port(self, slot: int) -> VFpgaPort:
        """Shorthand: the unified port of one application slot."""
        return self.attach(slot)

    def _register_port(self, port: Port) -> None:
        self.ports[port.name] = port

    # ================================================= tenants / QoS ========
    def register_tenant(self, name: str, weight: float = 1.0,
                        slots: Tuple[int, ...] = ()) -> Tenant:
        """Create a bandwidth tenant with a QoS weight; optionally bind it
        to vFPGA slots (a slot's traffic bills to its bound tenant)."""
        t = self.scheduler.register_tenant(name, weight)
        for slot in slots:
            self.scheduler.bind_slot(slot, name)
            if slot < len(self.vfpgas):
                self.vfpgas[slot].tenant = name
        return t

    # ================================================= health / recovery ====
    def set_fault_plan(self, plan: Optional[FaultPlan]) -> None:
        """Arm (or disarm, with ``None``) a seeded fault plan across
        every instrumented layer: port dispatch, executor lanes and IO
        completion, service calls, the MMU pager, reconfigure, and
        migration.  Deterministic: same plan + same workload => same
        faults at the same hits."""
        self.faults = plan
        self.scheduler.faults = plan
        mmu = self.services.get("mmu")
        if mmu is not None:
            mmu.faults = plan

    def check_health(self, auto_recover: bool = False) -> Dict[str, Any]:
        """One watchdog sweep: a slot with pending work (queued/active
        engine requests or in-flight port invocations) whose heartbeat
        is stale is WEDGED — recorded as a typed fault and, with
        ``auto_recover``, recovered in place via
        quiesce-snapshot-restart-restore (:meth:`recover_slot`)."""
        pending: Dict[int, bool] = {}
        for slot, eng in list(self.engines.items()):
            pending[slot] = bool(eng.pending())
        for port in self.vfpga_ports():
            slot = port.vfpga.slot
            pending[slot] = pending.get(slot, False) or port.inflight() > 0
        wedged = self.health.wedged(pending)
        recovered: List[int] = []
        failed: List[int] = []
        for slot in wedged:
            tenant = (self.vfpgas[slot].tenant
                      if slot < len(self.vfpgas) else None)
            self.health.record_fault(
                FaultKind.WEDGE, slot=slot, tenant=tenant,
                site="watchdog", strike=False,
                msg=f"slot {slot} has pending work but a stale heartbeat")
            if not auto_recover:
                continue
            try:
                self.recover_slot(slot)
                recovered.append(slot)
            except Exception as e:  # noqa: BLE001 — one unrecoverable
                # slot must not stop the sweep over the others
                failed.append(slot)
                self.health.record_event("recovery_failed", slot=slot,
                                         error=str(e))
        return {"pending": pending, "wedged": wedged,
                "recovered": recovered, "failed": failed}

    def vfpga_ports(self) -> List[VFpgaPort]:
        return [p for p in self.ports.values() if isinstance(p, VFpgaPort)]

    def recover_slot(self, slot: int, *, drain_timeout: float = 5.0):
        """Recover ONE slot in place: quiesce (force-failing a stuck
        in-flight tail), snapshot the tenant through the migration
        container, cold-reset the engine's device soft state, restore —
        KV pages (device + refcounted host payloads) survive and
        decoding resumes token-for-token.  Returns a
        :class:`~repro_torch.core.migrate.RecoveryReport`."""
        from repro_torch.core.migrate import recover_tenant_local
        report = recover_tenant_local(self, slot,
                                      drain_timeout=drain_timeout)
        self.health.record_recovery(slot, report.tenant,
                                    report.downtime_s)
        self.health.beat(slot)        # fresh grace period post-recovery
        return report

    def start_watchdog(self, *, interval_s: float = 0.25,
                       auto_recover: bool = True) -> Watchdog:
        """Start (idempotently) the background health sweeper."""
        if self._watchdog is None:
            self._watchdog = Watchdog(self, interval_s=interval_s,
                                      auto_recover=auto_recover)
        return self._watchdog

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    # ================================================= datapath =============
    def kick(self, slot: int) -> None:
        """Legacy datapath: drain a slot's raw send queues into the
        scheduler.  ``CThread.invoke`` no longer uses the send queues (it
        is a shim over ``port.submit``); this remains for code that still
        pushes SG entries into ``iface.sq_read``/``sq_write`` directly."""
        vf = self.vfpgas[slot]
        for sq, cq in ((vf.iface.sq_read, vf.iface.cq_read),
                       (vf.iface.sq_write, vf.iface.cq_write)):
            while True:
                item = sq.pop(timeout=0)
                if item is None:
                    break
                ticket, sg = item
                self.scheduler.submit(
                    slot=slot, stream=sg.src_stream, ticket=ticket, sg=sg,
                    execute=vf.execute_sg, complete=cq.complete)

    def drain(self) -> None:
        """Block until every accepted submission has fully completed."""
        self.scheduler.drain()
        self.arbiter.drain()          # legacy direct-arbiter submissions

    def close(self) -> None:
        self.stop_watchdog()
        self.scheduler.close()

    def status(self) -> Dict[str, Any]:
        return {
            "services": self.services.status(),
            "slots": [vf.status() for vf in self.vfpgas],
            "ports": {name: {**p.stats(),
                             "capabilities": p.capabilities().to_dict()}
                      for name, p in self.ports.items()},
            "compile_cache": self.static.compile_cache.stats(),
            "link_bytes": self.static.pcie.bytes_moved,
            "fairness": self.arbiter.fairness(),
            "scheduler": self.scheduler.stats(),
            "health": self.health.status(),
        }
