"""FleetController: decides *when* and *where* tenants move.

PR 5 made ``migrate()`` a manual verb; this module is the control plane
that drives it (and its pre-copy successor) automatically:

- **Placement** — ``place(pages_needed)`` scores every member by free
  KV-page fraction minus a recent-fault penalty (``HealthMonitor.
  recent_faults``) and returns the best shell with capacity.  Members
  that cannot fit the tenant are excluded outright, not down-scored.
- **Sweeps** — ``sweep()`` is the reconcile loop body: every member's
  ``check_health`` runs first (wedged slots are recovered in place via
  ``Shell.recover_slot``, or migrated off when recovery fails), then
  hotspots (aggregate page utilization above ``hot_util``) shed their
  largest tenant to a colder member with capacity.  Moves use
  :func:`repro.core.migrate.migrate_precopy` unless ``precopy=False``.
- **Stream re-routing** — when both members have a registered
  ``ServingGateway`` (``attach_gateway``), a successful move re-homes
  the tenant's live ``TokenStream``s onto the destination gateway
  (``adopt_streams``): readers keep their stream objects, tokens keep
  flowing, exactly once.

Every action (including failed ones) is recorded as a
:class:`FleetDecision` — the controller's audit log.

Engines on different members must use disjoint ``rid_base`` ranges
(the same rule every cross-shell migration already has).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.migrate import MigrationError, migrate, migrate_precopy

__all__ = ["FleetController", "FleetDecision"]


@dataclass
class FleetDecision:
    """One controller action: what it did, to whom, and why."""
    action: str                       # "place" | "migrate" | "recover"
    tenant: Optional[str] = None
    src: Optional[str] = None         # member name
    dst: Optional[str] = None
    reason: str = ""
    ok: bool = True
    error: str = ""
    report: Any = None                # MigrationReport / RecoveryReport

    def to_dict(self) -> Dict[str, Any]:
        return {"action": self.action, "tenant": self.tenant,
                "src": self.src, "dst": self.dst, "reason": self.reason,
                "ok": self.ok, "error": self.error}


class FleetController:
    """Control plane over a pool of shells.

    ``engine_factory(shell, slot) -> ServingEngine`` lets the controller
    materialize a destination engine on a free vFPGA slot when no idle
    matching-geometry engine exists on the chosen member (the factory
    must bind the engine to the shell/slot, which ``ServingEngine(
    shell=..., slot=...)`` does by construction).
    """

    def __init__(self, *, precopy: bool = True, hot_util: float = 0.85,
                 cold_util: float = 0.60, fault_window_s: float = 30.0,
                 max_moves_per_sweep: int = 1, drain_timeout: float = 30.0,
                 auto_recover: bool = True,
                 engine_factory: Optional[Callable] = None):
        self.precopy = precopy
        self.hot_util = hot_util
        self.cold_util = cold_util
        self.fault_window_s = fault_window_s
        self.max_moves_per_sweep = max_moves_per_sweep
        self.drain_timeout = drain_timeout
        self.auto_recover = auto_recover
        self.engine_factory = engine_factory
        self.shells: List[Any] = []
        self.decisions: List[FleetDecision] = []
        self._gateways: Dict[str, Any] = {}       # member name -> gateway

    # ------------------------------------------------------------ members --
    def add_shell(self, shell) -> None:
        if any(s.name == shell.name for s in self.shells):
            raise ValueError(f"duplicate fleet member name {shell.name!r}")
        self.shells.append(shell)

    def attach_gateway(self, shell, gateway) -> None:
        """Register the member's serving gateway so migrations re-route
        its live token streams."""
        self._gateways[shell.name] = gateway

    def member_load(self, shell) -> Dict[str, Any]:
        """Aggregate paged-memory load of one member (each engine-owned
        MMU counted once, plus the shell's own mmu service)."""
        mmus = {}
        for eng in shell.engines.values():
            mmus[id(eng.mmu)] = eng.mmu
        if "mmu" in shell.services.names():
            svc = shell.services.get("mmu")
            mmus.setdefault(id(svc), svc)
        total = used = seqs = dirty = 0
        for mmu in mmus.values():
            u = mmu.utilization()
            total += u["pages_total"]
            used += u["pages_used"]
            seqs += u["sequences"]
            dirty += u.get("dirty_pages", 0)
        return {
            "name": shell.name,
            "pages_total": total, "pages_used": used,
            "pages_free": total - used, "sequences": seqs,
            "dirty_pages": dirty,
            "util": used / max(total, 1),
            "recent_faults": shell.health.recent_faults(
                self.fault_window_s),
        }

    # ---------------------------------------------------------- placement --
    def placement_score(self, shell, pages_needed: int = 0
                        ) -> Optional[float]:
        """Higher is better; None means the member is excluded (cannot
        fit the tenant).  Free-page fraction dominates; recent faults
        subtract a fixed penalty each so a flapping member loses to a
        clean one at equal occupancy."""
        load = self.member_load(shell)
        if pages_needed and load["pages_free"] < pages_needed:
            return None
        return (load["pages_free"] / max(load["pages_total"], 1)
                - 0.1 * load["recent_faults"])

    def place(self, pages_needed: int = 0, *,
              exclude=()) -> Optional[Any]:
        """The best member for a new ``pages_needed``-page tenant (None
        when nobody has capacity).  Records a ``place`` decision."""
        best, best_score = None, None
        for shell in self.shells:
            if shell in exclude or shell.name in exclude:
                continue
            score = self.placement_score(shell, pages_needed)
            if score is not None and (best_score is None
                                      or score > best_score):
                best, best_score = shell, score
        self.decisions.append(FleetDecision(
            action="place", dst=best.name if best else None,
            ok=best is not None,
            reason=f"pages_needed={pages_needed} score={best_score}"))
        return best

    # ------------------------------------------------------------- sweeps --
    def sweep(self) -> List[FleetDecision]:
        """One reconcile pass: heal wedged slots, then cool hotspots.
        Returns the decisions taken this pass (also appended to
        ``self.decisions``)."""
        out: List[FleetDecision] = []
        moves = 0
        for shell in self.shells:
            hc = shell.check_health(auto_recover=False)
            for slot in hc["wedged"]:
                d = self._heal(shell, slot)
                out.append(d)
                if d.action == "migrate" and d.ok:
                    moves += 1
        for shell in self.shells:
            if moves >= self.max_moves_per_sweep:
                break
            load = self.member_load(shell)
            if load["util"] <= self.hot_util:
                continue
            d = self._cool_hotspot(shell, load)
            if d is not None:
                out.append(d)
                if d.ok:
                    moves += 1
        self.decisions.extend(out)
        return out

    def _heal(self, shell, slot: int) -> FleetDecision:
        """A wedged slot: recover in place; if that fails, evacuate the
        tenant to another member (the slot itself is suspect)."""
        eng = shell.engines.get(slot)
        tenant = getattr(eng, "tenant", None) if eng is not None else None
        if self.auto_recover:
            try:
                rep = shell.recover_slot(slot,
                                         drain_timeout=self.drain_timeout)
                return FleetDecision(action="recover", tenant=tenant,
                                     src=shell.name, reason="wedged",
                                     report=rep)
            except Exception as e:  # noqa: BLE001 — recovery failing is
                # exactly the case the fleet exists for: migrate off
                err = str(e)
        else:
            err = "auto_recover disabled"
        d = self._migrate_off(shell, slot, reason=f"wedged ({err})")
        d.tenant = d.tenant or tenant
        return d

    def _cool_hotspot(self, shell, load) -> Optional[FleetDecision]:
        """Shed the hot member's largest tenant to a colder member."""
        victims = []
        for slot, eng in shell.engines.items():
            rids = [r.rid for r in eng.slots if r is not None]
            pages = len(eng.mmu.live_page_keys(rids)) if rids else 0
            if pages:
                victims.append((pages, slot))
        for pages, slot in sorted(victims, reverse=True):
            d = self._migrate_off(
                shell, slot, min_pages=pages,
                reason=f"hotspot util={load['util']:.2f}")
            if d is not None:
                return d
        return None

    def _migrate_off(self, src_shell, slot: int, *, min_pages: int = 0,
                     reason: str = "") -> Optional[FleetDecision]:
        """Move the tenant on ``src_shell[slot]`` to the best other
        member that can take it; None when no candidate exists AND the
        call came from hotspot cooling (healing always records)."""
        eng = src_shell.engines.get(slot)
        tenant = getattr(eng, "tenant", None) if eng is not None else None
        candidates = []
        for dst in self.shells:
            if dst is src_shell:
                continue
            score = self.placement_score(dst, min_pages)
            dload = self.member_load(dst)
            if score is None or dload["util"] >= self.cold_util:
                continue
            candidates.append((score, dst))
        if not candidates:
            return FleetDecision(
                action="migrate", tenant=tenant, src=src_shell.name,
                ok=False, reason=reason,
                error="no member with capacity below cold_util")
        candidates.sort(key=lambda c: c[0], reverse=True)
        _, dst_shell = candidates[0]
        dslot = self._dst_slot_for(dst_shell, eng)
        if dslot is None:
            return FleetDecision(
                action="migrate", tenant=tenant, src=src_shell.name,
                dst=dst_shell.name, ok=False, reason=reason,
                error="no idle matching-geometry engine on destination "
                      "(pass engine_factory= to create one)")
        mover = migrate_precopy if self.precopy else migrate
        try:
            rep = mover(src_shell, dst_shell, slot, dst_slot=dslot,
                        drain_timeout=self.drain_timeout)
        except MigrationError as e:
            return FleetDecision(
                action="migrate", tenant=tenant, src=src_shell.name,
                dst=dst_shell.name, ok=False, reason=reason,
                error=str(e))
        self._reroute(src_shell, dst_shell)
        return FleetDecision(
            action="migrate", tenant=rep.tenant, src=src_shell.name,
            dst=dst_shell.name, reason=reason, report=rep)

    def migrate_tenant(self, tenant: str, dst_shell=None) -> FleetDecision:
        """Operator verb: move ``tenant`` (found by name) to
        ``dst_shell`` or the best-scoring member."""
        for shell in self.shells:
            for slot, eng in shell.engines.items():
                if getattr(eng, "tenant", None) == tenant:
                    if dst_shell is None:
                        d = self._migrate_off(shell, slot,
                                              reason="operator")
                    else:
                        d = self._move_to(shell, slot, dst_shell,
                                          reason="operator")
                    self.decisions.append(d)
                    return d
        raise KeyError(f"no member serves tenant {tenant!r}")

    def _move_to(self, src_shell, slot: int, dst_shell, *,
                 reason: str) -> FleetDecision:
        eng = src_shell.engines.get(slot)
        tenant = getattr(eng, "tenant", None) if eng is not None else None
        dslot = self._dst_slot_for(dst_shell, eng)
        if dslot is None:
            return FleetDecision(
                action="migrate", tenant=tenant, src=src_shell.name,
                dst=dst_shell.name, ok=False, reason=reason,
                error="no idle matching-geometry engine on destination")
        mover = migrate_precopy if self.precopy else migrate
        try:
            rep = mover(src_shell, dst_shell, slot, dst_slot=dslot,
                        drain_timeout=self.drain_timeout)
        except MigrationError as e:
            return FleetDecision(
                action="migrate", tenant=tenant, src=src_shell.name,
                dst=dst_shell.name, ok=False, reason=reason,
                error=str(e))
        self._reroute(src_shell, dst_shell)
        return FleetDecision(
            action="migrate", tenant=rep.tenant, src=src_shell.name,
            dst=dst_shell.name, reason=reason, report=rep)

    def _dst_slot_for(self, dst_shell, src_engine) -> Optional[int]:
        """An idle destination engine with matching geometry, or a
        fresh one from ``engine_factory`` on a free vFPGA slot."""
        if src_engine is None:
            return None
        geo = src_engine.geometry()
        for dslot, eng in sorted(dst_shell.engines.items()):
            if (eng is not src_engine and eng.geometry() == geo
                    and eng.active == 0 and not eng.queue):
                return dslot
        if self.engine_factory is not None:
            for dslot in range(dst_shell.config.n_vfpgas):
                if dslot not in dst_shell.engines:
                    self.engine_factory(dst_shell, dslot)
                    return dslot
        return None

    def _reroute(self, src_shell, dst_shell) -> None:
        gsrc = self._gateways.get(src_shell.name)
        gdst = self._gateways.get(dst_shell.name)
        if gsrc is not None and gdst is not None and gsrc is not gdst:
            gdst.adopt_streams(gsrc)

    # -------------------------------------------------------------- status --
    def status(self) -> Dict[str, Any]:
        return {
            "members": [self.member_load(s) for s in self.shells],
            "decisions": [d.to_dict() for d in self.decisions[-20:]],
            "moves": sum(1 for d in self.decisions
                         if d.action == "migrate" and d.ok),
            "recoveries": sum(1 for d in self.decisions
                              if d.action == "recover" and d.ok),
        }
