"""Per-slot health tracking: heartbeats, fault windows, quarantine.

The observability half of the self-healing shell (the RC3E "detect
unhealthy vFPGAs" loop).  :class:`HealthMonitor` is a passive, thread-safe
ledger the shell's datapaths feed:

  * **Heartbeats** — executor lanes beat once per executed batch and
    ``ServingEngine.step`` beats once per decode step.  A slot whose last
    beat is older than ``heartbeat_timeout_s`` *while it still has
    pending work* is **wedged** (an idle slot is never wedged — silence
    without work is just silence).
  * **Fault windows** — every typed fault is counted by kind and, when
    attributable, struck against its tenant.  ``quarantine_after``
    strikes inside ``quarantine_window_s`` quarantines the tenant:
    further submissions are rejected fast with a typed
    ``PortError(kind=QUARANTINED)`` while bystanders keep their SLOs.
  * **Events** — a bounded deque of recent health events (faults,
    recoveries, quarantines, quiesce/IO-flush timeouts) for
    ``Shell.status()["health"]``.

:class:`Watchdog` is the active half: a daemon thread that periodically
calls ``shell.check_health(auto_recover=...)`` so wedged slots are
detected and recovered without anyone polling.  It is opt-in
(``Shell.start_watchdog``) — tests mostly drive ``check_health``
directly for determinism.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.core.faults import FaultKind


class HealthMonitor:
    """Thread-safe health ledger: heartbeats, fault counts, quarantines."""

    def __init__(self, *, heartbeat_timeout_s: float = 2.0,
                 quarantine_after: int = 3,
                 quarantine_window_s: float = 30.0,
                 max_events: int = 256):
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.quarantine_after = quarantine_after
        self.quarantine_window_s = quarantine_window_s
        self._lock = threading.Lock()
        self._beats: Dict[int, float] = {}          # slot -> perf_counter
        self._fault_counts: Dict[str, int] = {}
        self._strikes: Dict[str, List[float]] = {}  # tenant -> fault times
        self._quarantined: Dict[str, str] = {}      # tenant -> reason
        self._events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self.faults_total = 0
        self.recoveries = 0
        self.rejections = 0                          # quarantine rejections

    # --------------------------------------------------------- heartbeats --
    def beat(self, slot: int) -> None:
        with self._lock:
            self._beats[slot] = time.perf_counter()

    def last_beat_age(self, slot: int) -> Optional[float]:
        """Seconds since the slot's last heartbeat (None = never beat)."""
        with self._lock:
            t = self._beats.get(slot)
        return None if t is None else time.perf_counter() - t

    def wedged(self, pending: Dict[int, bool]) -> List[int]:
        """Slots with pending work whose heartbeat is stale.  A slot that
        never beat gets a grace beat on first sight, so freshly loaded
        slots are not declared dead before their first step."""
        now = time.perf_counter()
        out = []
        with self._lock:
            for slot, has_work in pending.items():
                if not has_work:
                    continue
                t = self._beats.get(slot)
                if t is None:
                    self._beats[slot] = now          # grace period starts
                    continue
                if now - t > self.heartbeat_timeout_s:
                    out.append(slot)
        return out

    # ------------------------------------------------------------- faults --
    def record_fault(self, kind: Any, *, slot: Optional[int] = None,
                     tenant: Optional[str] = None, site: str = "",
                     msg: str = "", strike: bool = True) -> bool:
        """Account one typed fault; returns True when this fault NEWLY
        quarantined its tenant (``strike=False`` records without counting
        toward quarantine — used for informational events)."""
        kind = FaultKind(kind).value if not isinstance(kind, str) else kind
        newly = False
        now = time.perf_counter()
        with self._lock:
            self.faults_total += 1
            self._fault_counts[kind] = self._fault_counts.get(kind, 0) + 1
            self._events.append({"t": now, "event": "fault", "kind": kind,
                                 "slot": slot, "tenant": tenant,
                                 "site": site, "msg": msg})
            if strike and tenant is not None:
                times = self._strikes.setdefault(tenant, [])
                times.append(now)
                floor = now - self.quarantine_window_s
                times[:] = [t for t in times if t >= floor]
                if (len(times) >= self.quarantine_after
                        and tenant not in self._quarantined):
                    self._quarantined[tenant] = (
                        f"{len(times)} {kind} fault(s) within "
                        f"{self.quarantine_window_s:.0f}s")
                    self._events.append({"t": now, "event": "quarantine",
                                         "tenant": tenant, "kind": kind})
                    newly = True
        return newly

    def record_event(self, event: str, **fields: Any) -> None:
        """Informational health event (recovery detail, flush timeout...)
        — visible in ``status()["events"]``, no fault accounting."""
        with self._lock:
            self._events.append({"t": time.perf_counter(), "event": event,
                                 **fields})

    def record_recovery(self, slot: int, tenant: Optional[str],
                        downtime_s: float) -> None:
        with self._lock:
            self.recoveries += 1
            self._events.append({"t": time.perf_counter(),
                                 "event": "recovery", "slot": slot,
                                 "tenant": tenant,
                                 "downtime_s": downtime_s})

    # --------------------------------------------------------- quarantine --
    def is_quarantined(self, tenant: Optional[str]) -> bool:
        if tenant is None:
            return False
        with self._lock:
            return tenant in self._quarantined

    def quarantine(self, tenant: str, reason: str = "manual") -> None:
        with self._lock:
            self._quarantined[tenant] = reason
            self._events.append({"t": time.perf_counter(),
                                 "event": "quarantine", "tenant": tenant,
                                 "reason": reason})

    def unquarantine(self, tenant: str) -> bool:
        """Lift a quarantine (operator verb); clears the strike window so
        the next fault starts a fresh count."""
        with self._lock:
            was = self._quarantined.pop(tenant, None) is not None
            self._strikes.pop(tenant, None)
            if was:
                self._events.append({"t": time.perf_counter(),
                                     "event": "unquarantine",
                                     "tenant": tenant})
        return was

    def record_rejection(self, tenant: Optional[str]) -> None:
        with self._lock:
            self.rejections += 1

    def recent_faults(self, window_s: float = 30.0) -> int:
        """Fault events recorded within the trailing window — the fleet
        controller's hotspot/health signal when scoring placements.
        Bounded by the event ring (``max_events``), which is fine: a
        member with a saturated ring is not a placement candidate."""
        floor = time.perf_counter() - window_s
        with self._lock:
            return sum(1 for e in self._events
                       if e.get("event") == "fault" and e["t"] >= floor)

    # -------------------------------------------------------------- status --
    def status(self) -> Dict[str, Any]:
        now = time.perf_counter()
        with self._lock:
            return {
                "faults_total": self.faults_total,
                "fault_counts": dict(self._fault_counts),
                "recoveries": self.recoveries,
                "rejections": self.rejections,
                "quarantined": dict(self._quarantined),
                "last_heartbeat_age_s": {
                    slot: now - t for slot, t in self._beats.items()},
                "events": list(self._events)[-20:],
            }


class Watchdog:
    """Daemon thread: periodically runs ``shell.check_health`` so wedged
    slots are detected (and optionally recovered) without polling."""

    def __init__(self, shell: Any, *, interval_s: float = 0.25,
                 auto_recover: bool = True):
        self.shell = shell
        self.interval_s = interval_s
        self.auto_recover = auto_recover
        self.sweeps = 0
        self.last_result: Dict[str, Any] = {}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop,
                                       name="shell-watchdog", daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.last_result = self.shell.check_health(
                    auto_recover=self.auto_recover)
            except Exception as e:  # noqa: BLE001 — the watchdog must
                # outlive whatever it finds; a failed sweep is an event,
                # not a watchdog death
                self.shell.health.record_event("watchdog_error",
                                               error=str(e))
            self.sweeps += 1

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self.thread.join(timeout=timeout)
