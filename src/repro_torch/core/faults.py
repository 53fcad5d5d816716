"""Seeded, deterministic fault injection for the shell (robustness layer).

Coyote v2 promises that a slot can be lost or reconfigured without taking
down the shell; RC3E frames the cloud version, where a controller must
*detect* unhealthy virtual FPGAs and recover tenants automatically.  That
machinery is untestable without a way to make things fail on demand — and
fail *the same way every run*.  This module is that way:

  * :class:`FaultKind` — ONE taxonomy of typed fault kinds shared by the
    serving shell and the trainer (``repro.train.loop.SimulatedFailure``
    is a :class:`InjectedFault` of kind ``NODE_FAILURE``).
  * :class:`FaultSpec` — one armed fault: a kind, a named injection
    ``site``, skip/fire counts (``after``/``count``), an optional firing
    probability ``p``, and slot/tenant filters.
  * :class:`FaultPlan` — an ordered set of specs plus a seeded RNG.  The
    shell's instrumented paths call :meth:`FaultPlan.fire` at named sites
    (e.g. ``"lane.execute"``, ``"pager.gather"``); an armed matching spec
    raises :class:`InjectedFault` there.  Behavioural faults (the
    page-fault storm) use :meth:`FaultPlan.force`, which returns the spec
    instead of raising so the call site can *simulate* pressure (forced
    eviction churn) rather than crash.

Determinism contract: with the same plan (specs + seed) and the same
sequence of ``fire``/``force`` calls, the same faults fire at the same
hits.  Probabilistic specs draw from the plan's own
``np.random.RandomState`` — never from global randomness.

Injection sites wired in this repo (see docs/api.md):

    port.dispatch     Port._safe_dispatch (any invocation kind)
    lane.execute      ShellScheduler._execute_batch, SG work
    io.complete       ShellScheduler._execute_batch, pure-IO batches
    service.call      ServicePort method execution
    pager.gather      MMU evict-with-copy gather (evict + CoW paths)
    pager.scatter     MMU fault-back-in scatter
    mmu.page_storm    MMU._take_device_page (force mode: eviction churn)
    reconfig.load     Shell.reconfigure, between snapshot and load
    migrate.precopy   migrate_precopy(), each warm copy round
    migrate.snapshot  migrate(), stage 2
    migrate.restore   migrate(), stage 3
    migrate.replay    migrate(), stage 4
    train.step        Trainer._run_inner, once per step
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


class FaultKind(str, Enum):
    """Typed fault kinds — the one taxonomy every injector and every
    health record uses (``str`` mixin: JSON-safe, comparable to its
    value)."""
    LANE_CRASH = "lane_crash"            # executor-lane body exception
    IO_ERROR = "io_error"                # DMA/IO completion error
    DISPATCH = "dispatch"                # port dispatch-path exception
    SERVICE_CALL = "service_call"        # service method raised
    PAGER_GATHER = "pager_gather"        # evict-with-copy gather failed
    PAGER_SCATTER = "pager_scatter"      # fault-back-in scatter failed
    PAGE_FAULT_STORM = "page_fault_storm"  # forced eviction churn
    RECONFIG_ABORT = "reconfig_abort"    # hot-swap aborted mid-load
    MIGRATION_FAIL = "migration_fail"    # migration failed mid-container
    NODE_FAILURE = "node_failure"        # whole-node crash (trainer)
    WEDGE = "wedge"                      # watchdog: stale heartbeat + work
    QUIESCE_TIMEOUT = "quiesce_timeout"  # drain did not converge
    IO_FLUSH_TIMEOUT = "io_flush_timeout"  # flush_io did not drain
    QUARANTINED = "quarantined"          # typed rejection of a bad tenant
    SLO_INFEASIBLE = "slo_infeasible"    # gateway: deadline can't be met
    SLO_EXPIRED = "slo_expired"          # gateway: deadline passed queued
    GATEWAY_FULL = "gateway_full"        # gateway: admission queue bound


# Kinds that are transient by nature: a bounded re-dispatch of the same
# invocation is expected to succeed (the Port retry machinery consults
# this through ``InjectedFault.retryable``).  Aborts/wedges/rejections
# are terminal — retrying them would just repeat the failure.
DEFAULT_RETRYABLE = frozenset({
    FaultKind.LANE_CRASH, FaultKind.IO_ERROR, FaultKind.DISPATCH,
    FaultKind.SERVICE_CALL, FaultKind.PAGER_GATHER,
    FaultKind.PAGER_SCATTER, FaultKind.PAGE_FAULT_STORM,
    # a full gateway queue is load, not damage: back off and resubmit
    FaultKind.GATEWAY_FULL,
})

# Default injection site per kind, for the FaultPlan.single() shorthand.
DEFAULT_SITES: Dict[FaultKind, str] = {
    FaultKind.LANE_CRASH: "lane.execute",
    FaultKind.IO_ERROR: "io.complete",
    FaultKind.DISPATCH: "port.dispatch",
    FaultKind.SERVICE_CALL: "service.call",
    FaultKind.PAGER_GATHER: "pager.gather",
    FaultKind.PAGER_SCATTER: "pager.scatter",
    FaultKind.PAGE_FAULT_STORM: "mmu.page_storm",
    FaultKind.RECONFIG_ABORT: "reconfig.load",
    FaultKind.MIGRATION_FAIL: "migrate.restore",
    FaultKind.NODE_FAILURE: "train.step",
}


class InjectedFault(RuntimeError):
    """A typed, injected failure.  Carries enough context for the Port
    layer to build a structured ``PortError`` (kind, site, slot, tenant,
    retryable) and for the health monitor to account it."""

    def __init__(self, message: str = "", *,
                 kind: FaultKind = FaultKind.NODE_FAILURE,
                 site: str = "", slot: Optional[int] = None,
                 tenant: Optional[str] = None,
                 retryable: Optional[bool] = None):
        self.kind = FaultKind(kind)
        self.site = site
        self.slot = slot
        self.tenant = tenant
        self.retryable = (retryable if retryable is not None
                          else self.kind in DEFAULT_RETRYABLE)
        super().__init__(message or f"injected {self.kind.value} at "
                         f"{site or DEFAULT_SITES.get(self.kind, '?')}")


@dataclass
class FaultSpec:
    """One armed fault.  Matching is positional and deterministic: the
    spec matches its ``site`` (and optional slot/tenant filters); the
    first ``after`` matching hits pass through unharmed, then the next
    ``count`` hits fire (each gated by probability ``p`` drawn from the
    plan's seeded RNG)."""
    kind: FaultKind
    site: str = ""                       # default: DEFAULT_SITES[kind]
    after: int = 0                       # matching hits to skip first
    count: int = 1                       # fires before the spec disarms
    p: float = 1.0                       # per-hit firing probability
    slot: Optional[int] = None           # only this slot (None = any)
    tenant: Optional[str] = None         # only this tenant (None = any)
    retryable: Optional[bool] = None     # override DEFAULT_RETRYABLE
    message: str = ""
    # runtime counters (owned by the plan, under its lock)
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self) -> None:
        self.kind = FaultKind(self.kind)
        if not self.site:
            self.site = DEFAULT_SITES.get(self.kind, "")
        if not self.site:
            raise ValueError(f"FaultSpec({self.kind}) needs a site")


class FaultPlan:
    """A deterministic, seeded set of armed faults.

        plan = FaultPlan([FaultSpec(FaultKind.LANE_CRASH, after=2)],
                         seed=7)
        shell.set_fault_plan(plan)

    Instrumented shell paths call ``plan.fire(site, slot=, tenant=)``;
    an armed matching spec raises :class:`InjectedFault`.  Thread-safe:
    lanes, the scheduler worker, and engine threads all probe the same
    plan.
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), *, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self.fired: List[Dict[str, Any]] = []      # audit log of firings

    @classmethod
    def single(cls, kind: FaultKind, *, seed: int = 0,
               **spec_kw: Any) -> "FaultPlan":
        """One-spec shorthand: ``FaultPlan.single(FaultKind.IO_ERROR,
        after=3)``."""
        return cls([FaultSpec(kind=kind, **spec_kw)], seed=seed)

    def arm(self, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self.specs.append(spec)
        return spec

    # ------------------------------------------------------------ firing ---
    def _match(self, site: str, slot: Optional[int],
               tenant: Optional[str]) -> Optional[FaultSpec]:
        with self._lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.slot is not None and slot is not None \
                        and spec.slot != slot:
                    continue
                if spec.tenant is not None and tenant is not None \
                        and spec.tenant != tenant:
                    continue
                spec.hits += 1
                if spec.fired >= spec.count or spec.hits <= spec.after:
                    continue
                if spec.p < 1.0 and self._rng.random_sample() >= spec.p:
                    continue
                spec.fired += 1
                self.fired.append({"kind": spec.kind.value, "site": site,
                                   "slot": slot, "tenant": tenant,
                                   "hit": spec.hits})
                return spec
        return None

    def fire(self, site: str, *, slot: Optional[int] = None,
             tenant: Optional[str] = None, **ctx: Any) -> None:
        """Raise :class:`InjectedFault` if an armed spec matches this hit
        (extra ``ctx`` keys are accepted for call-site convenience and
        folded into the message)."""
        spec = self._match(site, slot, tenant)
        if spec is None:
            return
        detail = "".join(f" {k}={v}" for k, v in sorted(ctx.items()))
        raise InjectedFault(
            spec.message or f"injected {spec.kind.value} at {site} "
            f"(hit {spec.hits}, slot={slot}, tenant={tenant}{detail})",
            kind=spec.kind, site=site, slot=slot, tenant=tenant,
            retryable=spec.retryable)

    def force(self, site: str, *, slot: Optional[int] = None,
              tenant: Optional[str] = None) -> Optional[FaultSpec]:
        """Non-raising probe for behavioural faults: the matching spec is
        consumed and RETURNED, and the call site simulates the failure
        mode itself (e.g. the MMU treats the pool as exhausted to force
        a real evict/fault-in cycle)."""
        return self._match(site, slot, tenant)

    # ------------------------------------------------------------- stats ---
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [{"kind": s.kind.value, "site": s.site,
                           "after": s.after, "count": s.count,
                           "hits": s.hits, "fired": s.fired}
                          for s in self.specs],
                "fired_total": len(self.fired),
            }

    def exhausted(self) -> bool:
        """True once every armed spec has fired its full count."""
        with self._lock:
            return all(s.fired >= s.count for s in self.specs)


def maybe_fire(plan: Optional["FaultPlan"], site: str, *,
               slot: Optional[int] = None, tenant: Optional[str] = None,
               **ctx: Any) -> None:
    """``plan.fire`` guarded against ``plan is None`` — the shape every
    instrumented call site uses so uninstrumented runs cost one attribute
    load and one comparison."""
    if plan is not None:
        plan.fire(site, slot=slot, tenant=tenant, **ctx)
