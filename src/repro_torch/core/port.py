"""Port API v2: ONE typed async interface for every vFPGA slot (§7.1).

Coyote v2's core claim is a *unified logic interface*: services and user
logic present the same bundle, which is what makes partial reconfiguration
and multi-tenancy composable.  Before this module the repro had three
divergent call paths — ``CThread.invoke`` sg-lists into send queues,
``ShellScheduler.submit_io`` for the serving engine's decode I/O, and
direct Python method calls into ``core/services/*``.  A :class:`Port`
collapses them into one surface:

    port = shell.attach(slot_or_service_name)       # capability handshake
    fut  = port.submit(Invocation(...))             # async, TID-multiplexed
    comp = fut.result(timeout)                      # Completion record

Every submission — app scatter-gather work, service method calls, raw
decode-step I/O — is credit-billed through the shell scheduler under the
port's tenant and lands back on the slot's completion queue, so QoS
accounting and synchronization are uniform across slot kinds.

Drain-aware lifecycle (the reconfiguration story): a port is ACTIVE,
DRAINING, or QUIESCED.  ``quiesce()`` stops intake (new submissions are
*held*, not rejected), awaits the in-flight tail, and freezes the slot;
``snapshot()``/``restore()`` move the CSR file and host address map across
a swap; ``resume()`` replays held invocations in FIFO order against the
newly loaded logic.  ``Shell.reconfigure(slot, bitstream)`` composes these
into hot-swap with zero lost or duplicated completions.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
# builtin TimeoutError only aliases this from Python 3.11 on
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.faults import FaultKind, InjectedFault
from repro_torch.core.interfaces import Completion, Oper, SgEntry
from repro_torch.core.scheduler import SHARED_LANE_SLOT_BASE


class PortState(Enum):
    ACTIVE = "active"
    DRAINING = "draining"      # intake held, in-flight completing
    QUIESCED = "quiesced"      # no in-flight work; safe to swap the slot


@dataclass(frozen=True)
class PortCapabilities:
    """Capability descriptor registered at ``Shell.attach()``.

    The software analogue of the paper's interface bundle: how many
    parallel streams the logic exposes, its memory-mapped control
    registers (by name), and which memory model its state lives under.
    """
    name: str
    kind: str = "app"                      # app | service
    streams: int = 0
    csr_map: Mapping[str, int] = field(default_factory=dict)
    mem_model: str = "host"                # host | paged | device | none
    ops: Tuple[str, ...] = ()              # Oper values / service methods

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["csr_map"] = dict(self.csr_map)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PortCapabilities":
        return cls(name=d["name"], kind=d.get("kind", "app"),
                   streams=d.get("streams", 0),
                   csr_map=dict(d.get("csr_map", {})),
                   mem_model=d.get("mem_model", "host"),
                   ops=tuple(d.get("ops", ())))


@dataclass
class Invocation:
    """One typed unit of work submitted to a port.

    ``kind`` selects the datapath:
      * ``"sg"``     — scatter-gather descriptor against the slot's user
                       logic (the ``CThread.invoke`` path);
      * ``"io"``     — raw link I/O with no execution behind it (the
                       serving engine's decode-step billing path);
      * ``"method"`` — a named operation on a service port, with
                       ``args``/``kwargs``.

    ``priority`` and ``deadline_s`` are the SLO hook: execution on the
    slot's lane runs higher priorities first (earliest relative deadline
    breaks ties among equals), and a long-running lower-priority batch
    yields to them at its checkpoint boundaries
    (:meth:`ShellScheduler.checkpoint`).  Neither field changes what the
    DWRR arbiter *grants* nor what the tenant is *billed* — fairness and
    accounting are priority-blind.
    """
    kind: str = "sg"
    op: Oper = Oper.KERNEL
    sg: Optional[SgEntry] = None
    method: str = ""
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    nbytes: int = 0
    stream: int = 0
    tid: int = 0
    tenant: Optional[str] = None
    priority: int = 0                       # higher runs first on the lane
    deadline_s: Optional[float] = None      # relative SLO (seconds)
    meta: Dict[str, Any] = field(default_factory=dict)
    ticket: int = -1                        # assigned by the port
    # Retry/backoff policy for RETRYABLE faults (lane crash, IO error,
    # pager failure...): up to ``max_retries`` re-dispatches, each
    # preceded by ``retry_backoff_s * 2**attempt`` of backoff, and never
    # past the invocation's absolute deadline (``deadline_s`` measured
    # from first acceptance).  Default 0: faults surface immediately —
    # existing Completion(ok=False) semantics are unchanged unless a
    # caller opts in.
    max_retries: int = 0
    retry_backoff_s: float = 0.0
    retries: int = 0                        # attempts consumed (runtime)
    t_accept: float = 0.0                   # first-submit time (runtime)

    @classmethod
    def from_sg(cls, sg: SgEntry, *, priority: int = 0,
                deadline_s: Optional[float] = None) -> "Invocation":
        return cls(kind="sg", op=sg.opcode, sg=sg, nbytes=max(sg.length, 1),
                   stream=sg.src_stream, tid=sg.tid, priority=priority,
                   deadline_s=deadline_s)

    @classmethod
    def io(cls, nbytes: int, *, stream: int = 0, tag: str = "io",
           tenant: Optional[str] = None, priority: int = 0,
           deadline_s: Optional[float] = None) -> "Invocation":
        return cls(kind="io", op=Oper.LOCAL_TRANSFER, nbytes=max(nbytes, 1),
                   stream=stream, tenant=tenant, meta={"tag": tag},
                   priority=priority, deadline_s=deadline_s)

    @classmethod
    def call(cls, method: str, *args: Any, nbytes: int = 0,
             priority: int = 0, deadline_s: Optional[float] = None,
             **kwargs: Any) -> "Invocation":
        return cls(kind="method", method=method, args=args, kwargs=kwargs,
                   nbytes=nbytes, priority=priority, deadline_s=deadline_s)

    def to_sg(self) -> SgEntry:
        if self.sg is not None:
            return self.sg
        return SgEntry(length=self.nbytes, src_stream=self.stream,
                       tid=self.tid, opcode=self.op, meta=dict(self.meta))


class PortFuture(Future):
    """Future[Completion] with the originating invocation attached."""

    def __init__(self, invocation: Invocation):
        super().__init__()
        self.invocation = invocation

    @property
    def ticket(self) -> int:
        return self.invocation.ticket

    def completion(self, timeout: Optional[float] = None
                   ) -> Optional[Completion]:
        """``result()`` that returns None on timeout (legacy contract)."""
        try:
            return self.result(timeout=timeout)
        except FuturesTimeoutError:
            return None


class PortError(RuntimeError):
    """Structured port failure: WHAT failed (``kind``, a
    :class:`~repro.core.faults.FaultKind` value), WHERE (``slot``,
    ``tenant``), and whether a re-dispatch could succeed (``retryable``).
    Message-only construction stays valid for generic refusals
    (closed port, disallowed method)."""

    def __init__(self, message: str, *, kind: Any = "error",
                 slot: Optional[int] = None, tenant: Optional[str] = None,
                 retryable: bool = False,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.kind = kind.value if isinstance(kind, FaultKind) else str(kind)
        self.slot = slot
        self.tenant = tenant
        self.retryable = retryable
        self.cause = cause

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "slot": self.slot,
                "tenant": self.tenant, "retryable": self.retryable,
                "message": str(self)}


class Port:
    """Base port: state machine, in-flight tracking, hold-and-replay.

    Subclasses implement ``_dispatch(inv, fut)`` (route one invocation
    into their datapath, eventually calling ``_finish``), plus
    ``capabilities()`` and the ``snapshot()``/``restore()`` pair.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._state = PortState.ACTIVE
        self._tickets = itertools.count()
        self._inflight: Dict[int, PortFuture] = {}
        self._held: List[Tuple[Invocation, PortFuture]] = []
        self.submitted = 0
        self.completed = 0
        self.failed = 0                   # futures failed with PortError
        self.retried = 0                  # retryable-fault re-dispatches
        self.replayed = 0
        self.held_peak = 0
        self._closed = False

    # ------------------------------------------------------------ intake ---
    @property
    def state(self) -> PortState:
        return self._state

    def submit(self, inv: Invocation) -> PortFuture:
        """Submit one invocation; returns a Future[Completion].

        Never blocks on the slot itself: while the port drains or sits
        quiesced across a reconfiguration, submissions are held and
        replayed (FIFO) on ``resume()`` — callers just see a future that
        resolves after the swap.
        """
        fut = PortFuture(inv)
        slot, default_tenant = self._fault_ctx()
        tenant = inv.tenant or default_tenant
        health = self._health()
        if health is not None and health.is_quarantined(tenant):
            # graceful degradation: a repeatedly-faulting tenant is
            # rejected FAST with a typed error — bystanders keep flowing
            health.record_rejection(tenant)
            raise PortError(
                f"tenant {tenant!r} is quarantined on port {self.name!r} "
                "(repeated faults within the quarantine window); "
                "Shell.health.unquarantine() to lift",
                kind=FaultKind.QUARANTINED, slot=slot, tenant=tenant,
                retryable=False)
        with self._lock:
            if self._closed:
                raise PortError(
                    f"port {self.name!r} is closed (its slot/service was "
                    "torn down, e.g. by cold_restart); re-attach through "
                    "Shell.attach() for a live port")
            if inv.ticket < 0:
                inv.ticket = next(self._tickets)
            if inv.t_accept == 0.0:
                inv.t_accept = time.perf_counter()
            self.submitted += 1
            if self._state is not PortState.ACTIVE:
                self._held.append((inv, fut))
                self.held_peak = max(self.held_peak, len(self._held))
                return fut
            self._inflight[inv.ticket] = fut
        self._safe_dispatch(inv, fut)
        return fut

    def call(self, inv: Invocation,
             timeout: Optional[float] = None) -> Completion:
        """Synchronous convenience: submit and wait."""
        comp = self.submit(inv).result(timeout=timeout)
        return comp

    # ------------------------------------------------------- completion ----
    def _finish(self, inv: Invocation, fut: PortFuture,
                comp: Completion) -> None:
        if (not comp.ok and isinstance(comp.result, BaseException)
                and self._should_retry(inv, comp.result)):
            # a retryable fault surfaced as a failed Completion (lane
            # crash, injected service fault): consume one retry and
            # re-dispatch the SAME invocation instead of resolving
            self._requeue_retry(inv, fut)
            return
        with self._lock:
            self._inflight.pop(inv.ticket, None)
            self.completed += 1
            self._cv.notify_all()
        if not fut.done():               # a future resolves exactly once
            fut.set_result(comp)

    # ---------------------------------------------- typed failure path -----
    def _safe_dispatch(self, inv: Invocation, fut: PortFuture) -> None:
        """Dispatch with a finally-safe failure path: ANY exception out
        of the datapath (including an injected ``port.dispatch`` fault)
        fails the future with a structured :class:`PortError` instead of
        leaving it unresolved forever."""
        try:
            plan = self._fault_plan()
            if plan is not None:
                slot, default_tenant = self._fault_ctx()
                plan.fire("port.dispatch", slot=slot,
                          tenant=inv.tenant or default_tenant,
                          ticket=inv.ticket)
            self._dispatch(inv, fut)
        except BaseException as e:  # noqa: BLE001 — the future IS the
            self._fail(inv, fut, e)  # error channel; nothing may hang

    def _as_port_error(self, inv: Invocation,
                       exc: BaseException) -> PortError:
        slot, default_tenant = self._fault_ctx()
        tenant = inv.tenant or default_tenant
        if isinstance(exc, PortError):
            return exc
        kind = getattr(exc, "kind", FaultKind.DISPATCH)
        retryable = bool(getattr(exc, "retryable", False))
        return PortError(
            f"invocation {inv.ticket} on port {self.name!r} failed: "
            f"{exc}", kind=kind, slot=slot, tenant=tenant,
            retryable=retryable, cause=exc)

    def _fail(self, inv: Invocation, fut: PortFuture,
              exc: BaseException) -> None:
        """Fail one in-flight invocation with a typed error — after the
        retry policy declines it.  Pops in-flight tracking (quiesce
        waiters see it leave) and records the fault in the shell's
        health ledger when one is attached."""
        err = self._as_port_error(inv, exc)
        if self._should_retry(inv, err):
            self._requeue_retry(inv, fut)
            return
        health = self._health()
        if health is not None:
            health.record_fault(err.kind, slot=err.slot, tenant=err.tenant,
                                site=getattr(exc, "site", ""),
                                msg=str(err))
        with self._lock:
            self._inflight.pop(inv.ticket, None)
            self.failed += 1
            self._cv.notify_all()
        if not fut.done():
            fut.set_exception(err)

    def _should_retry(self, inv: Invocation, exc: BaseException) -> bool:
        if inv.retries >= inv.max_retries:
            return False
        if not getattr(exc, "retryable", False):
            return False
        if self._closed:
            return False
        if inv.deadline_s is not None and inv.t_accept > 0.0:
            # deadline-aware: a retry that cannot finish before the SLO
            # deadline is not attempted (backoff counts against it)
            backoff = inv.retry_backoff_s * (2 ** inv.retries)
            if (time.perf_counter() + backoff
                    > inv.t_accept + inv.deadline_s):
                return False
        return True

    def _requeue_retry(self, inv: Invocation, fut: PortFuture) -> None:
        """Consume one retry and re-dispatch the SAME invocation (same
        ticket, same future).  Runs on whatever thread surfaced the
        fault; the bounded exponential backoff sleeps there."""
        backoff = inv.retry_backoff_s * (2 ** inv.retries)
        inv.retries += 1
        with self._lock:
            self.retried += 1
        if backoff > 0:
            time.sleep(min(backoff, 1.0))
        with self._lock:
            if self._closed:
                self._inflight.pop(inv.ticket, None)
                self.failed += 1
                self._cv.notify_all()
                if not fut.done():
                    fut.set_exception(PortError(
                        f"port {self.name!r} closed during retry of "
                        f"invocation {inv.ticket}",
                        kind=FaultKind.DISPATCH, retryable=False))
                return
            if self._state is not PortState.ACTIVE:
                # port started draining between fault and retry: the
                # invocation re-holds and replays on resume()
                self._inflight.pop(inv.ticket, None)
                self._held.append((inv, fut))
                self.held_peak = max(self.held_peak, len(self._held))
                self._cv.notify_all()
                return
            self._inflight[inv.ticket] = fut
        self._safe_dispatch(inv, fut)

    def fail_inflight(self, exc: Optional[BaseException] = None) -> int:
        """Force-fail every in-flight invocation with a typed error — the
        recovery path for a WEDGED slot whose completions will never
        arrive (its lane died or its logic hung).  Returns how many
        futures were failed; held invocations are untouched (they replay
        after recovery)."""
        with self._lock:
            futs = list(self._inflight.items())
            self._inflight.clear()
            self.failed += len(futs)
            self._cv.notify_all()
        slot, tenant = self._fault_ctx()
        base = exc or PortError(
            f"port {self.name!r}: in-flight work force-failed during "
            "slot recovery", kind=FaultKind.WEDGE, slot=slot,
            tenant=tenant, retryable=False)
        for _ticket, fut in futs:
            if not fut.done():
                fut.set_exception(base)
        return len(futs)

    def close(self) -> None:
        """Permanently invalidate the port (its backing slot/service is
        gone).  Held invocations fail fast rather than dispatch against
        a dead object."""
        with self._lock:
            self._closed = True
            held, self._held = self._held, []
        for inv, fut in held:
            if not fut.done():
                fut.set_exception(PortError(
                    f"port {self.name!r} closed while invocation "
                    f"{inv.ticket} was held"))

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def held(self) -> int:
        with self._lock:
            return len(self._held)

    # ------------------------------------------------- drain / hot-swap ----
    def quiesce(self, timeout: Optional[float] = 30.0, *,
                resume_on_timeout: bool = True) -> bool:
        """Stop intake and wait for every in-flight completion.

        Idempotent; returns True once the port is QUIESCED.  On timeout
        False is returned and — by default — intake is REOPENED
        (``resume()``: held submissions replay, the port is ACTIVE
        again), so a failed drain can never leave the port wedged
        DRAINING with its intake silently held.  The timeout is also
        recorded as a health event when a monitor is attached.
        ``resume_on_timeout=False`` restores the old contract for
        callers that take over recovery themselves (e.g.
        ``recover_tenant_local`` force-fails the stuck tail instead).
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        timed_out = False
        with self._lock:
            if self._state is PortState.QUIESCED and not self._inflight:
                return True
            self._state = PortState.DRAINING
            while self._inflight:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    timed_out = True
                    break
                self._cv.wait(timeout=remaining if remaining else 0.25)
            if not timed_out:
                self._state = PortState.QUIESCED
                return True
        # timeout path, outside the lock (resume() re-takes it)
        health = self._health()
        if health is not None:
            slot, tenant = self._fault_ctx()
            health.record_fault(FaultKind.QUIESCE_TIMEOUT, slot=slot,
                                tenant=tenant, strike=False,
                                msg=f"port {self.name!r} quiesce timed "
                                    f"out with {self.inflight()} in flight")
        if resume_on_timeout:
            self.resume()
        return False

    def resume(self) -> int:
        """Replay held invocations in FIFO order, then reopen intake.
        Returns the number of replayed invocations.

        Intake flips to ACTIVE only once the held list is empty under
        the lock — a submission racing with the replay is held and
        drained by the next loop iteration, so no new invocation can
        overtake an older held one.
        """
        replayed = 0
        while True:
            with self._lock:
                if not self._held:
                    self._state = PortState.ACTIVE
                    return replayed
                held, self._held = self._held, []
                for inv, fut in held:
                    self._inflight[inv.ticket] = fut
            for inv, fut in held:
                self.replayed += 1
                replayed += 1
                self._safe_dispatch(inv, fut)

    def take_held(self) -> List[Tuple[Invocation, PortFuture]]:
        """Detach the held FIFO for replay on ANOTHER port — the
        cross-shell half of hold-and-replay (quiesce-and-migrate).  The
        port must be quiesced/draining; callers hand the list to the
        destination port's :meth:`replay_adopted` so every held
        submission still resolves its ORIGINAL future exactly once."""
        with self._lock:
            if self._state is PortState.ACTIVE:
                raise PortError(
                    f"take_held on ACTIVE port {self.name!r}: quiesce "
                    "first (held invocations only exist while intake is "
                    "stopped)")
            held, self._held = self._held, []
            return held

    def restore_held(self, held: List[Tuple[Invocation, PortFuture]]
                     ) -> None:
        """Re-attach invocations detached by :meth:`take_held` (a failed
        migration hands them back): they rejoin the FRONT of the held
        FIFO in their original order, re-ticketed in this port's space
        (a destination may have re-ticketed them before failing), and
        replay on the next ``resume()`` — still exactly once."""
        with self._lock:
            for inv, _fut in held:
                inv.ticket = next(self._tickets)
            self._held = list(held) + self._held
            self.held_peak = max(self.held_peak, len(self._held))

    def replay_adopted(self,
                       held: List[Tuple[Invocation, PortFuture]]) -> int:
        """Dispatch invocations quiesced on another port through THIS
        port, resolving their original futures — zero lost, zero
        duplicated completions across the migration boundary.  Each
        invocation is re-ticketed in this port's space (tickets are
        per-port); if this port is itself not ACTIVE the work joins its
        held FIFO and replays on its next ``resume()``."""
        n = 0
        for inv, fut in held:
            with self._lock:
                if self._closed:
                    raise PortError(
                        f"port {self.name!r} is closed; cannot adopt "
                        "migrated invocations")
                inv.ticket = next(self._tickets)
                self.submitted += 1
                if self._state is not PortState.ACTIVE:
                    # joins this port's held FIFO; its later resume()
                    # replays it (and counts it) exactly once
                    self._held.append((inv, fut))
                    self.held_peak = max(self.held_peak, len(self._held))
                    continue
                self._inflight[inv.ticket] = fut
                self.replayed += 1
            self._safe_dispatch(inv, fut)
            n += 1
        return n

    # ------------------------------------------------------------ hooks ----
    def _dispatch(self, inv: Invocation, fut: PortFuture) -> None:
        raise NotImplementedError

    def _fault_ctx(self) -> Tuple[Optional[int], Optional[str]]:
        """(slot, default tenant) for typed errors and health records."""
        return None, None

    def _fault_plan(self):
        """The attached :class:`~repro.core.faults.FaultPlan`, if any."""
        return None

    def _health(self):
        """The shell's :class:`~repro.core.health.HealthMonitor`, if
        this port is shell-bound."""
        return None

    def capabilities(self) -> PortCapabilities:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def restore(self, snap: Dict[str, Any]) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state.value,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "retried": self.retried,
                "inflight": len(self._inflight),
                "held": len(self._held),
                "replayed": self.replayed,
            }


class VFpgaPort(Port):
    """The port of one application slot (user logic behind the unified
    interface).  SG work executes via ``VFpga.execute_sg`` under the shell
    scheduler (weighted credits + DWRR arbiter); completions land on the
    slot's read/write completion queues exactly as before, so legacy
    ticket-waiters and writeback counters keep working."""

    def __init__(self, vfpga: Any):
        super().__init__(f"vfpga{vfpga.slot}")
        self.vfpga = vfpga

    # ------------------------------------------------------ fault wiring ---
    def _fault_ctx(self) -> Tuple[Optional[int], Optional[str]]:
        return self.vfpga.slot, getattr(self.vfpga, "tenant", None)

    def _fault_plan(self):
        shell = getattr(self.vfpga, "shell", None)
        return getattr(shell, "faults", None)

    def _health(self):
        shell = getattr(self.vfpga, "shell", None)
        return getattr(shell, "health", None)

    # ---------------------------------------------------------- dispatch ---
    def _dispatch(self, inv: Invocation, fut: PortFuture) -> None:
        vf = self.vfpga
        shell = getattr(vf, "shell", None)
        if inv.kind == "io":
            self._dispatch_io(inv, fut, shell)
            return
        sg = inv.to_sg()
        write_side = inv.op in (Oper.LOCAL_OFFLOAD, Oper.REMOTE_WRITE)
        cq = vf.iface.cq_write if write_side else vf.iface.cq_read

        def complete(comp: Completion, inv=inv, fut=fut, cq=cq) -> None:
            cq.writeback(comp)           # counter only; the future is the
            self._finish(inv, fut, comp)  # synchronization object

        if shell is None:
            complete(vf.execute_sg(inv.ticket, sg))
        else:
            shell.scheduler.submit(
                slot=vf.slot, stream=sg.src_stream, ticket=inv.ticket,
                sg=sg, execute=vf.execute_sg, complete=complete,
                tenant=inv.tenant, priority=inv.priority,
                deadline_s=inv.deadline_s)

    def _dispatch_io(self, inv: Invocation, fut: PortFuture, shell) -> None:
        t0 = time.perf_counter()

        def done(err: Optional[BaseException] = None,
                 inv=inv, fut=fut, t0=t0) -> None:
            if err is not None:
                self._fail(inv, fut, err)
                return
            self._finish(inv, fut, Completion(
                ticket=inv.ticket, tid=inv.tid, opcode=Oper.LOCAL_TRANSFER,
                nbytes=inv.nbytes, t_submit=t0,
                t_done=time.perf_counter()))

        # the scheduler probes this before passing an IO error into the
        # callback (legacy on_done callbacks are zero-arg)
        done.accepts_error = True

        if shell is None:
            done()
            return
        shell.scheduler.submit_io(
            inv.nbytes, slot=self.vfpga.slot, stream=inv.stream,
            tenant=inv.tenant, tag=inv.meta.get("tag", "io"),
            wait=False, on_done=done, priority=inv.priority,
            deadline_s=inv.deadline_s)

    # ------------------------------------------------------ capabilities ---
    def capabilities(self) -> PortCapabilities:
        vf = self.vfpga
        art = vf.app
        if art is not None and getattr(art, "capabilities", None) is not None:
            caps = art.capabilities
            # slot-qualify the artifact's descriptor
            return PortCapabilities(
                name=self.name, kind="app", streams=caps.streams,
                csr_map=dict(caps.csr_map), mem_model=caps.mem_model,
                ops=caps.ops)
        return PortCapabilities(
            name=self.name, kind="app", streams=vf.iface.n_streams,
            csr_map={}, mem_model="host",
            ops=tuple(o.value for o in (Oper.LOCAL_TRANSFER, Oper.KERNEL,
                                        Oper.LOCAL_OFFLOAD,
                                        Oper.LOCAL_SYNC)))

    # ------------------------------------------------- snapshot / restore --
    def snapshot(self) -> Dict[str, Any]:
        """Freeze swap-surviving slot state: the CSR file and the cThread
        host address map (getMem buffers outlive the logic they feed)."""
        vf = self.vfpga
        return {
            "csr": vf.iface.csr.snapshot(),
            "addr_map": dict(vf._addr_map),
            "next_vaddr": vf._next_vaddr,
            "app": vf.app.name if vf.app else None,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        vf = self.vfpga
        for reg, val in snap.get("csr", {}).items():
            vf.iface.csr.set_csr(val, reg)
        vf._addr_map.update(snap.get("addr_map", {}))
        vf._next_vaddr = max(vf._next_vaddr,
                             snap.get("next_vaddr", vf._next_vaddr))


# Synthetic "slot" ids for service ports: services are not application
# slots, but billing through the scheduler wants a stable requester key.
# Defined BY the scheduler's shared-lane threshold so service-call
# execution always rides the shared service lane instead of minting one
# lane thread per service.
SERVICE_SLOT_BASE = SHARED_LANE_SLOT_BASE


class ServicePort(Port):
    """Port over a dynamic-layer service: ``submit(Invocation.call(...))``
    runs one of the service's declared ``PORT_METHODS`` through the shell
    scheduler (so service control traffic is credit-billed like any other
    tenant traffic) and resolves with a Completion carrying the result."""

    def __init__(self, service: Any, *, shell: Any = None,
                 slot: int = SERVICE_SLOT_BASE,
                 tenant: Optional[str] = None):
        super().__init__(service.NAME)
        self.service = service
        self.shell = shell
        self.slot = slot
        self.tenant = tenant or f"svc.{service.NAME}"

    # ------------------------------------------------------ fault wiring ---
    def _fault_ctx(self) -> Tuple[Optional[int], Optional[str]]:
        return self.slot, self.tenant

    def _fault_plan(self):
        return getattr(self.shell, "faults", None)

    def _health(self):
        return getattr(self.shell, "health", None)

    def _dispatch(self, inv: Invocation, fut: PortFuture) -> None:
        svc = self.service
        allowed = getattr(svc, "PORT_METHODS", ())
        if inv.kind != "method" or inv.method not in allowed:
            # reject BEFORE billing: a disallowed call must not acquire
            # credits or burn an arbiter visit
            self._finish(inv, fut, Completion(
                ticket=inv.ticket, tid=inv.tid, opcode=Oper.KERNEL,
                nbytes=0, t_submit=time.perf_counter(),
                t_done=time.perf_counter(), ok=False,
                result=PortError(
                    f"service {svc.NAME!r} port does not expose "
                    f"{inv.method!r} (allowed: {sorted(allowed)})")))
            return

        def execute(ticket: int, sg: Optional[SgEntry],
                    inv=inv) -> Completion:
            t0 = time.perf_counter()
            ok, result = True, None
            try:
                plan = self._fault_plan()
                if plan is not None:
                    plan.fire("service.call", slot=self.slot,
                              tenant=inv.tenant or self.tenant,
                              method=inv.method)
                result = getattr(svc, inv.method)(*inv.args, **inv.kwargs)
            except Exception as e:    # noqa: BLE001 — fault -> completion
                ok, result = False, e
            return Completion(ticket=ticket, tid=inv.tid, opcode=Oper.KERNEL,
                              nbytes=inv.nbytes, t_submit=t0,
                              t_done=time.perf_counter(), ok=ok,
                              result=result)

        if self.shell is None:
            self._finish(inv, fut, execute(inv.ticket, None))
            return
        sg = SgEntry(length=max(inv.nbytes, 1), src_stream=0,
                     opcode=Oper.KERNEL,
                     meta={"method": inv.method, "service": svc.NAME})
        self.shell.scheduler.submit(
            slot=self.slot, stream=0, ticket=inv.ticket, sg=sg,
            execute=execute,
            complete=lambda comp, inv=inv, fut=fut:
                self._finish(inv, fut, comp),
            tenant=inv.tenant or self.tenant, priority=inv.priority,
            deadline_s=inv.deadline_s)

    def capabilities(self) -> PortCapabilities:
        svc = self.service
        caps = getattr(svc, "port_capabilities", None)
        if callable(caps):
            return caps()
        return PortCapabilities(
            name=svc.NAME, kind="service", streams=0, csr_map={},
            mem_model="none",
            ops=tuple(getattr(svc, "PORT_METHODS", ())))

    def snapshot(self) -> Dict[str, Any]:
        return {"generation": self.service.generation,
                "config": self.service.config}

    def restore(self, snap: Dict[str, Any]) -> None:
        """Reapply the snapshotted config if the service's config moved
        during the swap window (no-op — and no spurious generation bump —
        when nothing changed)."""
        cfg = snap.get("config")
        if cfg is not None and cfg != self.service.config:
            self.service.configure(cfg)
