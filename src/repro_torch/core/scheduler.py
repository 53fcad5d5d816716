"""Multi-tenant shell scheduler: async submission + weighted-credit QoS.

Replaces the synchronous per-slot ``Shell.kick()`` drain loop with an
event-driven subsystem in front of the link arbiter:

  * **Async intake** — cThreads on any vFPGA slot enqueue scatter-gather
    work concurrently; a single scheduler thread (the "shell datapath
    clock") ingests, batches, and issues it.  Callers synchronize on the
    completion queues exactly as before.
  * **Coalescing** — consecutive small SG entries on the same
    (slot, stream) are merged into one packet-sized batch before hitting
    the arbiter, so tiny descriptors stop costing a full arbiter visit
    each.  Batches never span streams and never reorder entries: each
    (slot, stream) is a FIFO end to end.
  * **Weighted credits** — every tenant owns a credit account sized by its
    weight; batches acquire one credit per packet before entering the
    arbiter and release on completion, so an over-subscribed tenant stalls
    itself, never the link (back-pressure containment, paper §7.2).
  * **Weighted bandwidth** — the :class:`~repro.core.credits.WeightedRRArbiter`
    serves each (slot, stream) queue with its tenant's weight, split evenly
    across the tenant's active queues so a tenant's share is set by its
    weight, not its stream count.
  * **Per-tenant QoS stats** — byte shares, weighted/unweighted Jain's
    fairness, mean submit→complete latency, and throughput, surfaced
    through ``Shell.status()["scheduler"]``.
  * **Per-slot executor lanes** — the DWRR arbiter keeps deciding *what*
    is granted (billing and fairness are unchanged), but granted work is
    *executed* on per-slot worker lanes: one lane per vFPGA slot that has
    traffic, plus one shared lane for service-port calls.  A long-running
    app invocation on slot 0 (an lm_serving serve loop, a streaming NN
    predict) therefore no longer delays slot 1's completions — execution
    is parallel across slots while each (slot, stream) stays FIFO.
  * **Cooperative preemption** — submissions carry ``priority`` and an
    absolute ``deadline``; a lane runs the highest-priority stream-head
    first (earliest deadline breaks ties), and a long-running invocation
    that calls :meth:`ShellScheduler.checkpoint` at its natural
    boundaries (decode step, stream batch) *holds* while queued
    strictly-higher-priority work on its lane runs, then *resumes* — the
    in-flight batch is preempted without ever being lost or duplicated
    (the same hold-and-resume contract as the Port drain machinery).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.core import credits as C
from repro_torch.core.faults import FaultKind
from repro_torch.core.interfaces import Completion, SgEntry

DEFAULT_TENANT_PREFIX = "tenant"

# Slots at or above this id are synthetic (service ports, see
# ``repro.core.port.SERVICE_SLOT_BASE``): they share ONE executor lane —
# service calls are short control operations, not long-running datapath
# work, so a shared lane keeps thread count bounded.
SHARED_LANE_SLOT_BASE = 1000
SHARED_LANE_KEY = "service"


@dataclass
class Tenant:
    """One bandwidth principal: a weight, a credit account, QoS counters."""
    name: str
    weight: float = 1.0
    credits: C.CreditAccount = None          # set by the scheduler
    submissions: int = 0
    completions: int = 0
    pending: int = 0                         # accepted, not yet completed
    intake_stalls: int = 0                   # submitter back-pressure events
    batches: int = 0
    bytes_done: int = 0
    lat_sum_s: float = 0.0
    deadline_misses: int = 0                 # completed past their deadline
    t_first_submit: float = 0.0
    t_last_done: float = 0.0

    def stats(self) -> Dict[str, float]:
        span = max(self.t_last_done - self.t_first_submit, 1e-12)
        return {
            "weight": self.weight,
            "submissions": self.submissions,
            "completions": self.completions,
            "batches": self.batches,
            "bytes": self.bytes_done,
            "deadline_misses": self.deadline_misses,
            "mean_latency_s": self.lat_sum_s / max(self.completions, 1),
            "throughput_bps": self.bytes_done / span if self.bytes_done
            else 0.0,
            "credit_capacity": self.credits.capacity if self.credits else 0,
            "credit_stalls": self.credits.stalls if self.credits else 0,
            "intake_stalls": self.intake_stalls,
        }


@dataclass
class _Submission:
    slot: int
    stream: int
    ticket: int
    sg: SgEntry
    tenant: Tenant
    nbytes: int
    t_submit: float
    execute: Optional[Callable[[int, SgEntry], Completion]] = None
    complete: Optional[Callable[[Completion], None]] = None
    done_event: Optional[threading.Event] = None
    on_done: Optional[Callable[[], None]] = None
    priority: int = 0
    deadline: float = float("inf")           # absolute perf_counter time


@dataclass
class _Batch:
    tenant: Tenant
    requester: str
    subs: List[_Submission]
    nbytes: int
    npkts: int
    priority: int = 0
    deadline: float = float("inf")


@dataclass
class _ExecTask:
    """One granted batch awaiting execution on a lane."""
    batch: _Batch
    credit_cost: int
    seq: int

    @property
    def priority(self) -> int:
        return self.batch.priority

    @property
    def stream_key(self) -> Tuple[int, int]:
        head = self.batch.subs[0]
        return (head.slot, head.stream)

    def order_key(self) -> Tuple[float, float, int]:
        return (-self.batch.priority, self.batch.deadline, self.seq)


class _ExecutorLane:
    """One execution lane: a worker thread draining granted batches for
    one vFPGA slot (or the shared service lane).

    Scheduling inside a lane is priority-first (earliest deadline, then
    grant order, break ties) over *stream heads*: a task is only eligible
    while no earlier-granted task of the same (slot, stream) is still
    queued, so the scheduler's per-stream FIFO guarantee survives
    reordering across priorities."""

    def __init__(self, key: Any, scheduler: "ShellScheduler"):
        self.key = key
        self.sched = scheduler
        self._cv = threading.Condition()
        self._queue: List[_ExecTask] = []
        self._stop = False
        self.current: Optional[_ExecTask] = None
        # tasks held at checkpoints on this thread, outermost first; a
        # preemptor must never share a stream with any of them (its
        # same-stream predecessor is in flight, just not in _queue)
        self._hold_chain: List[_ExecTask] = []
        self.executed = 0
        self.preempt_runs = 0            # tasks run inside a checkpoint hold
        self.queue_peak = 0
        self.busy_s = 0.0
        self.thread = threading.Thread(
            target=self._run, name=f"shell-lane-{key}", daemon=True)
        self.thread.start()

    # ------------------------------------------------------------ intake ---
    def push(self, task: _ExecTask) -> None:
        with self._cv:
            self._queue.append(task)
            self.queue_peak = max(self.queue_peak, len(self._queue))
            self._cv.notify_all()

    def _pop_locked(self, above_priority: Optional[int] = None,
                    exclude_streams: Optional[Set[Tuple[int, int]]] = None
                    ) -> Optional[_ExecTask]:
        """Best eligible task: for each (slot, stream) only the earliest
        queued task is a candidate (FIFO within a stream); among the
        candidates the highest priority wins, then the earliest deadline,
        then grant order.  ``above_priority`` restricts candidates to
        strictly higher priorities and ``exclude_streams`` blocks streams
        whose earlier batch is in flight on this thread (both together
        form the preemption filter: priority reorders only ACROSS
        streams, never within one)."""
        best = None
        seen: Set[Tuple[int, int]] = set(exclude_streams or ())
        for i, t in enumerate(self._queue):
            sk = t.stream_key
            if sk in seen:
                continue
            seen.add(sk)
            if above_priority is not None and t.priority <= above_priority:
                continue
            if best is None or t.order_key() < self._queue[best].order_key():
                best = i
        if best is None:
            return None
        return self._queue.pop(best)

    # ------------------------------------------------------------ worker ---
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.25)
                if self._stop and not self._queue:
                    return
                task = self._pop_locked()
            if task is not None:
                self._execute(task)

    def _execute(self, task: _ExecTask) -> None:
        prev = self.current
        with self._cv:                  # _hold_chain/current are read by
            self.current = task         # cross-thread probes under _cv
            self._hold_chain.append(task)
        t0 = time.perf_counter()
        try:
            self.sched._execute_batch(task.batch, task.credit_cost)
        finally:
            self.busy_s += time.perf_counter() - t0
            self.executed += 1
            with self._cv:
                self._hold_chain.pop()
                self.current = prev

    # -------------------------------------------------------- preemption ---
    def run_preemptors(self) -> int:
        """Checkpoint body: while queued work outranks the in-flight task,
        run it inline (the in-flight batch HOLDS here and RESUMES after).
        Work sharing a (slot, stream) with any held batch is never
        eligible — its same-stream predecessor is mid-flight, and
        per-stream FIFO is inviolable.  Only meaningful on the lane's
        own thread."""
        cur = self.current
        if cur is None:
            return 0
        ran = 0
        while True:
            with self._cv:
                held = {t.stream_key for t in self._hold_chain}
                task = self._pop_locked(above_priority=cur.priority,
                                        exclude_streams=held)
            if task is None:
                return ran
            self.preempt_runs += 1
            ran += 1
            self._execute(task)

    def pending_above(self, priority: int) -> bool:
        with self._cv:
            held = {t.stream_key for t in self._hold_chain}
            return any(t.priority > priority
                       and t.stream_key not in held for t in self._queue)

    def preempt_pending(self) -> bool:
        """Coherent probe: is queued work outranking the in-flight task
        (one lock, so current and queue are read consistently)?"""
        with self._cv:
            cur = self.current
            if cur is None:
                return False
            held = {t.stream_key for t in self._hold_chain}
            return any(t.priority > cur.priority
                       and t.stream_key not in held for t in self._queue)

    # ----------------------------------------------------------- teardown --
    def close(self, timeout: float = 2.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self.thread.join(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            qlen = len(self._queue)
            cur = self.current
        return {"executed": self.executed, "queued": qlen,
                "queue_peak": self.queue_peak,
                "preempt_runs": self.preempt_runs,
                "busy_s": self.busy_s,
                "current_priority": (cur.priority if cur is not None
                                     else None)}


class ShellScheduler:
    """Event-driven multi-tenant scheduler in front of a weighted arbiter."""

    def __init__(self, arbiter: C.WeightedRRArbiter, *,
                 packet_bytes: int = C.DEFAULT_PACKET_BYTES,
                 stream_depth: int = 64,
                 coalesce: bool = True,
                 max_batch_entries: int = 16,
                 max_pending_per_tenant: Optional[int] = None,
                 lanes: bool = True):
        self.arbiter = arbiter
        # lanes=False serializes every execution on the scheduler worker
        # (the pre-lane behavior) — kept as the A/B baseline for
        # ``benchmarks/bench_multislot.py`` and the billing-parity tests.
        self.lanes_enabled = lanes
        self._lanes: Dict[Any, _ExecutorLane] = {}
        self._lane_threads: Set[threading.Thread] = set()
        self._exec_seq = itertools.count()
        self.packet_bytes = packet_bytes
        self.stream_depth = stream_depth
        self.coalesce = coalesce
        self.max_batch_entries = max_batch_entries
        # submitter-side back-pressure bound (paper §7.2: an over-subscribed
        # tenant stalls ITSELF): submissions beyond this block the caller
        # until completions free room.  pause() exempts itself — it exists
        # precisely to build up saturation backlogs deterministically.
        self.max_pending_per_tenant = (max_pending_per_tenant
                                       if max_pending_per_tenant is not None
                                       else 64 * stream_depth)

        self._tenants: Dict[str, Tenant] = {}
        self._slot_tenant: Dict[int, str] = {}
        # requester name -> tenant, for weight rebalancing across a
        # tenant's active (slot, stream) queues
        self._tenant_requesters: Dict[str, Set[str]] = {}

        self._intake: Deque[_Submission] = deque()
        self._pend: Dict[Tuple[int, int], Deque[_Submission]] = {}
        self._pend_order: List[Tuple[int, int]] = []

        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._inflight = 0
        self._paused = False
        self._stop = False
        self._worker: Optional[threading.Thread] = None

        self.batches_issued = 0
        self.entries_coalesced = 0          # entries that rode in a batch >1
        # robustness wiring (set by Shell.set_fault_plan / Shell.__init__):
        # an armed FaultPlan probed at "lane.execute"/"io.complete", and the
        # HealthMonitor that lane heartbeats + fault records feed.
        self.faults: Optional[Any] = None
        self.health: Optional[Any] = None
        self.lane_faults = 0                # execute/io bodies that raised

    # ------------------------------------------------------------ tenants --
    def register_tenant(self, name: str, weight: float = 1.0) -> Tenant:
        """Create/update a tenant.  Credit capacity scales with weight so a
        heavier tenant may keep proportionally more packets in flight."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = Tenant(name=name, weight=weight)
                t.credits = C.CreditAccount(
                    max(1, int(round(self.stream_depth * weight))),
                    on_release=self._credits_released)
                self._tenants[name] = t
                self._tenant_requesters.setdefault(name, set())
            elif t.weight != weight:
                t.weight = weight
                t.credits = C.CreditAccount(
                    max(1, int(round(self.stream_depth * weight))),
                    on_release=self._credits_released)
                self._rebalance_weights(name)
        return t

    def _credits_released(self) -> None:
        """Lane threads release credits asynchronously now; wake the
        issue loop so credit-blocked streams are revisited promptly."""
        with self._lock:
            self._work_cv.notify_all()

    def bind_slot(self, slot: int, tenant: str) -> None:
        """Route all submissions from a vFPGA slot to the named tenant."""
        if tenant not in self._tenants:
            self.register_tenant(tenant)
        with self._lock:
            self._slot_tenant[slot] = tenant

    def tenant_of(self, slot: int) -> Tenant:
        with self._lock:
            name = self._slot_tenant.get(slot)
        if name is None:
            name = f"{DEFAULT_TENANT_PREFIX}{slot}"
            self._tenant_by_name(name)
            self.bind_slot(slot, name)
        return self._tenants[name]

    def _tenant_by_name(self, name: str) -> Tenant:
        """Get-or-create WITHOUT touching an existing tenant's weight
        (register_tenant with the default weight would reset it)."""
        with self._lock:
            t = self._tenants.get(name)
        if t is not None:
            return t
        return self.register_tenant(name)

    def tenants(self) -> Dict[str, Tenant]:
        with self._lock:
            return dict(self._tenants)

    def tenant_pending(self, name: str) -> int:
        """Accepted-but-uncompleted submissions for a tenant — surfaced
        by ``ServingEngine.run()`` stats (``io_pending``) so async
        decode-IO billing that failed to drain is visible, never silent."""
        with self._lock:
            t = self._tenants.get(name)
            return t.pending if t is not None else 0

    def _rebalance_weights(self, tenant_name: str,
                           extra: Optional[str] = None) -> None:
        """Split a tenant's weight evenly over its BACKLOGGED requesters so
        its link share tracks its weight regardless of how many
        (slot, stream) queues it currently fans out on.  Requesters whose
        arbiter queue has drained stop diluting the share (they are
        re-included by the rebalance accompanying their next batch).
        Caller must hold self._lock."""
        t = self._tenants[tenant_name]
        reqs = self._tenant_requesters.get(tenant_name, set())
        active = {r for r in reqs if self.arbiter.backlogged(r)}
        if extra is not None:
            active.add(extra)
        if not active:
            return
        per = t.weight / len(active)
        for r in active:
            self.arbiter.set_weight(r, per)

    # ------------------------------------------------------------- intake --
    def submit(self, *, slot: int, stream: int, ticket: int, sg: SgEntry,
               execute: Callable[[int, SgEntry], Completion],
               complete: Callable[[Completion], None],
               tenant: Optional[str] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> None:
        """Enqueue one SG descriptor (any thread; blocks only when the
        tenant exceeds its pending bound — submitter-side back-pressure).
        ``priority`` orders execution on the slot's lane (higher first;
        the DWRR grant order and billing are unaffected); ``deadline_s``
        is a relative SLO in seconds breaking ties among equal
        priorities (earliest absolute deadline first)."""
        ten = (self._tenant_by_name(tenant) if tenant is not None
               else self.tenant_of(slot))
        t_sub = time.perf_counter()
        sub = _Submission(slot=slot, stream=stream, ticket=ticket, sg=sg,
                          tenant=ten, nbytes=max(sg.length, 1),
                          t_submit=t_sub,
                          execute=execute, complete=complete,
                          priority=priority,
                          deadline=(t_sub + deadline_s
                                    if deadline_s is not None
                                    else float("inf")))
        self._enqueue(sub)

    def submit_io(self, nbytes: int, *, slot: int = 0, stream: int = 0,
                  tenant: Optional[str] = None, tag: str = "io",
                  wait: bool = False,
                  timeout: Optional[float] = None,
                  on_done: Optional[Callable[[], None]] = None,
                  priority: int = 0,
                  deadline_s: Optional[float] = None
                  ) -> threading.Event:
        """Enqueue a raw transfer with no SG execution behind it — the path
        the serving engine uses to push its decode-step I/O through the
        shared link under this tenant's QoS weight.  ``on_done`` (used by
        the Port layer to resolve futures) fires once the bytes clear the
        link, on whichever thread completed them."""
        ten = (self._tenant_by_name(tenant) if tenant is not None
               else self.tenant_of(slot))
        if self._on_executor_thread():
            # Re-entrant submission from inside an executing batch (e.g. a
            # serving app's decode loop running under execute_sg, on the
            # scheduler worker or on a lane): waiting on our own thread
            # would deadlock, so bill the link and the tenant inline.
            # Bytes still land in the arbiter's delivered table so tenant
            # totals and arbiter totals stay reconciled.  Lanes-on and
            # lanes-off take the same path here, so billed totals are
            # identical in both modes.
            if self.faults is not None:
                # same injection site as the queued path; raises BEFORE
                # any accounting mutates, so the caller's typed-failure
                # path (Port._safe_dispatch) sees a clean state
                self.faults.fire("io.complete", slot=slot,
                                 tenant=ten.name, tag=tag)
            t_sub = time.perf_counter()
            requester = f"{ten.name}/vfpga{slot}.s{stream}:inline"
            with self._lock:
                if ten.t_first_submit == 0.0:
                    ten.t_first_submit = t_sub
                ten.submissions += 1
            self.arbiter.link.transfer(max(nbytes, 1), src=requester,
                                       tag=tag)
            now = time.perf_counter()
            with self._lock:
                self.arbiter.delivered[requester] = (
                    self.arbiter.delivered.get(requester, 0)
                    + max(nbytes, 1))
                ten.completions += 1
                ten.bytes_done += max(nbytes, 1)
                ten.lat_sum_s += now - t_sub
                ten.t_last_done = now
            ev = threading.Event()
            ev.set()
            if on_done is not None:
                on_done()
            return ev
        t_sub = time.perf_counter()
        sg = SgEntry(length=max(nbytes, 1), src_stream=stream,
                     meta={"tag": tag})
        sub = _Submission(slot=slot, stream=stream, ticket=-1, sg=sg,
                          tenant=ten, nbytes=max(nbytes, 1),
                          t_submit=t_sub,
                          done_event=threading.Event(), on_done=on_done,
                          priority=priority,
                          deadline=(t_sub + deadline_s
                                    if deadline_s is not None
                                    else float("inf")))
        self._enqueue(sub)
        if wait:
            sub.done_event.wait(timeout=timeout)
        return sub.done_event

    def _on_executor_thread(self) -> bool:
        """True on the scheduler worker or any executor lane thread —
        the threads that drain work and must never block on themselves."""
        cur = threading.current_thread()
        if self._worker is not None and cur is self._worker:
            return True
        return cur in self._lane_threads

    def _enqueue(self, sub: _Submission) -> None:
        on_worker = self._on_executor_thread()
        with self._lock:
            # submitter-side back-pressure: an over-subscribed tenant
            # stalls itself, never the link or other tenants.  Skipped
            # while paused (pause() exists to build saturation backlogs)
            # and on the worker thread (it is the one draining).
            while (not self._paused and not on_worker
                   and sub.tenant.pending >= self.max_pending_per_tenant):
                sub.tenant.intake_stalls += 1
                self._idle_cv.wait(timeout=0.25)
            if sub.tenant.t_first_submit == 0.0:
                sub.tenant.t_first_submit = sub.t_submit
            sub.tenant.submissions += 1
            sub.tenant.pending += 1
            self._inflight += 1
            self._intake.append(sub)
            self._ensure_worker_locked()
            self._work_cv.notify_all()

    # ------------------------------------------------------- flow control --
    def pause(self) -> None:
        """Hold scheduling (submissions still accepted).  Lets callers build
        up saturation demand before any byte moves — deterministic QoS
        benchmarks depend on this."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._work_cv.notify_all()

    def drain_tenant(self, name: str, timeout: Optional[float] = None
                     ) -> bool:
        """Tenant-aware drain: block until the NAMED tenant's accepted
        submissions have all completed, while every other tenant keeps
        flowing (nothing is paused and no other queue is touched).

        This is the drain-ordering primitive quiesce-and-migrate builds
        on: the migrating tenant's in-flight tail is waited out first,
        bystander tenants on the same shell never see a stall.  Returns
        True once the tenant is idle (an unknown tenant is trivially
        idle), False on timeout.
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                return True
            self._ensure_worker_locked()
            self._work_cv.notify_all()
            while t.pending > 0:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._idle_cv.wait(timeout=remaining if remaining else 0.25)
            return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted submission has completed."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            if self._paused:
                self._paused = False
            self._ensure_worker_locked()
            self._work_cv.notify_all()
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._idle_cv.wait(timeout=remaining if remaining else 0.25)
            return True

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._work_cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        for lane in list(self._lanes.values()):
            lane.close()

    # ------------------------------------------------------------- worker --
    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, name="shell-scheduler", daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                while (not self._stop
                       and (self._paused
                            or (not self._intake and not self._has_ready()))):
                    self._work_cv.wait(timeout=0.25)
                if self._stop:
                    return
                intake = list(self._intake)
                self._intake.clear()
            self._ingest(intake)
            # issue credit-gated batches, drive the arbiter, repeat: every
            # completed batch returns credits that may unblock more work.
            while True:
                issued = self._issue_ready()
                self.arbiter.drain()
                if not issued and not self.arbiter.pending():
                    with self._lock:
                        if self._intake or self._paused or self._stop:
                            break
                        if not self._has_ready():
                            self._idle_cv.notify_all()
                            break
                        # ready work exists but is credit-blocked with an
                        # idle arbiter: credits are held by batches still
                        # executing on lanes.  Wait for a release
                        # (CreditAccount.on_release notifies _work_cv).
                        self._work_cv.wait(timeout=0.05)

    def _has_ready(self) -> bool:
        return any(self._pend.get(k) for k in self._pend_order)

    def _ingest(self, subs: List[_Submission]) -> None:
        for sub in subs:
            key = (sub.slot, sub.stream)
            if key not in self._pend:
                self._pend[key] = deque()
                self._pend_order.append(key)
            self._pend[key].append(sub)

    # ---------------------------------------------------------- batching ---
    def _form_batch(self, q: Deque[_Submission]) -> _Batch:
        """Pop a FIFO prefix of the stream queue: either one large entry or
        several small ones coalesced up to one packet / max_batch_entries.
        FIFO pop + single-requester submit = no same-stream reordering.
        Coalescing never crosses a priority boundary — a batch has ONE
        priority, so lane-level preemption can never invert priorities
        inside a merged batch."""
        head = q.popleft()
        subs = [head]
        nbytes = head.nbytes
        deadline = head.deadline
        if self.coalesce:
            while (q and len(subs) < self.max_batch_entries
                   and q[0].priority == head.priority
                   and nbytes + q[0].nbytes <= self.packet_bytes):
                nxt = q.popleft()
                subs.append(nxt)
                nbytes += nxt.nbytes
                deadline = min(deadline, nxt.deadline)
        tenant = head.tenant
        requester = f"{tenant.name}/vfpga{head.slot}.s{head.stream}"
        npkts = max(len(C.packetize(nbytes, self.packet_bytes)), 1)
        return _Batch(tenant=tenant, requester=requester, subs=subs,
                      nbytes=nbytes, npkts=npkts, priority=head.priority,
                      deadline=deadline)

    def _issue_ready(self) -> int:
        """Form batches from every stream queue head whose tenant has
        credits; submit them to the weighted arbiter.  Credit-blocked
        streams stay queued (head-of-line within the stream only)."""
        issued = 0
        for key in list(self._pend_order):
            q = self._pend.get(key)
            while q:
                head = q[0]
                ten = head.tenant
                # probe the credit cost of the batch the head would form
                # without popping: cost is bounded by capacity (a single
                # over-sized transfer may otherwise deadlock).
                probe_pkts = max(
                    len(C.packetize(head.nbytes, self.packet_bytes)), 1)
                cost = min(probe_pkts, ten.credits.capacity)
                if not ten.credits.try_acquire(cost):
                    break                      # tenant back-pressured
                batch = self._form_batch(q)
                # coalescing never changes the packet count (it only fills
                # up to ONE packet, and over-packet heads ride alone), so
                # the probed cost is the batch cost.
                assert min(batch.npkts, ten.credits.capacity) == cost
                self._submit_batch(batch, credit_cost=cost)
                issued += 1
        return issued

    def _submit_batch(self, batch: _Batch, *, credit_cost: int) -> None:
        tenant = batch.tenant
        with self._lock:
            reqs = self._tenant_requesters.setdefault(tenant.name, set())
            reqs.add(batch.requester)
            # rebalance over the currently-backlogged requesters (plus this
            # one, about to be backlogged) so drained streams stop diluting
            # the tenant's share.
            self._rebalance_weights(tenant.name, extra=batch.requester)
        self.batches_issued += 1
        if len(batch.subs) > 1:
            self.entries_coalesced += len(batch.subs)
        tag = batch.subs[0].sg.opcode.value if batch.subs[0].ticket >= 0 \
            else batch.subs[0].sg.meta.get("tag", "io")

        def done(_t, batch=batch, credit_cost=credit_cost):
            self._complete_batch(batch, credit_cost)

        self.arbiter.submit(batch.requester, batch.nbytes, tag=tag,
                            on_done=done)

    def _complete_batch(self, batch: _Batch, credit_cost: int) -> None:
        """Runs on the scheduler thread when the batch's last packet
        clears the link.  The grant is done — now route *execution*:
        batches carrying SG work go to their slot's executor lane (so a
        long invocation on one slot never delays another slot's
        completions); pure-I/O batches (no execute callable — the
        serving engine's decode billing) finish inline, so their futures
        resolve even while every lane is busy with long work.

        Consequence, by design: a pure-I/O completion is a link
        accounting record and is NOT ordered relative to SG *execution*
        on the same (slot, stream) — the per-stream FIFO contract covers
        SG execution order; an I/O future must never be used as a
        barrier for earlier SG work (a batch that mixes both kinds rides
        the lane as one unit and stays internally ordered)."""
        if self.lanes_enabled and any(s.execute is not None
                                      for s in batch.subs):
            self._lane_for(batch.subs[0].slot).push(_ExecTask(
                batch=batch, credit_cost=credit_cost,
                seq=next(self._exec_seq)))
            return
        self._execute_batch(batch, credit_cost)

    def _execute_batch(self, batch: _Batch, credit_cost: int) -> None:
        """Execute each SG in submission order, complete CQs, release
        credits, update tenant QoS counters.  Runs on a lane thread
        (lanes on) or the scheduler worker (lanes off / pure I/O).

        Failure-hardened: an exception out of an execute body (app bug or
        injected ``lane.execute``/``io.complete`` fault) is converted into
        a failed ``Completion`` (SG work) or an error callback (IO work)
        for THAT submission only — the rest of the batch still completes,
        and the ``finally`` block guarantees credits are released and
        tenant accounting settles even on the worst path, so a crash can
        never leak credits or wedge ``drain()`` waiters forever."""
        ten = batch.tenant
        plan = self.faults
        try:
            for sub in batch.subs:
                err: Optional[BaseException] = None
                comp: Optional[Completion] = None
                try:
                    if plan is not None:
                        plan.fire("lane.execute" if sub.execute is not None
                                  else "io.complete",
                                  slot=sub.slot, tenant=ten.name,
                                  ticket=sub.ticket)
                    if sub.execute is not None:
                        comp = sub.execute(sub.ticket, sub.sg)
                except BaseException as e:  # noqa: BLE001 — the lane
                    # must outlive anything the body throws
                    err = e
                    self.lane_faults += 1
                if err is not None and sub.execute is not None:
                    # the SG path already speaks failed Completions
                    # (service rejections, app exceptions): deliver the
                    # typed fault the same way so the Port layer's retry
                    # policy can intercept it in _finish
                    if self.health is not None:
                        self.health.record_fault(
                            getattr(err, "kind", FaultKind.LANE_CRASH),
                            slot=sub.slot, tenant=ten.name,
                            site=getattr(err, "site", "lane.execute"),
                            msg=str(err))
                    comp = Completion(
                        ticket=sub.ticket, tid=sub.sg.tid,
                        opcode=sub.sg.opcode, nbytes=sub.nbytes,
                        t_submit=sub.t_submit,
                        t_done=time.perf_counter(), ok=False, result=err)
                if sub.complete is not None and comp is not None:
                    try:
                        sub.complete(comp)
                    except Exception:  # noqa: BLE001 — a bad completion
                        pass           # callback must not kill the lane
                if sub.done_event is not None:
                    sub.done_event.set()
                if sub.on_done is not None:
                    try:
                        if (err is not None and getattr(
                                sub.on_done, "accepts_error", False)):
                            # Port-layer IO callback: the error fails the
                            # future typed (and is health-recorded there)
                            sub.on_done(err)
                        else:
                            sub.on_done()
                    except Exception:   # noqa: BLE001 — a bad callback
                        pass            # must never kill the thread
        finally:
            now = time.perf_counter()
            ten.credits.release(credit_cost)
            with self._lock:
                for sub in batch.subs:
                    ten.completions += 1
                    ten.lat_sum_s += now - sub.t_submit
                    if now > sub.deadline:
                        # SLO accounting: the invocation finished past
                        # its absolute deadline (inf = no deadline)
                        ten.deadline_misses += 1
                ten.batches += 1
                ten.bytes_done += batch.nbytes
                ten.t_last_done = now
                ten.pending -= len(batch.subs)
                self._inflight -= len(batch.subs)
                # wakes both drain() waiters and back-pressured submitters
                self._idle_cv.notify_all()
            if self.health is not None:
                # lane heartbeat: one beat per executed batch
                self.health.beat(batch.subs[0].slot)

    # -------------------------------------------------- executor lanes -----
    @staticmethod
    def _lane_key(slot: int) -> Any:
        return SHARED_LANE_KEY if slot >= SHARED_LANE_SLOT_BASE else slot

    def _lane_for(self, slot: int) -> _ExecutorLane:
        key = self._lane_key(slot)
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                lane = _ExecutorLane(key, self)
                self._lanes[key] = lane
                self._lane_threads.add(lane.thread)
        return lane

    def checkpoint(self, slot: int) -> int:
        """Cooperative preemption point for long-running invocations.

        Called from inside an executing invocation (decode-step /
        stream-batch granularity): if strictly-higher-priority granted
        work is queued on this slot's lane, it runs NOW on the calling
        thread — the caller's batch holds here and resumes when the
        call returns (zero lost, zero duplicated completions either
        side).  A no-op (returns 0) off the lane's own thread, with
        lanes disabled, or when nothing outranks the caller."""
        if not self.lanes_enabled:
            return 0
        # lock-free read: _lanes is append-only and this runs once per
        # decode step — taking the global scheduler lock here would
        # serialize every serving loop against the intake/issue path
        lane = self._lanes.get(self._lane_key(slot))
        if lane is None or threading.current_thread() is not lane.thread:
            return 0
        return lane.run_preemptors()

    def preempt_requested(self, slot: int) -> bool:
        """True when work outranking the slot's in-flight batch waits on
        its lane — the cheap probe form of :meth:`checkpoint`."""
        if not self.lanes_enabled:
            return False
        lane = self._lanes.get(self._lane_key(slot))   # append-only dict
        if lane is None:
            return False
        return lane.preempt_pending()

    # --------------------------------------------------------------- QoS ---
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tenants = dict(self._tenants)
        total = sum(t.bytes_done for t in tenants.values()) or 1
        shares = {n: t.bytes_done / total for n, t in tenants.items()}
        weights = {n: t.weight for n, t in tenants.items()}
        per_tenant = {}
        for n, t in tenants.items():
            s = t.stats()
            s["share"] = shares[n]
            per_tenant[n] = s
        with self._lock:
            lanes = {str(k): lane.stats() for k, lane in self._lanes.items()}
        return {
            "tenants": per_tenant,
            "jain_tenant": C.jains_index(shares),
            "jain_weighted": C.weighted_jains_index(shares, weights),
            "total_bytes": sum(t.bytes_done for t in tenants.values()),
            "batches": self.batches_issued,
            "entries_coalesced": self.entries_coalesced,
            "lane_faults": self.lane_faults,
            "lanes_enabled": self.lanes_enabled,
            "lanes": lanes,
        }
