"""Serving gateway: the always-on front door of the paged engine.

The missing piece between "benchmark harness" and "serving system":
production traffic is an *open arrival* process — requests show up on
their own clock, carrying their own SLOs — while the engine underneath
admits in slot-granular steps.  The gateway bridges the two:

  * **Continuous batching.**  A completed engine row is backfilled from
    the gateway queue at the very next step (the engine's
    ``admission_hook`` runs before every ``_admit``), instead of waiting
    for the whole wave to drain.  ``mode="wave"`` keeps the old
    admit-everything-when-idle behaviour — it exists so the benchmark
    can measure exactly what continuous batching buys.
  * **Token streams out.**  ``submit()`` returns a :class:`TokenStream`
    that fills live as the engine emits tokens (the engine's
    ``token_sink`` hook), with per-request TTFT/TPOT measured from
    *arrival* — gateway queueing time is part of the user's latency,
    unlike the engine-side view which starts at engine admission.
  * **SLO-aware admission.**  With ``admission="slo"`` each request's
    relative ``deadline_s`` is checked at the door against the engine's
    measured prefill/decode step-time EWMAs: a deadline that cannot be
    met even if the request ran alone is rejected immediately with a
    typed ``PortError(kind=SLO_INFEASIBLE)`` — failing fast beats
    burning page-credits on a guaranteed miss.  Queued requests whose
    deadline passes are expired (``SLO_EXPIRED``) before they waste a
    prefill.  Queued priorities *age* as slack shrinks, and dispatch
    order is (effective priority, deadline slack, arrival) — a gold
    request with a tight deadline leapfrogs best-effort traffic without
    starving it (aging is bounded).
  * **Port-billed admission.**  When the engine is shell-bound, every
    accepted request is billed through ``port.submit`` as a
    ``gateway_admit`` IO invocation — quarantine, fault injection, DWRR
    credits and QoS accounting all apply to the front door exactly as
    they do to decode-step IO.

Everything is driven synchronously from ``step()``/``drain()`` — the
gateway adds no threads; an async transport would sit on top of it and
call the same entry points.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.faults import FaultKind
from repro_torch.core.port import Invocation, PortError


@dataclass
class TokenStream:
    """Per-request output handle: fills live while the gateway pumps."""
    gid: int                              # gateway sequence number
    prompt_len: int
    max_new_tokens: int
    priority: int = 0
    deadline: float = math.inf            # absolute perf_counter time
    tid: int = 0
    rid: Optional[int] = None             # engine rid once dispatched
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[PortError] = None
    t_arrival: float = 0.0
    t_first: float = 0.0                  # first token (from arrival)
    t_done: float = 0.0
    eff_priority: int = 0                 # last aged priority (observable)

    @property
    def rejected(self) -> bool:
        return self.error is not None

    @property
    def met_deadline(self) -> bool:
        return (self.done and self.error is None
                and self.t_done <= self.deadline)

    def ttft(self) -> Optional[float]:
        return (self.t_first - self.t_arrival) if self.t_first > 0 else None

    def tpot(self) -> Optional[float]:
        n = len(self.tokens) - 1
        if self.t_done > 0 and self.t_first > 0 and n > 0:
            return (self.t_done - self.t_first) / n
        return None


@dataclass
class _Pending:
    """A queued arrival the gateway has accepted but not yet dispatched."""
    stream: TokenStream
    prompt: List[int]
    temperature: float
    top_k: int
    top_p: float


class ServingGateway:
    """Open-arrival frontend over one :class:`ServingEngine`.

    mode       -- "continuous" (backfill every step) | "wave" (admit
                  only when the engine is fully idle; the A/B baseline).
    admission  -- "slo" (feasibility checks, expiry, aging, slack
                  ordering) | "fifo" (arrival order, no rejection).
    max_queue  -- backpressure bound; arrivals beyond it are rejected
                  with retryable ``GATEWAY_FULL`` (0 = unbounded).
    headroom   -- feasibility margin: reject when
                  ``arrival + headroom * service_estimate > deadline``.
    min_obs    -- EWMA warm-up: no feasibility rejection until the
                  engine has at least this many prefill AND decode
                  timing observations (cold estimates reject wrongly).
    aging_max  -- bound on the deadline-driven priority boost.
    aging_window_s -- slack below which aging kicks in (boost scales
                  linearly from 0 at the window edge to aging_max at
                  zero slack).
    """

    def __init__(self, engine, *, mode: str = "continuous",
                 admission: str = "slo", max_queue: int = 0,
                 headroom: float = 1.5, min_obs: int = 3,
                 aging_max: int = 4, aging_window_s: float = 1.0):
        assert mode in ("continuous", "wave"), mode
        assert admission in ("slo", "fifo"), admission
        self.engine = engine
        self.mode = mode
        self.admission = admission
        self.max_queue = max_queue
        self.headroom = headroom
        self.min_obs = min_obs
        self.aging_max = aging_max
        self.aging_window_s = aging_window_s
        self.queue: List[_Pending] = []
        self.streams: Dict[int, TokenStream] = {}     # engine rid -> stream
        self.completed: List[TokenStream] = []
        self.rejected: List[TokenStream] = []
        self._gid_next = 0
        self._admit_futs: List = []
        # counters (stats())
        self.submitted = 0
        self.dispatched = 0
        self.rejected_infeasible = 0
        self.rejected_full = 0
        self.expired = 0
        self.t_open = time.perf_counter()
        engine.admission_hook = self._backfill
        engine.token_sink = self._on_token

    # ------------------------------------------------------------ intake ---
    def _service_estimate(self, prompt_len: int,
                          max_new_tokens: int) -> Optional[float]:
        """Best-case seconds to serve the request alone, from measured
        EWMAs; None while the engine's timing model is cold."""
        eng = self.engine
        if (eng.ewma_prefill_s_per_tok is None
                or eng.ewma_decode_step_s is None
                or eng.prefill_obs < self.min_obs
                or eng.decode_obs < self.min_obs):
            return None
        return (eng.ewma_prefill_s_per_tok * prompt_len
                + eng.ewma_decode_step_s * max_new_tokens)

    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               tid: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None) -> TokenStream:
        """Accept (or reject, typed) one arriving request.

        Raises ``PortError`` with kind ``GATEWAY_FULL`` (retryable — the
        queue bound is load, not damage), ``SLO_INFEASIBLE`` (the
        deadline cannot be met even unqueued), or ``QUARANTINED``
        (propagated from the billing port for a quarantined tenant).
        """
        now = time.perf_counter()
        self.submitted += 1
        gid = self._gid_next
        self._gid_next += 1
        stream = TokenStream(
            gid=gid, prompt_len=len(prompt), max_new_tokens=max_new_tokens,
            priority=priority, eff_priority=priority, tid=tid,
            deadline=(now + deadline_s if deadline_s is not None
                      else math.inf),
            t_arrival=now)
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.rejected_full += 1
            stream.error = PortError(
                f"gateway queue full ({self.max_queue}); retry later",
                kind=FaultKind.GATEWAY_FULL, slot=self.engine.slot,
                tenant=self.engine.tenant, retryable=True)
            self.rejected.append(stream)
            raise stream.error
        if self.admission == "slo" and deadline_s is not None:
            est = self._service_estimate(len(prompt), max_new_tokens)
            if est is not None and now + self.headroom * est > stream.deadline:
                self.rejected_infeasible += 1
                stream.error = PortError(
                    f"deadline {deadline_s:.3f}s infeasible: best-case "
                    f"service estimate {est:.3f}s (x{self.headroom} "
                    "headroom) — rejected at admission",
                    kind=FaultKind.SLO_INFEASIBLE, slot=self.engine.slot,
                    tenant=self.engine.tenant, retryable=False)
                self.rejected.append(stream)
                raise stream.error
        # bill the accepted admission through the unified port: the
        # shell's quarantine / fault-injection / DWRR paths all see the
        # front door.  A quarantined tenant is rejected right here.
        if self.engine.port is not None:
            fut = self.engine.port.submit(Invocation.io(
                max(len(prompt), 1) * 4, tag="gateway_admit",
                tenant=self.engine.tenant, priority=priority,
                deadline_s=deadline_s))
            self._admit_futs.append(fut)
        self.queue.append(_Pending(stream=stream, prompt=list(prompt),
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p))
        return stream

    # -------------------------------------------------------- scheduling ---
    def _aged_priority(self, stream: TokenStream, now: float,
                       est: Optional[float]) -> int:
        """Deadline-driven aging: boost grows linearly as slack (time to
        deadline minus estimated service time) shrinks inside the aging
        window, bounded by ``aging_max``.  No deadline -> no aging."""
        if math.isinf(stream.deadline) or self.aging_max <= 0:
            return stream.priority
        slack = stream.deadline - now - (est or 0.0)
        if slack >= self.aging_window_s:
            return stream.priority
        frac = 1.0 - max(slack, 0.0) / self.aging_window_s
        return stream.priority + min(self.aging_max,
                                     int(math.ceil(frac * self.aging_max)))

    def _slack(self, stream: TokenStream, now: float,
               est: Optional[float]) -> float:
        if math.isinf(stream.deadline):
            return math.inf
        return stream.deadline - now - (est or 0.0)

    def _backfill(self, engine) -> None:
        """Engine admission hook — runs before ``_admit`` every step.

        Expires dead entries, ages priorities, orders the queue by
        (effective priority desc, deadline slack asc, arrival asc), and
        feeds the engine exactly as many requests as it can place this
        step (continuous) or a full wave when idle (wave)."""
        if not self.queue:
            return
        now = time.perf_counter()
        if self.admission == "slo":
            alive: List[_Pending] = []
            for p in self.queue:
                if now > p.stream.deadline:
                    self.expired += 1
                    p.stream.error = PortError(
                        "deadline expired while queued",
                        kind=FaultKind.SLO_EXPIRED, slot=engine.slot,
                        tenant=engine.tenant, retryable=False)
                    self.rejected.append(p.stream)
                else:
                    alive.append(p)
            self.queue = alive
            if not self.queue:
                return
            keyed = []
            for p in self.queue:
                est = self._service_estimate(p.stream.prompt_len,
                                             p.stream.max_new_tokens)
                p.stream.eff_priority = self._aged_priority(
                    p.stream, now, est)
                keyed.append((-p.stream.eff_priority,
                              self._slack(p.stream, now, est),
                              p.stream.gid, p))
            keyed.sort(key=lambda t: t[:3])
            self.queue = [t[3] for t in keyed]
        if self.mode == "wave":
            # wave baseline: a new wave only once the engine fully drains
            if engine.active > 0 or engine.queue:
                return
            n = min(engine.max_batch, len(self.queue))
        else:
            free = engine.max_batch - engine.active
            n = max(0, min(free - len(engine.queue), len(self.queue)))
        for p in self.queue[:n]:
            rid = engine.submit(
                p.prompt, p.stream.max_new_tokens,
                temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
                tid=p.stream.tid, priority=p.stream.eff_priority,
                deadline_s=(None if math.isinf(p.stream.deadline)
                            else p.stream.deadline))
            p.stream.rid = rid
            self.streams[rid] = p.stream
            self.dispatched += 1
        del self.queue[:n]

    def _on_token(self, req, token: int, done: bool) -> None:
        """Engine token sink: route every emitted token to its stream."""
        stream = self.streams.get(req.rid)
        if stream is None:
            return
        stream.tokens.append(token)
        now = time.perf_counter()
        if stream.t_first == 0.0:
            stream.t_first = now
        if done and not stream.done:
            stream.done = True
            stream.t_done = now
            self.completed.append(stream)
            del self.streams[req.rid]

    def adopt_streams(self, src: "ServingGateway") -> Dict[str, int]:
        """Take over another gateway's live ``TokenStream``s after its
        tenant migrated to OUR engine.

        Request ids survive ``restore_state`` (in-flight and demoted
        chunk-prefill requests keep their rids), so moving the rid ->
        stream map is all the re-route needs: the next token our engine
        emits for a moved rid lands in the SAME ``TokenStream`` object
        the caller has been reading — no token lost, none duplicated.
        Gateway-queued (not yet dispatched) pendings move too and will
        dispatch here with fresh rids.  Already-completed streams stay
        with the source gateway's history."""
        n_streams, n_queued = len(src.streams), len(src.queue)
        self.streams.update(src.streams)
        src.streams.clear()
        self.queue.extend(src.queue)
        src.queue.clear()
        self.submitted += n_streams + n_queued
        return {"streams": n_streams, "queued": n_queued}

    # ------------------------------------------------------------- drive ---
    def step(self) -> int:
        """One engine step (backfill runs inside via the hook)."""
        return self.engine.step()

    def pending(self) -> bool:
        return bool(self.queue) or self.engine.pending()

    def drain(self, max_steps: int = 100_000) -> None:
        """Pump until every accepted request has completed or expired."""
        steps = 0
        while self.pending() and steps < max_steps:
            self.step()
            steps += 1
        self._settle_admit_io()

    def _settle_admit_io(self) -> None:
        if self._admit_futs:
            self._admit_futs = [f for f in self._admit_futs
                                if not f.done()]

    # ------------------------------------------------------------- stats ---
    def stats(self) -> Dict[str, float]:
        """Gateway-side QoS view: goodput (deadline-met completions per
        second), TTFT/TPOT percentiles measured from ARRIVAL, and the
        admission-control counters."""
        now = time.perf_counter()
        wall = max(now - self.t_open, 1e-9)
        met = sum(1 for s in self.completed if s.met_deadline)
        out: Dict[str, float] = {
            "submitted": self.submitted,
            "dispatched": self.dispatched,
            "completed": len(self.completed),
            "met_deadline": met,
            "goodput": met / wall,
            "throughput": len(self.completed) / wall,
            "rejected_infeasible": self.rejected_infeasible,
            "rejected_full": self.rejected_full,
            "expired": self.expired,
            "queued": len(self.queue),
            "wall_s": wall,
        }
        ttfts = [s.ttft() for s in self.completed if s.ttft() is not None]
        tpots = [s.tpot() for s in self.completed if s.tpot() is not None]
        if ttfts:
            out["ttft_p50_ms"] = float(np.percentile(ttfts, 50) * 1e3)
            out["ttft_p99_ms"] = float(np.percentile(ttfts, 99) * 1e3)
        if tpots:
            out["tpot_p50_ms"] = float(np.percentile(tpots, 50) * 1e3)
            out["tpot_p99_ms"] = float(np.percentile(tpots, 99) * 1e3)
        return out
