"""Continuous-batching serving engine on the MMU's paged KV cache.

Twin of ``repro.serve.engine.ServingEngine``: requests are admitted under
the MMU's page budget, prefilled in one padded forward per admission wave
(prefix-shared pages skipped, long suffixes chunked over later steps),
decoded together one token per step, and replaced from the queue as they
finish.  The greedy token streams equal the reference engine's on the
same weights.

Hot-path invariants, as in the reference:

  * **Device-resident state.**  KV pools, block tables (a cached
    :class:`~repro_torch.core.services.mmu.DeviceBlockTable`), row
    lengths, last tokens and per-row sampling parameters live on the
    engine's device; they change only on slot transitions.
  * **One (B,) vector per step.**  Sampling runs on the device; the only
    device -> host copy of a decode step is the (B,) int32 token vector.
    The engine passes ``filters_on`` from its host mirror of the slots'
    top-k/top-p so the sampler never reads a flag back.
  * **Counter-based sampling keys** ``(seed, rid, token index)``: a
    request's sampled stream is independent of admission order, batching
    and chunked prefill.
  * **Kernel on the card.**  Each decode step launches the CUDA
    paged-attention kernel once per layer
    (``repro_torch.kernels.paged_attention.paged_attention.LAUNCHES``).
  * **Non-blocking billing.**  Bound to a shell (``shell``, ``slot``,
    ``tenant``), the engine submits each decode step's host I/O — one
    int32 token per live row — through the slot's unified Port into the
    shell scheduler; the futures settle at step boundaries
    (``_settle_io``) and ``flush_io()`` drains the tail.  Each step beats
    the shell's health monitor for the slot, and a quarantined tenant is
    refused at ``submit``.

Not in this port yet: tensor-parallel meshes (the constructor raises for
``mesh`` and ``collectives``), migration (``snapshot_state``/
``restore_state``/``evacuate``), and the gateway's hooks and step-time
estimates (``admission_hook``, ``token_sink``, the EWMAs), which come with
the gateway.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import FaultKind
from repro_torch.core.port import Invocation, PortError
from repro_torch.core.services.mmu import MMU
from repro_torch.device import resolve_device
from repro_torch.serve.paged_model import (decode_step_paged,
                                           flat_page_indices,
                                           gather_kv_pages, make_pools,
                                           prefill_chunk_paged,
                                           prefill_shared_paged,
                                           scatter_kv_pages)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = disabled
    top_p: float = 1.0                # >= 1 = disabled
    tid: int = 0                      # submitting cThread
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    done: bool = False
    # chunked-prefill cursor: -1 = not chunking; >= 0 = prompt tokens
    # whose KV is already in the pools (the row holds a slot + pages but
    # is NOT bound into the decode batch until its final chunk lands)
    prefill_pos: int = -1


def _bucket(n: int, cap: int) -> int:
    """Round up to a power of two (capped), as the reference buckets its
    padded prefill shapes."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, mmu: MMU, *,
                 max_batch: int = 8, max_len: int = 1024, seed: int = 0,
                 shell=None, slot: int = 0, tenant: Optional[str] = None,
                 rid_base: int = 0,
                 prefill_chunk: Optional[int] = None, admit_window: int = 8,
                 mesh=None, collectives=None, device=None):
        if cfg.ssm is not None or len(cfg.block_pattern) != 1:
            raise ValueError("the paged engine serves attention archs")
        if mesh is not None or collectives is not None:
            raise NotImplementedError(
                "tensor-parallel serving waits for the TP slice of the port")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.mmu = mmu
        self.page = mmu.config.page_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.max_pages = -(-max_len // self.page)
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.admit_window = admit_window
        # wall time of every decode step (the token read-back included)
        # and total seconds spent in prefill forwards, for measurement
        self.decode_step_times: List[float] = []
        self.prefill_s = 0.0
        # KV pools in the model's dtype (float32 params -> float32 pools,
        # as the reference engine keeps them)
        self.pools = make_pools(cfg, mmu.config.n_pages, self.page,
                                dtype=table.dtype, device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._rid_next = rid_base + 1
        self.completed: List[Request] = []
        self.steps = 0
        self.tokens_out = 0
        self.prefill_computed = 0
        self.prefill_skipped = 0
        self.block_table = mmu.block_table_device(
            max_batch, self.max_pages, device=self.device)
        z32 = dict(dtype=torch.int32, device=self.device)
        self.dev_lens = torch.zeros(max_batch, **z32)
        self.dev_tokens = torch.zeros(max_batch, **z32)
        self.dev_temps = torch.zeros(max_batch, device=self.device)
        self.dev_topk = torch.zeros(max_batch, **z32)
        self.dev_topp = torch.ones(max_batch, device=self.device)
        self.dev_rids = torch.zeros(max_batch, **z32)
        # host mirror of the per-slot filters: decides filters_on
        self._topk = np.zeros(max_batch, np.int32)
        self._topp = np.ones(max_batch, np.float32)
        # Optional shell binding: decode-step I/O is then submitted through
        # the slot's unified Port into the shell scheduler (weighted
        # credits + arbiter) instead of bypassing the shared link
        self.shell = shell
        self.slot = slot
        self.tenant = tenant
        self.io_bytes = 0
        self.io_failures = 0          # billed-IO futures that failed typed
        self._io_futs: List = []
        self.port = (shell.attach(slot, tenant=tenant)
                     if shell is not None else None)
        if shell is not None:
            shell.engines[slot] = self
        mmu.register_pager(self._pager_gather, self._pager_scatter,
                           owner=self)

    def _tensor(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr)).to(self.device, dtype)

    # ------------------------------------------------- evict-with-copy -----
    def _pager_gather(self, ppage: int) -> Dict[str, torch.Tensor]:
        """Copy one physical page's KV (all layers) to the host — called
        by the MMU just before it recycles the device page."""
        flat = flat_page_indices([ppage], self.cfg.n_layers,
                                 self.mmu.config.n_pages)
        kv = gather_kv_pages(self.pools, flat)
        return {"k": kv["k"].cpu(), "v": kv["v"].cpu()}

    def _pager_scatter(self, ppage: int, data) -> None:
        """Write a preserved page payload into a freshly mapped device
        page (MMU fault-back-in path)."""
        flat = flat_page_indices([ppage], self.cfg.n_layers,
                                 self.mmu.config.n_pages)
        scatter_kv_pages(self.pools, flat, data)

    # -------------------------------------------------------------- API ----
    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, tid: int = 0) -> int:
        if prompt and (min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size):
            # an out-of-range id would raise on the CPU and fault the card
            # inside the embedding gather; fail at the door instead
            raise ValueError(
                f"prompt token out of range for vocab_size="
                f"{self.cfg.vocab_size}")
        health = getattr(self.shell, "health", None)
        if health is not None and health.is_quarantined(self.tenant):
            # graceful degradation: a repeatedly-faulting tenant is
            # rejected fast with a typed error, bystanders keep flowing
            health.record_rejection(self.tenant)
            raise PortError(
                f"tenant {self.tenant!r} is quarantined (repeated faults "
                "within the quarantine window); "
                "shell.health.unquarantine() to lift",
                kind=FaultKind.QUARANTINED, slot=self.slot,
                tenant=self.tenant, retryable=False)
        rid = self._rid_next
        self._rid_next += 1
        self.queue.append(Request(
            rid=rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, tid=tid,
            t_submit=time.perf_counter()))
        return rid

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def pending(self) -> bool:
        return self.active > 0 or bool(self.queue)

    # -------------------------------------------------------- admission ----
    def _sync(self) -> None:
        """Wait for the device, so a host clock measures the work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self) -> None:
        """Admit queued requests into free slots under the page budget,
        scanning up to ``admit_window`` entries past a blocked head while
        keeping per-tenant (``tid``) FIFO order."""
        if not self.queue:
            return
        free = [i for i in range(self.max_batch) if self.slots[i] is None]
        if not free:
            return
        oneshot, taken, blocked = [], set(), set()
        qlist = list(self.queue)
        for qi, req in enumerate(qlist):
            if not free:
                break
            if blocked and qi >= self.admit_window:
                break                  # bounded skip-ahead exhausted
            if req.tid in blocked:
                continue               # preserve per-tenant FIFO
            plen = len(req.prompt)
            need = -(-(plen + req.max_new_tokens) // self.page)
            # prefix-shared pages cost no new capacity
            probe = self.mmu.probe_prefix(req.prompt)
            need -= probe // self.page
            if need > self.mmu.config.n_pages - (
                    self.mmu.utilization()["pages_used"]):
                blocked.add(req.tid)
                continue
            i = free.pop(0)
            # a row that will chunk-prefill publishes its prompt pages
            # only when its final chunk lands (_prefill_chunks)
            will_chunk = (self.prefill_chunk is not None
                          and plen - probe > self.prefill_chunk)
            covered = self.mmu.alloc_seq(req.rid, plen, slot=i,
                                         prompt_tokens=req.prompt,
                                         publish=not will_chunk)
            self.slots[i] = req
            taken.add(qi)
            if will_chunk:
                req.prefill_pos = covered
                self.prefill_skipped += covered
            else:
                self.block_table.bind(i, req.rid)
                qstart = covered if covered < plen else plen - 1
                self.prefill_computed += plen - qstart
                self.prefill_skipped += qstart
                oneshot.append((i, req, qstart, covered))
        if taken:
            self.queue = deque(r for qi, r in enumerate(qlist)
                               if qi not in taken)
        if oneshot:
            self._prefill_batch(oneshot)

    def _prefill_chunks(self) -> None:
        """Advance every chunk-prefilling row by ONE chunk; rows whose
        remainder fits one chunk take the :meth:`_prefill_batch` path,
        which samples their first token and binds them for decode."""
        rows = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.prefill_pos >= 0]
        if not rows:
            return
        inter, finals = [], []
        for i, req in rows:
            if len(req.prompt) - req.prefill_pos <= self.prefill_chunk:
                finals.append((i, req))
            else:
                inter.append((i, req))
        if inter:
            t0 = time.perf_counter()
            n = len(inter)
            nb = _bucket(n, self.max_batch)
            chunk = self.prefill_chunk
            smax = max(len(r.prompt) for _, r in inter)
            maxp = max(self.max_pages,
                       -(-_bucket(smax, 1 << 30) // self.page))
            tables = np.full((nb, maxp), -1, np.int32)
            tables[:n] = self.mmu.block_table(
                [req.rid for _, req in inter], maxp)
            q_starts = np.zeros((nb,), np.int32)
            q_lens = np.zeros((nb,), np.int32)
            tokens = np.zeros((nb, chunk), np.int32)
            for j, (_, req) in enumerate(inter):
                q_starts[j] = req.prefill_pos
                q_lens[j] = chunk
                tokens[j] = req.prompt[req.prefill_pos:
                                       req.prefill_pos + chunk]
            i32 = torch.int32
            prefill_chunk_paged(
                self.params, self.pools, self._tensor(tokens, i32),
                self._tensor(q_lens, i32), self._tensor(q_starts, i32),
                self._tensor(tables, i32), cfg=self.cfg,
                page_size=self.page)
            self._sync()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_computed += n * chunk
            for _, req in inter:
                self.mmu.mark_dirty_range(req.rid, req.prefill_pos,
                                          req.prefill_pos + chunk)
                req.prefill_pos += chunk
        if finals:
            batch = []
            for i, req in finals:
                self.block_table.bind(i, req.rid)
                plen = len(req.prompt)
                qstart = req.prefill_pos
                self.prefill_computed += plen - qstart
                batch.append((i, req, qstart, qstart))
                req.prefill_pos = -1
            self._prefill_batch(batch)
            # every prompt position's KV is resident: publish the prefix
            for _, req in finals:
                self.mmu.publish_prefix(req.rid, req.prompt)

    def _prefill_batch(self, rows) -> None:
        """One padded forward for a batch of prefill-finishing rows
        ``(slot, request, qstart, write_from)``: queries for
        ``prompt[qstart:]``, KV written only at positions >= write_from.
        One function for shared, unshared and chunked rows keeps their
        token streams identical."""
        t0 = time.perf_counter()
        n = len(rows)
        nb = _bucket(n, self.max_batch)
        smax = max(len(r.prompt) for _, r, _, _ in rows)
        maxp = max(self.max_pages, -(-_bucket(smax, 1 << 30) // self.page))
        temps = np.zeros((nb,), np.float32)
        topks = np.zeros((nb,), np.int32)
        topps = np.ones((nb,), np.float32)
        tables = np.full((nb, maxp), -1, np.int32)
        tables[:n] = self.mmu.block_table(
            [req.rid for _, req, _, _ in rows], maxp)
        q_starts = np.zeros((nb,), np.int32)
        q_lens = np.zeros((nb,), np.int32)
        write_from = np.zeros((nb,), np.int32)
        seq_ids = np.zeros((nb,), np.int32)
        for j, (_, req, qstart, wfrom) in enumerate(rows):
            temps[j] = req.temperature
            topks[j] = req.top_k
            topps[j] = req.top_p
            q_starts[j] = qstart
            q_lens[j] = len(req.prompt) - qstart
            write_from[j] = wfrom
            seq_ids[j] = req.rid
        sb = _bucket(int(q_lens.max()), 1 << 30)
        tokens = np.zeros((nb, sb), np.int32)
        for j, (_, req, qstart, _) in enumerate(rows):
            tokens[j, :q_lens[j]] = req.prompt[qstart:]
        i32, f32 = torch.int32, torch.float32
        first = prefill_shared_paged(
            self.params, self.pools, self._tensor(tokens, i32),
            self._tensor(q_lens, i32), self._tensor(q_starts, i32),
            self._tensor(write_from, i32), self._tensor(tables, i32),
            self.seed, self._tensor(temps, f32), self._tensor(topks, i32),
            self._tensor(topps, f32), self._tensor(seq_ids, i32),
            cfg=self.cfg, page_size=self.page,
            filters_on=bool((topks > 0).any() or (topps < 1.0).any()))
        first = first.cpu().numpy()
        now = time.perf_counter()
        self.prefill_s += now - t0
        for _, req, _, wfrom in rows:
            self.mmu.mark_dirty_range(req.rid, wfrom, len(req.prompt))
        slots_i, srows = [], []
        for j, (i, req, _, _) in enumerate(rows):
            tok = int(first[j])
            req.out_tokens.append(tok)
            req.t_first_token = now
            self.mmu.extend_seq(req.rid, 1, slot=i)
            self.tokens_out += 1
            if len(req.prompt) + 1 >= self.max_len:
                # no decode budget left: complete straight from prefill
                req.done = True
                req.t_done = now
                self.mmu.free_seq(req.rid)
                self.block_table.unbind(i)
                self.completed.append(req)
                self.slots[i] = None
                continue
            slots_i.append(i)
            # write position of the NEXT decode step's token
            srows.append((len(req.prompt), tok, req.temperature,
                          req.top_k, req.top_p, req.rid))
        if slots_i:
            self._sync_slot_state(slots_i, srows)

    def _sync_slot_state(self, slots_i, rows) -> None:
        """Push slot-transition deltas into the device-resident state
        (admissions and frees only — never on the per-step path).
        ``rows`` is a list of (len, token, temperature, top_k, top_p,
        rid)."""
        idx = torch.tensor(slots_i, dtype=torch.long, device=self.device)
        lens, toks, temps, topks, topps, rids = zip(*rows)
        for dst, vals, dtype in (
                (self.dev_rids, rids, torch.int32),
                (self.dev_lens, lens, torch.int32),
                (self.dev_tokens, toks, torch.int32),
                (self.dev_temps, temps, torch.float32),
                (self.dev_topk, topks, torch.int32),
                (self.dev_topp, topps, torch.float32)):
            dst.index_copy_(0, idx, torch.tensor(vals, dtype=dtype,
                                                 device=self.device))
        self._topk[slots_i] = topks
        self._topp[slots_i] = topps

    # ------------------------------------------------------------ decode ----
    def step(self) -> int:
        """One continuous-batching engine step; returns tokens emitted."""
        if self.shell is not None:
            health = getattr(self.shell, "health", None)
            if health is not None:
                health.beat(self.slot)      # watchdog: slot is decoding
        self._settle_io()
        self._admit()
        self._prefill_chunks()
        # decode runs over BOUND rows only: chunk-prefilling rows hold a
        # slot + pages but emit nothing until their final chunk lands
        live = [i for i, r in enumerate(self.slots)
                if r is not None and r.prefill_pos < 0]
        if not live:
            return 0
        t0 = time.perf_counter()
        tables = self.block_table.device_view()
        # rows whose mapping changed (page crossing, eviction, fault-back)
        # re-sync lens/tokens from host truth
        upd = [i for i in self.block_table.last_updated_rows
               if self.slots[i] is not None
               and self.slots[i].prefill_pos < 0]
        if upd:
            self._sync_slot_state(
                upd,
                [(len(self.slots[i].prompt)
                  + len(self.slots[i].out_tokens) - 1,
                  self.slots[i].out_tokens[-1],
                  self.slots[i].temperature,
                  self.slots[i].top_k,
                  self.slots[i].top_p,
                  self.slots[i].rid) for i in upd])
        next_toks, self.dev_lens = decode_step_paged(
            self.params, self.pools, tables, self.dev_lens,
            self.dev_tokens, self.seed, self.dev_temps, self.dev_topk,
            self.dev_topp, self.dev_rids, cfg=self.cfg, page_size=self.page,
            filters_on=bool((self._topk > 0).any()
                            or (self._topp < 1.0).any()))
        self.dev_tokens = next_toks
        # the ONLY per-step device->host copy: the (B,) int32 token vector
        toks = next_toks.cpu().numpy()
        self.decode_step_times.append(time.perf_counter() - t0)
        self.steps += 1
        self._submit_step_io(n_live=len(live))

        emitted = 0
        freed = []
        for i in live:
            req = self.slots[i]
            tok = int(toks[i])
            req.out_tokens.append(tok)
            emitted += 1
            self.mmu.extend_seq(req.rid, 1, slot=i)
            total = len(req.prompt) + len(req.out_tokens)
            if (len(req.out_tokens) >= req.max_new_tokens
                    or total >= self.max_len):
                req.done = True
                req.t_done = time.perf_counter()
                self.mmu.free_seq(req.rid)
                self.block_table.unbind(i)
                self.completed.append(req)
                self.slots[i] = None
                freed.append(i)
        if freed:
            self._sync_slot_state(freed, [(0, 0, 0.0, 0, 1.0, 0)] * len(freed))
        self.tokens_out += emitted
        return emitted

    # ---------------------------------------------------------- billing ----
    def _submit_step_io(self, n_live: int) -> None:
        """Bill this decode step's host I/O — one int32 token per live
        row is all that crosses the link — to our tenant through the
        slot's unified Port (``port.submit`` -> shell scheduler).
        Submission is async: the future is collected and settled at the
        next step boundary.  Only the scheduler's submitter back-pressure
        (tenant pending bound) can block here, which is the intended
        self-containment of an over-subscribed tenant."""
        if self.port is None or n_live == 0:
            return
        nbytes = n_live * 4
        self.io_bytes += nbytes
        fut = self.port.submit(Invocation.io(
            nbytes, tag="decode_io", tenant=self.tenant))
        self._io_futs.append(fut)

    def _settle_io(self) -> None:
        """Drop completed I/O futures (non-blocking settle)."""
        if self._io_futs:
            self._io_futs = [f for f in self._io_futs if not f.done()]

    def flush_io(self, timeout: float = 30.0, *,
                 strict: bool = False) -> bool:
        """Wait (bounded by one shared deadline) for outstanding billed
        I/O to clear the link.

        A future that FAILED with a typed ``PortError`` is settled — the
        error was already delivered and health-recorded by the port
        layer — and counted in ``io_failures``.  Futures that neither
        complete nor fail stay queued so accounting is never silently
        dropped.  Returns True when fully drained; a timeout is recorded
        as an ``io_flush_timeout`` health event when shell-bound, and
        ``strict=True`` raises it as a typed ``PortError`` instead of
        returning False."""
        deadline = time.perf_counter() + timeout
        remaining = []
        for fut in self._io_futs:
            left = deadline - time.perf_counter()
            try:
                comp = fut.completion(timeout=max(left, 0.0))
            except BaseException:  # noqa: BLE001 — typed failure: the
                self.io_failures += 1  # IO never cleared but is settled
                continue
            if comp is None and not fut.done():
                remaining.append(fut)
        self._io_futs = [f for f in remaining if not f.done()]
        if not self._io_futs:
            return True
        health = getattr(self.shell, "health", None)
        msg = (f"{len(self._io_futs)} decode-IO future(s) still pending "
               f"after {timeout}s on slot {self.slot}")
        if health is not None:
            health.record_fault(FaultKind.IO_FLUSH_TIMEOUT,
                                slot=self.slot, tenant=self.tenant,
                                site="engine.flush_io", strike=False,
                                msg=msg)
        if strict:
            raise PortError(msg, kind=FaultKind.IO_FLUSH_TIMEOUT,
                            slot=self.slot, tenant=self.tenant,
                            retryable=True)
        return False

    def latency_stats(self) -> Dict[str, float]:
        """TTFT/TPOT percentiles over completed requests (milliseconds)."""
        ttfts, tpots = [], []
        for r in self.completed:
            if r.t_first_token > 0 and r.t_submit > 0:
                ttfts.append(r.t_first_token - r.t_submit)
            n_dec = len(r.out_tokens) - 1
            if r.t_done > 0 and r.t_first_token > 0 and n_dec > 0:
                tpots.append((r.t_done - r.t_first_token) / n_dec)
        out: Dict[str, float] = {}
        if ttfts:
            out["ttft_p50_ms"] = float(np.percentile(ttfts, 50) * 1e3)
            out["ttft_p99_ms"] = float(np.percentile(ttfts, 99) * 1e3)
        if tpots:
            out["tpot_p50_ms"] = float(np.percentile(tpots, 50) * 1e3)
            out["tpot_p99_ms"] = float(np.percentile(tpots, 99) * 1e3)
        return out

    def run(self, max_steps: int = 10_000) -> Dict[str, float]:
        t0 = time.perf_counter()
        while self.pending() and self.steps < max_steps:
            self.step()
        dt = time.perf_counter() - t0
        stats = {"wall_s": dt, "engine_steps": self.steps,
                 "tokens": self.tokens_out,
                 "tokens_per_s": self.tokens_out / max(dt, 1e-9),
                 "completed": len(self.completed),
                 "prefill_computed": self.prefill_computed,
                 "prefill_skipped": self.prefill_skipped}
        stats.update(self.latency_stats())
        return stats
